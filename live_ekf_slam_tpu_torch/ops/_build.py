"""Build ``csrc/*.cu`` with nvcc at first use and load it with ctypes.

One shared library with a plain C interface holds every kernel of the port.
Its name carries a hash of the sources and flags, so a changed source builds
anew; it lands in ``live_ekf_slam_tpu_torch/_build/``, which git ignores.
Compiling for ``sm_90a`` (Hopper) takes seconds; nothing here includes
PyTorch's headers. There is no fallback: without nvcc, ``load`` raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the kernels rely on IEEE sqrtf/division and on
# sinf/cosf at full accuracy (nvcc still contracts a*b+c into FMA)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# contraction off: a build whose kernels round as the plain versions do
# (LES_NO_FMA: the same for the few products kernel_math.cuh pins by hand)
NO_FMA = ("-fmad=false", "-DLES_NO_FMA")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
# name -> (restype, argtypes); every pointer and the stream are c_void_p
SIGNATURES = {
    "les_fused_ekf_rollout": (_I, [
        _P, _P, _P, _P, _U, _I, _I, _I, _I,  # params, lms, cmds, noise, seed, B, T, N, predicated
        _I,                                  # mode: 0 full, 1 no landmark loop, 2 simulator only
        _P, _P, _P, _P, _P, _P,              # err_sum, err_max, true_pose, x, P, seen
        _P, _P,                              # est_traj, true_traj (both null: no pose stream)
        _P,                                  # stream
    ]),
    "les_fused_iekf_rollout": (_I, [  # the same arguments
        _P, _P, _P, _P, _U, _I, _I, _I, _I,
        _I,
        _P, _P, _P, _P, _P, _P,
        _P, _P,
        _P,
    ]),
    "les_fused_ukf_rollout": (_I, [
        _P, _P, _P, _P, _U, _I, _I, _I,      # params, lms, cmds, noise, seed, B, T, N
        _I, _I,                              # slam, predicated
        _P, _P, _P, _P, _P, _P, _P,          # err_sum, err_max, update_rejects, true_pose, x, P, seen
        _P,                                  # stream
    ]),
    "les_philox_noise": (_I, [_U, _I, _I, _I, _I, _P, _P]),  # seed, T, N, B, world0, out, stream
    # d (B,T+1,3,3), u (B,T,3,3), B, T -> sinv, l, u scaled, dsc; stream
    "les_block_thomas_factor": (_I, [_P, _P, _I, _I, _P, _P, _P, _P, _P]),
    # sinv, l, u scaled, dsc, rhs (B,T+1,3), B, T -> x (B,T+1,3); stream
    "les_block_thomas_solve": (_I, [_P, _P, _P, _P, _P, _I, _I, _P, _P]),
    # the standalone primitives (csrc/micro_ops.cu); every matrix (B, D, D)
    # p, k (B,R,D), h (B,R,D) -> p_out; B, D, R, passes; stream
    "les_micro_rank_update": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # p, idx (B,) int32 -> out (B,D); B, D, n, spelling; stream
    "les_micro_column_gather": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    # p -> l; B, D, du, n, variant; stream
    "les_micro_chol": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
    # l, g (B,A,D) -> out (B,D); B, D, A, n, order; stream
    "les_micro_matvec": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # p, k0, k1, cr, cb (B,D), s (B,3) -> p_out; B, D, n, spelling, n_terms; stream
    "les_micro_joseph": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # sp, sm (B,3,D), lm (B,2), wm (B,D) -> out (B,); B, D, n; stream
    "les_micro_zstats": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "les_error_string": (ctypes.c_char_p, [_I]),
}

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}
_extra: tuple[str, ...] = ()  # flags of the build the wrappers launch


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)"
    )


def library_path(extra: tuple[str, ...] = ()) -> Path:
    """Content-hashed path of the library for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libles_kernels_{h.hexdigest()[:16]}.so"


def _fail(cmd, proc, out):
    raise RuntimeError(
        f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}"
    )


def build(extra: tuple[str, ...] = ()) -> Path:
    """Compile the kernels, with ``extra`` nvcc flags, unless the library
    for these sources and flags exists: one nvcc per source, all started
    together, then one link."""
    path = library_path(extra)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    stem = f"{path.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{stem}.{src.stem}.tmp.o"
        cmd = [nvcc, *(f for f in NVCC_FLAGS if f != "-shared"), *extra,
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tmp = BUILD_DIR / f"{stem}.tmp.so"
    try:
        for cmd, _, proc in jobs:  # wait for all, so that none is left running
            out = proc.communicate()[0]
            if proc.returncode != 0:
                for _, _, other in jobs:
                    other.wait()
                _fail(cmd, proc, out)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            _fail(cmd, proc, proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        for f in (tmp, *(obj for _, obj, _ in jobs)):
            f.unlink(missing_ok=True)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every signature set."""
    if _extra not in _libs:
        lib = ctypes.CDLL(str(build(_extra)))
        for name, (res, args) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _libs[_extra] = lib
    return _libs[_extra]


@contextlib.contextmanager
def without_fma():
    """Within, the wrappers launch the build with FMA contraction off, whose
    kernels give the plain versions' bits (a check; the default build is
    the one the port runs)."""
    global _extra
    saved, _extra = _extra, NO_FMA
    try:
        yield
    finally:
        _extra = saved


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a nonzero CUDA error code."""
    if rc != 0:
        msg = load().les_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
