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
NO_FMA = ("-fmad=false",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
# name -> (restype, argtypes); every pointer and the stream are c_void_p
SIGNATURES = {
    "les_fused_ekf_rollout": (_I, [
        _P, _P, _P, _P, _U, _I, _I, _I, _I,  # params, lms, cmds, noise, seed, B, T, N, predicated
        _P, _P, _P, _P, _P, _P,              # err_sum, err_max, true_pose, x, P, seen
        _P,                                  # stream
    ]),
    "les_fused_iekf_rollout": (_I, [  # the same arguments
        _P, _P, _P, _P, _U, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _P,
        _P,
    ]),
    "les_fused_ukf_rollout": (_I, [
        _P, _P, _P, _P, _U, _I, _I, _I,      # params, lms, cmds, noise, seed, B, T, N
        _I, _I,                              # slam, predicated
        _P, _P, _P, _P, _P, _P, _P,          # err_sum, err_max, update_rejects, true_pose, x, P, seen
        _P,                                  # stream
    ]),
    "les_philox_noise": (_I, [_U, _I, _I, _I, _P, _P]),  # seed, T, N, B, out, stream
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


def build(extra: tuple[str, ...] = ()) -> Path:
    """Compile the kernels, with ``extra`` nvcc flags, unless the library
    for these sources and flags exists."""
    path = library_path(extra)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
           *(str(f) for f in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
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
