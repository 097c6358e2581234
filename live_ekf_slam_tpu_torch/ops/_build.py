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
import threading
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
# a measurement build: the rollout kernels count clock64() cycles by phase of
# their tick (fused_ukf_rollout.cu, fused_ekf_rollout.cu); the default build
# compiles that out
PHASE_CLOCKS = ("-DLES_PHASE_CLOCKS",)

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
    # d, u, ab, bb, cb, ar, br, hll_inv (B,N,3), slot (B,K) or (B,T*K) int32,
    # by_column, vp (B,T+1,3), B, T, K, N -> sp (B,T+1,3); stream
    "les_schur_mv": (_I, [_P] * 9 + [_I, _P, _I, _I, _I, _I, _P, _P]),
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
    # x, sc (n, 2), n, stream
    "les_micro_zstats_sincos": (_I, [_P, _P, _I, _P]),
    # family (0 rank_update, 1 joseph), R or spelling, n_terms, D -> out[6],
    # as les_ukf_occupancy's
    "les_micro_occupancy": (_I, [_I, _I, _I, _I, _P]),
    "les_error_string": (ctypes.c_char_p, [_I]),
    # a kernel's host function, threads and dynamic shared bytes a block ->
    # out[4]: registers, local bytes, static shared bytes, blocks an SM
    "les_kernel_occupancy": (_I, [_P, _I, _I, _P]),
    # slam, N -> out[6]: the four above, worlds a block, shared bytes a block
    "les_ukf_occupancy": (_I, [_I, _I, _P]),
    # invariant, emit_traj, mode, N -> out[6], as les_ukf_occupancy's
    "les_ekf_occupancy": (_I, [_I, _I, _I, _I, _P]),
    # T -> out[6]: the block-Thomas solve's launch at T steps
    "les_block_thomas_occupancy": (_I, [_I, _P]),
    # K, N -> out[6]: the Schur matvec's launch
    "les_schur_mv_occupancy": (_I, [_I, _I, _P]),
    # out (uint64 per phase), n, reset: the PHASE_CLOCKS build's counters
    "les_ukf_phase_clocks": (_I, [_P, _I, _I]),
    "les_ekf_phase_clocks": (_I, [_P, _I, _I]),
    "les_block_thomas_phase_clocks": (_I, [_P, _I, _I]),
    "les_block_thomas_factor_phase_clocks": (_I, [_P, _I, _I]),
}

_libs: dict[tuple[Path, tuple[str, ...]], ctypes.CDLL] = {}
_load_lock = threading.Lock()  # the mesh's device threads may load at once
# the wrappers' launch counters are bumped from every thread that drives a
# device (parallel/mesh.map_shards): a read-modify-write needs the lock
COUNT_LOCK = threading.Lock()
_extra: tuple[str, ...] = ()  # flags of the build the wrappers launch
_csrc: Path = CSRC            # sources of the build the wrappers launch


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


def library_path(extra: tuple[str, ...] = (), csrc: Path = CSRC) -> Path:
    """Content-hashed path of the library for the sources in ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for f in sorted(csrc.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libles_kernels_{h.hexdigest()[:16]}.so"


def _fail(cmd, proc, out):
    raise RuntimeError(
        f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}"
    )


def build(extra: tuple[str, ...] = (), csrc: Path = CSRC) -> Path:
    """Compile the kernels of ``csrc``, with ``extra`` nvcc flags, unless the
    library for these sources and flags exists: one nvcc per source, all
    started together, then one link."""
    path = library_path(extra, csrc)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    stem = f"{path.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(csrc.glob("*.cu")):
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
    """The kernel library, built on first call, with every signature set
    (another source tree's library, under ``sources``, may lack some
    entries)."""
    key = (_csrc, _extra)
    with _load_lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(build(_extra, _csrc)))
            for name, (res, args) in SIGNATURES.items():
                if _csrc != CSRC and not hasattr(lib, name):
                    continue
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _libs[key] = lib
        return _libs[key]


def count(counter: dict, key: str) -> None:
    """One launch more in ``counter[key]``, whatever thread launched it."""
    with COUNT_LOCK:
        counter[key] += 1


@contextlib.contextmanager
def _flags(extra: tuple[str, ...]):
    global _extra
    saved, _extra = _extra, extra
    try:
        yield
    finally:
        _extra = saved


@contextlib.contextmanager
def sources(csrc: Path):
    """Within, the wrappers launch the kernels built from ``csrc``, another
    tree's sources with the same C interface (an A/B measurement,
    ``tools/kernel_ab``)."""
    global _csrc
    saved, _csrc = _csrc, Path(csrc).resolve()
    try:
        yield
    finally:
        _csrc = saved


def without_fma():
    """Within, the wrappers launch the build with FMA contraction off, whose
    kernels give the plain versions' bits (a check; the default build is
    the one the port runs)."""
    return _flags(NO_FMA)


def phase_clocks():
    """Within, the wrappers launch the build whose kernels count their
    cycles by phase (``fused_ukf.phase_clocks``, ``fused_rollout.phase_clocks``
    and ``posegraph.solve_phase_clocks`` read them)."""
    return _flags(PHASE_CLOCKS)


# what the occupancy entry points write: registers a thread, local bytes a
# thread, static shared bytes a block, blocks an SM, worlds a block,
# dynamic shared bytes a block
OCCUPANCY_KEYS = ("registers", "local_bytes", "static_smem_bytes",
                  "blocks_per_sm", "worlds_per_block", "smem_bytes_per_block")


def occupancy(entry: str, *args: int) -> dict:
    """A kernel's launch as the card takes it, from its occupancy entry
    point (``les_ekf_occupancy``, ``les_ukf_occupancy``, ...) with
    ``args``: ``OCCUPANCY_KEYS`` and the worlds resident on one SM at once."""
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    check(getattr(load(), entry)(*args, out), entry)
    occ = dict(zip(OCCUPANCY_KEYS, out))
    occ["worlds_per_sm"] = occ["blocks_per_sm"] * occ["worlds_per_block"]
    return occ


def phase_cycles(entry: str, phases: tuple[str, ...], launch) -> tuple[dict, object]:
    """``launch()`` (which waits for its kernel) in the PHASE_CLOCKS build:
    the cycles of each of ``phases`` that the counters read by ``entry``
    (``les_ekf_phase_clocks``, ``les_ukf_phase_clocks``) gathered, zeroed
    before, and what ``launch`` returned."""
    with phase_clocks():
        read = getattr(load(), entry)
        cycles = (ctypes.c_uint64 * len(phases))()
        check(read(cycles, len(phases), 1), entry)
        res = launch()
        check(read(cycles, len(phases), 1), entry)
    return dict(zip(phases, (int(c) for c in cycles))), res


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a nonzero CUDA error code."""
    if rc != 0:
        msg = load().les_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
