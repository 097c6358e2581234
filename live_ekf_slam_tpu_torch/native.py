"""The port's build and ctypes binding of the native C++ host runtime.

Counterpart of ``live_ekf_slam_tpu/native.py``: the same entry points
(``occgrid_from_rgb``, ``astar_plan``, ``local_planner_bfs``, ``FrameRing``,
``JobScheduler``, ``astar_plan_batch``) over the same sources,
``native/src/*.cpp`` at the root of the repository. At first use ``load``
compiles them with g++ and the flags of ``native/Makefile`` into
``live_ekf_slam_tpu_torch/_build/liblesnative_<hash>.so`` (git ignores the
directory; the hash covers the sources, the flags and what ``-march=native``
means on this machine, so a changed source builds anew, and a library built
for one CPU is never loaded on another that may lack its instructions). The library is written under a temporary name and moved into
place, so processes that build at the same moment never load half a file.
There is no fallback: without g++, or if the build fails, ``load`` raises.

``occgrid_from_rgb`` is bound but serves nothing of the port: it differs
from Pillow's path of ``sim/maps.load_occ_map`` on the shipped maps (638 of
22500 cells on igvc1), so the port reads its maps with ``sim/png``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG.parent / "native" / "src"
BUILD_DIR = _PKG / "_build"
SOURCES = ("occgrid.cpp", "astar.cpp", "ringbuf.cpp", "scheduler.cpp")
# native/Makefile:3, and its link line's -lpthread
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")
LIBS = ("-lpthread",)

# C job signature of the scheduler: void job(void* arg). Python callbacks
# wrapped in JOB_FN take the GIL inside ctypes.
JOB_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_c_int, _c_i64 = ctypes.c_int, ctypes.c_int64
# name -> (restype, argtypes)
SIGNATURES = {
    "occgrid_from_rgb": (None, [ctypes.POINTER(ctypes.c_uint8), _c_int, _c_int,
                                _c_int, _c_int, _F]),
    "astar_plan": (_c_int, [_F, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                            _I, _c_int]),
    "local_planner_bfs": (_c_int, [_F, _c_int, _c_int, _c_int, _I]),
    "ringbuf_create": (_c_i64, [_c_int, _c_int]),
    "ringbuf_push": (_c_int, [_c_i64, _F, _c_int]),
    "ringbuf_pop_latest": (_c_int, [_c_i64, _F, _c_int]),
    "ringbuf_pop_oldest": (_c_int, [_c_i64, _F, _c_int]),
    "ringbuf_count": (_c_int, [_c_i64]),
    "ringbuf_dropped": (ctypes.c_uint64, [_c_i64]),
    "ringbuf_destroy": (None, [_c_i64]),
    "sched_create": (_c_i64, [_c_int]),
    "sched_submit": (_c_int, [_c_i64, JOB_FN, ctypes.c_void_p]),
    "sched_wait": (None, [_c_i64]),
    "sched_destroy": (None, [_c_i64]),
    "astar_plan_batch": (_c_int, [_F, _c_int, _I, _I, _c_int, _c_int, _c_int,
                                  _I, _c_int, _I]),
}

_LIB = None
# seconds the last build of this process took (0.0 when the library was
# already built)
build_seconds = 0.0


def find_cxx() -> str:
    """The C++ compiler: $CXX, then g++ on PATH."""
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("g++ not found ($CXX and PATH): the native library "
                       "(native/src/*.cpp) cannot be built")


def target(cxx: str) -> str:
    """The compiler's target options under ``-march=native`` on this
    machine (g++ ``-Q --help=target``: the CPU it resolves and each
    instruction set it enables)."""
    proc = subprocess.run([cxx, *CXX_FLAGS, "-Q", "--help=target"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} -Q --help=target failed with code "
                           f"{proc.returncode}:\n{proc.stderr}")
    return proc.stdout


def library_path() -> Path:
    """Content-hashed path of the library for the sources, the flags and
    the machine's target."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(target(find_cxx()).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"liblesnative_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/src/*.cpp`` into the library unless it exists."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp.so"
    cmd = [find_cxx(), *CXX_FLAGS, "-shared", "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return path


def load() -> ctypes.CDLL:
    """The native library, built on first call, with every signature set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (res, args) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _LIB = lib
    return _LIB


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_I)


def occgrid_from_rgb(rgb: np.ndarray, size: int, balloon: int) -> np.ndarray:
    """RGB uint8 (h, w, 3) -> (size, size) float32 occupancy {0, 1}."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = np.zeros((size, size), np.float32)
    load().occgrid_from_rgb(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            rgb.shape[0], rgb.shape[1], size, balloon, _fp(out))
    return out


def astar_plan(occ: np.ndarray, start_ij, goal_ij, diagonals=True):
    """The reference's A* (astar.py:59-127) on a (size, size) grid, 0
    blocked: the cells start -> goal without the start, or None."""
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    size = occ.shape[0]
    out = np.zeros((size * size, 2), np.int32)
    n = load().astar_plan(_fp(occ), size, int(start_ij[0]), int(start_ij[1]),
                          int(goal_ij[0]), int(goal_ij[1]), 1 if diagonals else 0,
                          _ip(out), size * size)
    if n < 0:
        return None
    return [tuple(row) for row in out[:n]]


def local_planner_bfs(occ: np.ndarray, start_ij):
    """The nearest free cell to ``start_ij`` by the reference's BFS, or None."""
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    out = np.zeros(2, np.int32)
    ok = load().local_planner_bfs(_fp(occ), occ.shape[0], int(start_ij[0]),
                                  int(start_ij[1]), _ip(out))
    return tuple(out) if ok else None


class FrameRing:
    """The async frame ring buffer (native/src/ringbuf.cpp): a producer
    pushes flat float32 frames, the render loop pops the newest at its own
    rate. Overwrite-oldest; ``dropped`` counts the frames overwritten."""

    def __init__(self, slot_floats: int, n_slots: int = 8):
        self._lib = load()
        self.slot_floats = int(slot_floats)
        self._h = self._lib.ringbuf_create(self.slot_floats, int(n_slots))
        if not self._h:
            raise RuntimeError("ringbuf_create failed")

    def push(self, frame: np.ndarray) -> bool:
        buf = np.ascontiguousarray(frame, dtype=np.float32).reshape(-1)
        if buf.size != self.slot_floats:
            raise ValueError(f"frame of {buf.size} floats, slots of {self.slot_floats}")
        return bool(self._lib.ringbuf_push(self._h, _fp(buf), self.slot_floats))

    def _pop(self, fn) -> np.ndarray | None:
        out = np.empty(self.slot_floats, np.float32)
        return out if fn(self._h, _fp(out), self.slot_floats) else None

    def pop_latest(self) -> np.ndarray | None:
        return self._pop(self._lib.ringbuf_pop_latest)

    def pop_oldest(self) -> np.ndarray | None:
        return self._pop(self._lib.ringbuf_pop_oldest)

    def __len__(self) -> int:
        return max(self._lib.ringbuf_count(self._h), 0)

    @property
    def dropped(self) -> int:
        return int(self._lib.ringbuf_dropped(self._h))

    def close(self):
        if self._h:
            self._lib.ringbuf_destroy(self._h)
            self._h = 0

    def __del__(self):  # pragma: no cover - best effort at exit
        try:
            self.close()
        except Exception:
            pass


class JobScheduler:
    """The host job pool (native/src/scheduler.cpp): Python callables run on
    its C++ worker threads (each takes the GIL; calls into C that release
    it, numpy's and ctypes', run side by side). Every submitted callback is
    kept referenced until a ``wait`` has seen it run: a callback collected
    early would crash its worker thread."""

    # a submit past this many callbacks since the last wait drains the pool
    # first, so that a caller that never waits does not pin them all
    KEEPALIVE_LIMIT = 4096

    def __init__(self, n_threads: int = 0):
        self._lib = load()
        self._h = self._lib.sched_create(int(n_threads))
        if not self._h:
            raise RuntimeError("sched_create failed")
        self._keepalive: list = []

    def submit(self, fn) -> None:
        if len(self._keepalive) >= self.KEEPALIVE_LIMIT:
            self.wait()
        cb = JOB_FN(lambda _arg: fn())
        self._keepalive.append(cb)
        if not self._lib.sched_submit(self._h, cb, None):
            raise RuntimeError("sched_submit failed")

    def wait(self) -> None:
        self._lib.sched_wait(self._h)
        self._keepalive.clear()

    def close(self):
        # drain first: queued callbacks must run while still referenced
        if self._h:
            self._lib.sched_wait(self._h)
            self._keepalive.clear()
            self._lib.sched_destroy(self._h)
            self._h = 0

    def __del__(self):  # pragma: no cover - best effort at exit
        try:
            self.close()
        except Exception:
            pass


def astar_plan_batch(occ: np.ndarray, starts, goals, diagonals=True,
                     n_threads: int = 0, max_len: int | None = None):
    """Many (start, goal) pairs over one grid on the native thread pool: a
    list of paths, each as ``astar_plan`` returns it for its pair."""
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    size = occ.shape[0]
    starts = np.ascontiguousarray(starts, dtype=np.int32).reshape(-1, 2)
    goals = np.ascontiguousarray(goals, dtype=np.int32).reshape(-1, 2)
    n = starts.shape[0]
    if goals.shape[0] != n:
        raise ValueError(f"{n} starts, {goals.shape[0]} goals")
    stride = max_len or size * size
    out = np.zeros((n, stride, 2), np.int32)
    lens = np.zeros(n, np.int32)
    load().astar_plan_batch(_fp(occ), size, _ip(starts), _ip(goals), n,
                            1 if diagonals else 0, int(n_threads), _ip(out),
                            stride, _ip(lens))
    return [[tuple(row) for row in out[j, : lens[j]]] if lens[j] >= 0 else None
            for j in range(n)]
