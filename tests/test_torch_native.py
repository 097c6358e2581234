"""The port's own build and binding of the native C++ runtime
(``live_ekf_slam_tpu_torch/native``, ``native/src/*.cpp``): the frame ring,
the job scheduler and the batched A* as the JAX package's native tests
check them; ``astar_plan`` equal cell by cell to the port's Python A*
(``planning/host.AstarHost.plan_cells_reference``, its plain twin) and to
JAX's ``plan_cells`` (whose Python path serves: JAX's library is not
built) on the igvc1, building1 and blank grids; ``occgrid_from_rgb`` bit for
bit against JAX's wrapper on the same library. The port builds into its own
``_build`` directory and never into ``live_ekf_slam_tpu/native_lib/``, so
JAX's ``native.available()`` stays false."""

import dataclasses
import os
import threading

import numpy as np
import pytest

from live_ekf_slam_tpu import native as jnative
from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.planning.host import AstarHost as JAstarHost
from live_ekf_slam_tpu.sim import maps as jmaps
from live_ekf_slam_tpu_torch import native
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.planning.host import AstarHost
from live_ekf_slam_tpu_torch.sim import maps as tmaps
from live_ekf_slam_tpu_torch.sim.png import read_png
from port_harness import few_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

MAPS = ("igvc1.png", "building1.png", "blank.jpg")
PAIRS = 12  # random start-goal pairs a map


def test_library_builds_into_the_ports_own_directory():
    path = native.library_path()
    assert native.load() is native.load()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("liblesnative_") and path.suffix == ".so"
    # never where the JAX package would find it
    jax_lib = os.path.join(os.path.dirname(jnative.__file__), "native_lib")
    assert not os.path.exists(jax_lib)
    assert not jnative.available()


def test_library_path_follows_the_machines_target(monkeypatch):
    # a library built with -march=native on one CPU is not loaded on another
    here = native.library_path()
    monkeypatch.setattr(native, "target", lambda cxx: "-march= other-cpu\n")
    assert native.library_path() != here


def test_load_raises_without_a_compiler(monkeypatch, tmp_path):
    # no fallback: without g++ the library cannot be had
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()


def test_frame_ring():
    # overwrite-oldest + latest-wins, FIFO pops, drop accounting
    ring = native.FrameRing(4, n_slots=3)
    for i in range(5):
        assert ring.push(np.full(4, float(i), np.float32))
    assert len(ring) == 3 and ring.dropped == 2
    latest = ring.pop_latest()
    assert latest is not None and latest[0] == 4.0
    assert len(ring) == 0 and ring.pop_latest() is None
    ring.push(np.full(4, 7.0, np.float32))
    ring.push(np.full(4, 8.0, np.float32))
    assert ring.pop_oldest()[0] == 7.0
    assert ring.pop_oldest()[0] == 8.0
    with pytest.raises(ValueError, match="frame of 3 floats"):
        ring.push(np.zeros(3, np.float32))

    def produce():
        for i in range(100):
            ring.push(np.full(4, float(i), np.float32))

    th = threading.Thread(target=produce)
    th.start()
    th.join()
    assert ring.pop_latest()[0] == 99.0
    ring.close()


def test_job_scheduler_runs_every_job():
    sched = native.JobScheduler(4)
    results = []
    lock = threading.Lock()
    for i in range(32):
        def job(i=i):
            with lock:
                results.append(i)
        sched.submit(job)
    sched.wait()
    assert sorted(results) == list(range(32))
    assert not sched._keepalive  # released once they ran
    sched.close()


def test_batched_astar_equals_single():
    rng = np.random.default_rng(0)
    occ = np.ones((40, 40), np.float32)
    occ[10:30, 18:22] = 0.0  # wall with gaps at the edges
    pairs = []
    while len(pairs) < 6:
        s = tuple(rng.integers(0, 40, 2))
        g = tuple(rng.integers(0, 40, 2))
        if occ[s] > 0 and occ[g] > 0:
            pairs.append((s, g))
    starts = np.array([p[0] for p in pairs], np.int32)
    goals = np.array([p[1] for p in pairs], np.int32)
    batch = native.astar_plan_batch(occ, starts, goals, n_threads=4)
    for (s, g), got in zip(pairs, batch):
        assert got == native.astar_plan(occ, s, g), (s, g)
        assert got is not None and got[-1] == g


def _grids(name):
    jcfg = JConfig().replace(occ_map_img=name)
    cfg = Config().replace(occ_map_img=name)
    return jcfg, cfg, jmaps.load_occ_map(jcfg)[0], tmaps.load_occ_map(cfg)[0]


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("diagonals", [True, False])
def test_astar_plan_equals_the_python_astar_and_jax(name, diagonals):
    jcfg, cfg, j_occ, occ = _grids(name)
    np.testing.assert_array_equal(occ, j_occ)
    pp = dataclasses.replace(cfg.path_planning, astar_incl_diagonals=diagonals)
    cfg = cfg.replace(path_planning=pp)
    jcfg = jcfg.replace(path_planning=dataclasses.replace(
        jcfg.path_planning, astar_incl_diagonals=diagonals))
    host, jhost = AstarHost(cfg, occ), JAstarHost(jcfg, j_occ)
    free = np.argwhere(occ > 0.5)
    rng = np.random.default_rng(7)
    found = 0
    for _ in range(PAIRS):
        s, g = (tuple(int(v) for v in free[rng.integers(len(free))]) for _ in range(2))
        got = host.plan_cells(s, g)
        assert got == host.plan_cells_reference(s, g), (s, g)
        assert got == jhost.plan_cells(s, g), (s, g)
        found += got is not None
    assert found >= PAIRS // 2
    # a start off the grid has no plan on either side
    assert host.plan_cells((-1, 3), (5, 5)) is None
    assert host.plan_cells_reference((-1, 3), (5, 5)) is None


@pytest.mark.parametrize("name", ["igvc1.png", "building1.png"])
def test_occgrid_from_rgb_equals_jax_wrapper_on_the_same_library(name, monkeypatch):
    arr = read_png(os.path.join(tmaps.ASSET_DIR, name))
    a1 = 255 - arr[:, :, 3].astype(np.int32) if arr.shape[2] == 4 else 0
    rgb = np.clip(arr[:, :, :3].astype(np.int32)
                  + (a1[:, :, None] if arr.shape[2] == 4 else 0), 0, 255)
    rgb = rgb.astype(np.uint8)
    cfg = Config().map
    got = native.occgrid_from_rgb(rgb, cfg.occ_map_size, cfg.occ_map_balloon_amt)
    # JAX's wrapper on the port's library, inside this test only
    monkeypatch.setattr(jnative, "_LIB", native.load())
    monkeypatch.setattr(jnative, "_TRIED", True)
    want = jnative.occgrid_from_rgb(rgb, cfg.occ_map_size, cfg.occ_map_balloon_amt)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (cfg.occ_map_size,) * 2 and set(np.unique(got)) <= {0.0, 1.0}
    # the raster pipeline is not the Pillow path: the port reads its maps
    # with sim/png instead
    occ = tmaps.load_occ_map(Config().replace(occ_map_img=name))[0]
    assert (got != occ).sum() > 0


def test_jax_native_stays_unavailable():
    assert not jnative.available()
    assert not os.path.exists(os.path.join(os.path.dirname(jnative.__file__),
                                           "native_lib"))
