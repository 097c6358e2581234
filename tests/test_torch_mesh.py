"""The port's world mesh (``parallel/mesh``) against the JAX package's on
the conftest's 8 virtual CPU devices: ``make_mesh``'s errors, placement and
gathering of a ``RunCarry``, the cross-device mean against JAX's
``mean_over_worlds``, the per-tick step under ``sharded_step`` against
JAX's sharded step in ``test_mesh_sharded_step_and_reduction``'s set-up
(16 worlds, 3 landmarks, here 4 ticks, the port's draws rebuilt from JAX's
keys), the sharded checkpoint round trip, the launch counters under
threads, and the weak-scaling tool on the CPU.

Tolerances: the mean of a sharded tensor against JAX's and against
``torch.mean`` rtol 1e-6, as ``test_infra.py`` holds JAX's sharded mean to
its unsharded one (float32 sums in another order). The per-tick step
against JAX: the per-tick path's (``test_torch_per_tick_runner.py``), the
same float32 algebra with last-bit differences in the CPU transcendentals.
Within the port, sharded against unsharded: bit for bit where the step
runs no transcendental (placement, the checkpoint); the per-tick step to
the per-tick tolerances, since on the CPU a world's bits depend on its
place in the batch: torch.atan2 takes a vectorised path for whole vector
chunks of a tensor and a scalar one for its tail, and the two part in the
last bit (for 691 of 4096 random inputs), so a world that falls in the
tail of its shard but not of the whole batch rounds otherwise. JAX holds
its sharded step by the mean alone.
"""

import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_ekf_slam_tpu.config import Config as JConfig
from live_ekf_slam_tpu.eval import runner as jrunner
from live_ekf_slam_tpu.parallel import mesh as jmesh
from live_ekf_slam_tpu_torch.config import Config
from live_ekf_slam_tpu_torch.convert import run_carry_from_numpy
from live_ekf_slam_tpu_torch.eval import runner
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.parallel import mesh as pmesh
from live_ekf_slam_tpu_torch.tools import weak_scaling
from live_ekf_slam_tpu_torch.utils import checkpoint as ckpt
from port_harness import few_threads, tick_noise  # noqa: F401  (few_threads: a fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

B, N, T = 16, 3, 4
MEAN_RTOL = 1e-6
ERR_ATOL = 1e-5
POSE_ATOL = 1e-4


def _cfg(cls):
    cfg = cls(num_iterations=T).replace(num_landmark_slots=N, num_meas_slots=N)
    return cfg.replace(map=cfg.map.__class__(num_landmarks=N))


def _carry(b=B, seed=0):
    cfg = Config(num_iterations=T)
    lms, _ = runner.mc_inputs(cfg, b, seed, "cpu")
    return runner.init_carry(cfg, lms, lms.shape[1])


def test_make_mesh_and_its_errors(monkeypatch):
    m = pmesh.make_mesh(8, "cpu")
    assert m.size == 8 and m.shape == {"worlds": 8} and m.virtual
    assert m.axis_names == ("worlds",) and m.stream(0) is None
    assert pmesh.make_mesh(device_type="cpu").size == 1
    with pytest.raises(ValueError, match="one type"):
        pmesh.Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        pmesh.Mesh([])
    with pytest.raises(ValueError, match="cuda or cpu"):
        pmesh.make_mesh(2, "tpu")
    v = pmesh.virtual_mesh(4)
    assert v.devices == (torch.device("cuda", 0),) * 4 and v.virtual
    assert pmesh.Mesh(["cuda:0", "cuda:1"]) == pmesh.Mesh(["cuda", "cuda:1"])
    assert not pmesh.Mesh(["cuda:0", "cuda:1"]).virtual
    # without CUDA make_mesh raises; with two cards it gives both, and
    # names the count and the virtual mesh when asked for more
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.make_mesh().devices == (torch.device("cuda", 0),
                                         torch.device("cuda", 1))
    assert pmesh.make_mesh(1).size == 1
    with pytest.raises(ValueError, match=r"only 2 CUDA device.*virtual_mesh\(4\)"):
        pmesh.make_mesh(4)


def test_shard_batch_and_gather_round_trip_a_run_carry():
    mesh = pmesh.make_mesh(8, "cpu")
    carry = _carry()
    sh = pmesh.shard_batch(carry, mesh)
    assert len(sh) == 8 and sh.placement == pmesh.world_sharding(mesh)
    for d, part in enumerate(sh.parts):
        for a, b in zip(ckpt.leaves(part), ckpt.leaves(carry)):
            assert torch.equal(a, b[2 * d:2 * d + 2]) and a.is_contiguous()
    back = pmesh.gather(sh)
    assert type(back) is type(carry) and back.secondary is None
    for a, b in zip(ckpt.leaves(back), ckpt.leaves(carry)):
        assert torch.equal(a, b)
    # a shard is a copy: writing it leaves the tree it came from alone
    sh.parts[0].err_sum_primary.fill_(7.0)
    assert not bool((carry.err_sum_primary == 7.0).any())
    # another world axis: the injected-noise layout (T, 2N+8, B)
    noise = torch.arange(5 * 3 * B, dtype=torch.float32).reshape(5, 3, B)
    nz = pmesh.shard_batch(noise, pmesh.world_sharding(mesh, 2))
    assert all(p.is_contiguous() and torch.equal(p, noise[..., 2 * d:2 * d + 2])
               for d, p in enumerate(nz.parts))
    assert torch.equal(pmesh.gather(nz), noise)
    # replicated: a whole copy on every shard; gathered, one copy
    occ = torch.rand(6, 6)
    rep = pmesh.shard_batch(occ, pmesh.replicated(mesh))
    assert all(torch.equal(p, occ) for p in rep.parts)
    assert torch.equal(pmesh.gather(rep), occ)
    # a slice of every shard keeps the placement
    first = nz.map(lambda x: x[:2])
    assert torch.equal(pmesh.gather(first), noise[:2])


def test_shard_batch_needs_a_batch_the_mesh_divides():
    mesh = pmesh.make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="batch 12 not divisible by mesh size 8"):
        pmesh.shard_batch(_carry(12), mesh)
    with pytest.raises(ValueError, match="no axis 2"):
        pmesh.shard_batch(torch.zeros(16, 3), pmesh.world_sharding(mesh, 2))
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.sharded_step(lambda c: (c, None), mesh)(torch.zeros(12))


def test_mean_over_worlds_matches_jax_on_eight_devices():
    x = np.random.default_rng(0).uniform(0, 0.3, (4096, 3)).astype(np.float32)
    jm = jmesh.make_mesh(8)
    want = np.asarray(jmesh.mean_over_worlds(
        jax.device_put(jnp.asarray(x), jmesh.world_sharding(jm)), jm))
    mesh = pmesh.make_mesh(8, "cpu")
    got = pmesh.mean_over_worlds(pmesh.shard_batch(torch.from_numpy(x), mesh), mesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=MEAN_RTOL)
    np.testing.assert_allclose(got.numpy(), torch.from_numpy(x).mean(0).numpy(),
                               rtol=MEAN_RTOL)
    # a tensor that is not sharded: torch.mean
    assert torch.equal(pmesh.mean_over_worlds(torch.from_numpy(x)),
                       torch.from_numpy(x).mean(0))
    with pytest.raises(ValueError, match="lies on"):
        pmesh.mean_over_worlds(pmesh.shard_batch(torch.from_numpy(x), mesh),
                               pmesh.make_mesh(4, "cpu"))


def test_sharded_step_matches_jax_sharded_step():
    jcfg, cfg = _cfg(JConfig), _cfg(Config)
    lms = np.random.default_rng(0).uniform(-5, 5, (B, N, 2)).astype(np.float32)
    carry_j = jax.vmap(lambda l: jrunner.init_carry(jcfg, l))(jnp.asarray(lms))
    tick_keys = jax.vmap(lambda k: jax.random.split(k, T))(
        jax.random.split(jax.random.PRNGKey(1), B))
    cmds = np.tile(np.asarray([[0.05, 0.0]], np.float32), (B, 1))
    jm = jmesh.make_mesh(8)
    jstep = jmesh.sharded_step(jax.vmap(jrunner.make_step(jcfg)), jm)
    c_j = jmesh.shard_batch(carry_j, jm)
    for t in range(T):
        c_j, _ = jstep(c_j, jmesh.shard_batch((jnp.asarray(cmds), tick_keys[:, t]), jm))
    mean_j = float(jnp.mean(c_j.err_sum_primary))

    # the port from the same start, the draws rebuilt from the same keys
    u = torch.from_numpy(np.stack([tick_noise(k, N) for k in tick_keys]))  # (B, T, 2N+8)
    start = run_carry_from_numpy(carry_j, "ekf_slam")
    mesh = pmesh.make_mesh(8, "cpu")
    step = runner.make_step(cfg)
    sstep = pmesh.sharded_step(step, mesh)
    c_sh, c_1 = pmesh.shard_batch(start, mesh), start
    cmd = torch.from_numpy(cmds)
    for t in range(T):
        c_sh, out = sstep(c_sh, cmd, u[:, t], t)
        c_1, _ = step(c_1, cmd, u[:, t], t)
        assert isinstance(out, pmesh.Shards) and out.parts == (None,) * 8
    fin = pmesh.gather(c_sh)
    # sharded against unsharded (see the module note)
    np.testing.assert_allclose(fin.err_sum_primary.numpy(),
                               c_1.err_sum_primary.numpy(), rtol=0, atol=ERR_ATOL)
    np.testing.assert_allclose(fin.primary.x.numpy(), c_1.primary.x.numpy(),
                               rtol=0, atol=POSE_ATOL)
    for f in ("alive_primary", "ticks_primary"):
        assert torch.equal(getattr(fin, f), getattr(c_1, f))
    assert torch.equal(fin.primary.M, c_1.primary.M)
    np.testing.assert_allclose(fin.err_sum_primary.numpy(),
                               np.asarray(c_j.err_sum_primary), rtol=0, atol=ERR_ATOL)
    assert float(fin.err_sum_primary.min()) > 0
    np.testing.assert_array_equal(fin.alive_primary.numpy(), np.asarray(c_j.alive_primary))
    np.testing.assert_array_equal(fin.primary.M.numpy(), np.asarray(c_j.primary.M))
    np.testing.assert_allclose(fin.primary.x.numpy(), np.asarray(c_j.primary.x),
                               rtol=0, atol=POSE_ATOL)
    err = pmesh.Shards([c.err_sum_primary for c in c_sh.parts], c_sh.placement)
    assert float(pmesh.mean_over_worlds(err, mesh)) == pytest.approx(
        mean_j, rel=0, abs=ERR_ATOL)


def test_sharded_checkpoint_round_trip(tmp_path):
    mesh = pmesh.make_mesh(8, "cpu")
    cfg = Config(num_iterations=T)
    carry = _carry()
    step = pmesh.sharded_step(runner.make_step(cfg), mesh)
    noise = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (B, 48)).astype(np.float32))
    sh, _ = step(pmesh.shard_batch(carry, mesh), torch.full((B, 2), 0.05), noise)
    path = str(tmp_path / "sharded.npz")
    ckpt.save_sharded(path, sh)
    back = ckpt.restore_sharded(path, pmesh.shard_batch(carry, mesh))
    assert back.placement == sh.placement
    for p, q in zip(sh.parts, back.parts):
        for a, b in zip(ckpt.leaves(p), ckpt.leaves(q)):
            assert torch.equal(a, b) and a.dtype == b.dtype
    # the resumed run continues as the original one does
    c1, _ = step(sh, torch.full((B, 2), 0.05), noise)
    c2, _ = step(back, torch.full((B, 2), 0.05), noise)
    for a, b in zip(ckpt.leaves(pmesh.gather(c1)), ckpt.leaves(pmesh.gather(c2))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="8 shards"):
        ckpt.restore_sharded(path, pmesh.shard_batch(carry, pmesh.make_mesh(4, "cpu")))


def test_launch_counts_are_exact_across_threads():
    # the mesh's device threads bump the wrappers' counters at once: no
    # increment may be lost (more threads than cores, a short switch
    # interval)
    counter, n_threads, per = {"k": 0}, 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count(counter, "k")
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter["k"] == n_threads * per


def test_weak_scaling_tool_on_the_cpu(capsys):
    assert weak_scaling.main(["--device", "cpu", "--devices", "1", "2",
                              "--worlds-per-device", "2", "--t", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["worlds"] for r in rows] == [2, 4]
    assert all(r["mode"] == "virtual" and r["device_kind"] == "cpu"
               and r["t"] == 5 and np.isfinite(r["mean_err"]) for r in rows)
    assert out[-4].startswith("| devices")
    # shard 0 of every row makes the same worlds: its mean error is the
    # one-shard row's, so the two-shard row's mean is the mean of shard 0's
    # and shard 1's
    row1 = weak_scaling.run_row(1, 2, 5, device="cpu", seed=pmesh.shard_seed(0, 1))
    assert rows[1]["mean_err"] == pytest.approx(
        (rows[0]["mean_err"] + row1["mean_err"]) / 2, rel=1e-6)
    with pytest.raises(SystemExit):
        weak_scaling.main(["--real", "--device", "cpu"])


def test_a_thread_a_device_gives_the_same_shards(monkeypatch):
    # a real mesh runs each device's shards in a thread of its own; here
    # every CPU shard poses as a device of its own: the same results in
    # shard order, and a shard's failure raises in the caller
    mesh = pmesh.make_mesh(4, "cpu")
    step = pmesh.sharded_step(runner.make_step(Config(num_iterations=T)), mesh)
    carry = pmesh.shard_batch(_carry(8), mesh)
    u = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (8, 48)).astype(np.float32))
    want, _ = step(carry, torch.full((8, 2), 0.05), u)
    monkeypatch.setattr(pmesh.Mesh, "groups", lambda self: [[d] for d in range(self.size)])
    got, _ = step(carry, torch.full((8, 2), 0.05), u)
    for a, b in zip(ckpt.leaves(pmesh.gather(want)), ckpt.leaves(pmesh.gather(got))):
        assert torch.equal(a, b)
    threads = pmesh.map_shards(mesh, lambda d: (d, threading.get_ident()))
    assert [p[0] for p in threads.parts] == [0, 1, 2, 3]
    assert threading.get_ident() not in {p[1] for p in threads.parts}

    def fail(d):
        if d == 2:
            raise RuntimeError("shard 2 failed")
        return d
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        pmesh.map_shards(mesh, fail)
