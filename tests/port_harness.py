"""Shared pieces of the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to the JAX package and to
the port alike. Tests that need an NVIDIA GPU take the ``cuda_device``
fixture and carry the ``cuda`` marker; the fixture decides at run time, never
at import, so every pytest-xdist worker collects the same tests.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from oracle import EKFOracle


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def small_cfg(config_cls, compat_cls, kind: str, t: int, n: int,
              bound: float = 10.0):
    """A T-tick, N-landmark config of one of the three kinds the rollout
    tests cover; ``config_cls`` is either package's Config."""
    cfg = config_cls(num_iterations=t).replace(
        num_landmark_slots=n, num_meas_slots=n
    )
    cfg = cfg.replace(map=cfg.map.__class__(num_landmarks=n, bound=bound))
    if kind == "compat":
        cfg = cfg.replace(compat=compat_cls.all_on())
    elif kind == "calibrated":
        cfg = cfg.replace(calibrated_motion=True)
    elif kind != "default":
        raise ValueError(kind)
    return cfg


def arc_commands(b: int, t: int) -> np.ndarray:
    """(B, T, 2) forward-and-weave commands, the JAX kernel tests' stream."""
    t_arr = np.arange(t, dtype=np.float32)
    cmds = np.stack([0.08 + 0 * t_arr, 0.02 * np.sin(t_arr / 5)], axis=-1)
    return np.broadcast_to(cmds[None], (b, t, 2)).copy()


def oracle_replay(cfg, lms_w, cmds_w, noise_w):
    """One world replayed in float64: the simulator on the injected noise,
    measurements in id order, the reference-equation EKF oracle. Returns
    (oracle, true pose, error sum)."""
    t_total, n = cmds_w.shape[0], lms_w.shape[0]
    v00, v11 = cfg.process_noise.V_00, cfg.process_noise.V_11
    w00, w11 = cfg.sensing_noise.W_00, cfg.sensing_noise.W_11
    (v00f, v11f), (w00f, w11f) = cfg.filter_noise()
    o = EKFOracle(
        0, 0, 0, V=(v00f, v11f), W=(w00f, w11f),
        stale_landmarks=cfg.compat.ekf_stale_landmarks,
        unwrapped_innovation=cfg.compat.ekf_unwrapped_innovation,
    )
    vis_cfg = cfg.constraints.vision
    pose = np.zeros(3)
    err_sum = 0.0
    for t in range(t_total):
        u = noise_w[t].astype(np.float64)
        d = np.clip(cmds_w[t, 0] + v00 * u[0], 0,
                    cfg.constraints.commands.d_max)
        h = np.clip(cmds_w[t, 1] + v11 * u[1],
                    -cfg.constraints.commands.th_max,
                    cfg.constraints.commands.th_max)
        pose = np.array([pose[0] + d * math.cos(pose[2]),
                         pose[1] + d * math.sin(pose[2]), pose[2] + h])
        meas = []
        for j in range(n):
            dx, dy = lms_w[j] - pose[:2]
            r = math.hypot(dx, dy)
            beta = math.remainder(math.atan2(dy, dx) - pose[2], 2 * math.pi)
            if r <= vis_cfg.range_max and vis_cfg.fov_min < beta < vis_cfg.fov_max:
                meas.append((j, r + w00 * u[2 + j], beta + w11 * u[2 + n + j]))
        o.update((cmds_w[t, 0], cmds_w[t, 1]), meas)
        err_sum += math.hypot(o.x_t[0] - pose[0], o.x_t[1] - pose[1])
    return o, pose, err_sum


def max_co_observed(cfg, lms, cmds, noise) -> int:
    """The most landmarks any world sees in one tick: the float64 simulator
    replayed on the injected noise for every world at once. A test of the
    sequential per-landmark updates needs this to be at least 2."""
    t_total, n = cmds.shape[1], lms.shape[1]
    cmd_lim, vis_cfg = cfg.constraints.commands, cfg.constraints.vision
    nz = cfg.sim_noise_scale
    x, y, th = (np.full(lms.shape[0], v, np.float64) for v in cfg.init_pose)
    most = 0
    for t in range(t_total):
        u = noise[t].astype(np.float64)  # (2N+8, B)
        d = np.clip(cmds[:, t, 0] + cfg.process_noise.V_00 * nz * u[0], 0,
                    cmd_lim.d_max)
        h = np.clip(cmds[:, t, 1] + cfg.process_noise.V_11 * nz * u[1],
                    -cmd_lim.th_max, cmd_lim.th_max)
        x, y, th = x + d * np.cos(th), y + d * np.sin(th), th + h
        dx, dy = lms[:, :, 0] - x[:, None], lms[:, :, 1] - y[:, None]
        beta = np.remainder(np.arctan2(dy, dx) - th[:, None] + math.pi,
                            2 * math.pi) - math.pi
        vis = ((np.hypot(dx, dy) <= vis_cfg.range_max)
               & (beta > vis_cfg.fov_min) & (beta < vis_cfg.fov_max))
        most = max(most, int(vis.sum(axis=1).max()))
    return most


def tick_noise(tick_keys, n: int) -> np.ndarray:
    """(T, 2N+8) uniforms of one world's tick keys, as JAX's sim_step draws
    them (k_move, k_sense = split(key)), in the injection layout. jax is
    imported inside: the card's tests import this module and need none."""
    import jax
    import jax.numpy as jnp

    def one(tk):
        k_move, k_sense = jax.random.split(tk)
        u_move = jax.random.uniform(k_move, (2,), jnp.float32, -1.0, 1.0)
        u_sense = jax.random.uniform(k_sense, (2, n), jnp.float32, -1.0, 1.0)
        return jnp.concatenate([u_move, u_sense.reshape(-1), jnp.zeros(8)])
    return np.asarray(jax.vmap(one)(tick_keys))


def key_chain(key, batch: int, t: int, n: int):
    """(traj_u (B, N, 2), noise (T, 2N+8, B)): the trajectory's and the
    simulator's draws of JAX run_monte_carlo(impl="xla") for ``key``: per
    world k_traj, k_roll = split(key_w), the tick keys split(k_roll, T)."""
    import jax
    import jax.numpy as jnp

    u, nz = [], []
    for k in jax.random.split(key, batch):
        k_traj, k_roll = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_traj, (n, 2), jnp.float32, -1.0, 1.0)))
        nz.append(tick_noise(jax.random.split(k_roll, t), n))
    return torch.from_numpy(np.stack(u)), torch.from_numpy(np.stack(nz, axis=2))


def closed_loop_noise(key, batch: int, t: int, n: int) -> torch.Tensor:
    """(T, 2N+8, B): the simulator's draws of JAX run_closed_loop(key,
    batch) over T ticks for an N-landmark map: per world key_w of
    split(key, batch), the tick keys split(key_w, T) (the blocks' keys in
    order), each drawn as ``tick_noise`` does."""
    import jax

    return torch.from_numpy(np.stack(
        [tick_noise(jax.random.split(k, t), n) for k in jax.random.split(key, batch)],
        axis=2))


@pytest.fixture(scope="module")
def few_threads():
    """torch on 2 CPU threads for a module's tests, then as before: the
    tests run in several processes side by side (pytest-xdist), and the
    small batched ops of the per-tick and closed-loop paths gain nothing
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
