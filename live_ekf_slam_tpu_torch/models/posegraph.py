"""Pose-graph SLAM: per-tick accumulation, vectorised assembly, the bulk
Schur / block-Thomas Gauss-Newton solver, the iterative replay, chordal
initialisation and the dense Levenberg-Marquardt solve.

Counterpart of ``live_ekf_slam_tpu/models/posegraph.py``, all of it but
``solve_alternating`` (a documented dead end of the JAX package). The
factors are those of pose_graph.cpp: a prior on pose 0, one SE(2)
between-factor per tick from the commanded odometry, one bearing-range
factor per detection (bearing first), node values seeded from the secondary
filter. Every function takes a batch of worlds on the leading axis (the
JAX functions are per world under ``jax.vmap``), so errors and dampings are
(B,) vectors and each world keeps its own Levenberg schedule.

Solvers here:

* ``solve_schur_pcg``: landmarks eliminated by Schur complement, CG on the
  pose system preconditioned by its exact block-tridiagonal chain part. The
  chain's factorisation and solves are the sequential recursions the JAX
  package runs as ``lax.scan``; on a CUDA tensor ``_tridiag_factor`` and
  ``_tridiag_solve`` launch the hand-written kernels of
  ``csrc/block_thomas.cu``, on a CPU tensor their plain versions
  ``_tridiag_factor_reference`` / ``_tridiag_solve_reference``. There is no
  fallback from one to the other. The solve splits each chain into segments
  joined by a scan (``_tridiag_solve_sequential`` is the plain loop it
  replaced, kept as a yardstick). Each CG step's Schur matvec, ``_schur_mv``,
  is one launch of ``csrc/schur_mv.cu`` on a CUDA tensor and its plain
  version ``_schur_mv_reference`` on a CPU tensor (``_schur_mv_torch``, the
  torch passes it replaced, is the yardstick). Each Gauss-Newton step's
  system (``_schur_system``: residuals, Jacobians, coefficients, gradient,
  blocks, landmark inverses and the reduced rhs) is one launch of
  ``csrc/gn_system.cu`` on a CUDA tensor and the torch passes of
  ``_schur_system_torch`` on a CPU tensor (``_schur_system_reference`` is
  the kernel's order of sums). The landmark back-substitution stays torch
  passes.
* ``solve_pcg_gn``: matrix-free Jacobi-PCG, used per tick by
  ``replay_iterative`` (solve_graph_every_iteration mode, warm starts only).
* ``chordal_init``: the initial iterate from the factors alone (integrated
  headings, dead-reckoned positions, averaged landmark back-projections),
  polished by ``solve_schur_pcg(fix_theta=True)``.
* ``solve_dense``: the graduated dense Levenberg-Marquardt solve over the
  (3(T+1)+2N)-dim normal equations (``_assemble``, ``_solve_stage``), with
  ``torch.linalg.cholesky_ex``; ``solve`` dispatches between it and the
  graduated Schur solve, ``finalize`` runs ``solve`` on a finished graph.

The per-tick accumulation (``init``, ``update_naive_estimate``, ``update``)
builds the graph one tick at a time, as the per-tick runner steps it. The
tick is a Python int shared by every world, so a tick's rows are plain
column writes into the graph tensors.

Scatter-adds. ``.at[meas_lm].add`` of the JAX code would be ``scatter_add_``
here, which on CUDA adds with atomics in an order that changes from run to
run, and CG amplifies that. Graphs from ``assemble_streams`` and from
``update`` (with K >= N) bind measurement column j to one landmark slot in
every tick, so a sum over ticks followed by
a per-world placement of the K column sums is exact and deterministic.
``LmSlots`` checks that property on the graph it is given and takes the
general ``scatter_add_`` when it does not hold.
"""

from __future__ import annotations

import functools

import torch

from live_ekf_slam_tpu_torch.core.noise import S3, _div, clip_uniform_moments
from live_ekf_slam_tpu_torch.core.types import Measurements, PoseGraphState
from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops.precision import first_match, pin_fp32
from live_ekf_slam_tpu_torch.utils import profiling
from live_ekf_slam_tpu_torch.utils.geometry import wrap_angle

# launches of the block-Thomas kernels, the Schur matvec and the Gauss-Newton
# system (not of their plain versions)
launches = {"factor": 0, "solve": 0, "schur_mv": 0, "system": 0}
# threads of the solve kernel a world (csrc/block_thomas.cu, kSegments), so
# segments of the chain its plain version splits
SOLVE_SEGMENTS = 128
# threads of the Schur matvec kernel a world (csrc/schur_mv.cu, kThreads), so
# the partial sums of H_pl^T v its plain version keeps apart
SCHUR_THREADS = 256
# threads of the system kernel a world (csrc/gn_system.cu, kThreads), so the
# partial sums of H_ll and g_l its plain version keeps apart
SYSTEM_THREADS = 256


def init(cfg, batch: int, init_pose=None, device="cpu") -> PoseGraphState:
    """Empty graphs of ``batch`` worlds at full capacity (T ticks, K
    measurement slots a tick, N landmark slots), node 0 at the initial
    pose."""
    t_cap = cfg.num_iterations
    n, k = cfg.num_landmark_slots, cfg.num_meas_slots
    f32 = dict(dtype=torch.float32, device=device)
    pose = torch.as_tensor(cfg.init_pose if init_pose is None else init_pose,
                           **f32).expand(batch, 3)
    poses = torch.zeros((batch, t_cap + 1, 3), **f32)
    poses[:, 0] = pose
    i32 = dict(dtype=torch.int32, device=device)
    return PoseGraphState(
        poses_init=poses,
        lms_init=torch.zeros((batch, n, 2), **f32),
        odom=torch.zeros((batch, t_cap, 2), **f32),
        odom_valid=torch.zeros((batch, t_cap), dtype=torch.bool, device=device),
        meas_rb=torch.zeros((batch, t_cap, k, 2), **f32),
        meas_lm=torch.zeros((batch, t_cap, k), **i32),
        meas_valid=torch.zeros((batch, t_cap, k), dtype=torch.bool, device=device),
        ids=torch.full((batch, n), -1, **i32),
        M=torch.zeros(batch, **i32),
        timestep=torch.zeros(batch, **i32),
        cur_pose=pose.clone(),
        poses_sol=poses.clone(),
        lms_sol=torch.zeros((batch, n, 2), **f32),
        solved=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def update_naive_estimate(s: PoseGraphState, secondary_pose, secondary_lms=None,
                          secondary_ids=None, secondary_m=None,
                          update_landmarks: bool = False) -> PoseGraphState:
    """updateNaiveVehPoseEstimate (pose_graph.cpp:97-119): keep the secondary
    filter's pose (B, >=3) to seed the next graph node.

    With ``update_landmarks`` (update_landmarks_after_adding) and a SLAM
    secondary, the graph's landmark values, initial and solved, are
    refreshed from the secondary's estimates (B, Ns, 2), matched by id: a
    one-hot contraction over the secondary's slots, as in the JAX model
    (ids are unique, so a row holds at most one match; a NaN estimate
    spreads to every row of its world, as there)."""
    s = s.replace(cur_pose=secondary_pose[:, :3])
    if not update_landmarks or secondary_lms is None:
        return s
    dev = s.ids.device
    slot_idx = torch.arange(s.ids.shape[1], device=dev)
    sec_idx = torch.arange(secondary_ids.shape[1], device=dev)
    # graph slot i (id g) <- secondary slot j with ids[j] == g
    match = ((secondary_ids[:, None, :] == s.ids[:, :, None])
             & (sec_idx[None, None, :] < secondary_m[:, None, None]))
    found = match.any(dim=2) & (slot_idx[None, :] < s.M[:, None])
    est = (match.to(torch.float32)[..., None]
           * secondary_lms[:, None, :, :]).sum(dim=2)  # (B, N, 2)
    return s.replace(lms_init=torch.where(found[..., None], est, s.lms_init),
                     lms_sol=torch.where(found[..., None], est, s.lms_sol))


def update(cfg, s: PoseGraphState, cmd: torch.Tensor, meas: Measurements,
           tick=None) -> PoseGraphState:
    """One graph-building tick (pose_graph.cpp:199-271), without the solve.

    ``tick``: the tick index, the same in every world (default: world 0's
    timestep). The last tick (tick + 1 == cfg.num_iterations) adds nothing:
    the reference solves there instead. Otherwise the between-factor of
    ``cmd`` (B, 2) and a node seeded from the secondary's pose are added,
    the tick's measurements resolved to landmark slots (a new id takes the
    next slot and seeds its position from the secondary's pose; one that
    arrives when the slot table is full is dropped) and their factors
    attached to the new node. The tick's rows are written into ``s``'s
    graph tensors in place, as the JAX scan updates its buffers; the state
    returned shares them.
    """
    t = int(s.timestep[0]) if tick is None else int(tick)
    if t + 1 >= cfg.num_iterations:
        return s.replace(timestep=torch.full_like(s.timestep, t))
    t_new = min(t + 1, s.odom.shape[1])
    s.odom[:, t] = cmd[:, :2]
    s.odom_valid[:, t] = True
    s.poses_init[:, t_new] = s.cur_pose

    # measurements: resolve landmark slots, seed first sightings, add factors
    n_cap = s.ids.shape[1]
    slot_idx = torch.arange(n_cap, device=s.ids.device)[None, :]
    ids, m, lms_init = s.ids, s.M, s.lms_init
    cx, cy, cth = s.cur_pose[:, 0], s.cur_pose[:, 1], s.cur_pose[:, 2]
    rows_rb, rows_lm, rows_valid = [], [], []
    for j in range(meas.ids.shape[1]):
        mid, r, b, valid = meas.ids[:, j], meas.r[:, j], meas.b[:, j], meas.valid[:, j]
        found, first = first_match((ids == mid[:, None]) & (slot_idx < m[:, None]))
        idx = torch.where(found, first, m.long())
        is_new = valid & ~found & (m < n_cap)
        # first sighting: seed the global position from the secondary's
        # pose (pose_graph.cpp:163-169), a one-hot write at slot m
        seed = torch.stack([cx + r * torch.cos(cth + b), cy + r * torch.sin(cth + b)], dim=1)
        put = is_new[:, None] & (slot_idx == m[:, None])
        lms_init = torch.where(put[..., None], seed[:, None, :], lms_init)
        ids = torch.where(put, mid[:, None], ids)
        m = torch.where(is_new, m + 1, m)
        # a never-seen landmark arriving with the table full would bind to
        # slot N: drop it
        at_j = valid & (found | is_new)
        rows_rb.append(torch.where(at_j[:, None], torch.stack([r, b], dim=1), 0.0))
        rows_lm.append(torch.where(at_j, idx, 0))
        rows_valid.append(at_j)
    # the factors attach to the new node t_new; their row is t
    s.meas_rb[:, t] = torch.stack(rows_rb, dim=1)
    s.meas_lm[:, t] = torch.stack(rows_lm, dim=1).to(torch.int32)
    s.meas_valid[:, t] = torch.stack(rows_valid, dim=1)
    return s.replace(ids=ids, M=m, lms_init=lms_init,
                     timestep=torch.full_like(s.timestep, t_new))


def assemble_streams(cfg, est_poses, r, b, vis, cmds) -> PoseGraphState:
    """Build the whole pose graph of every world from full-rollout streams.

    est_poses (B, T, 3): the secondary filter's pose after tick t (the node
    seeds); r, b (B, T, N) noisy range and bearing streams (slot = landmark
    id); vis (B, T, N) bool; cmds (B, T, 2) commanded odometry (the
    between-factor values).

    The graph is the one T per-tick updates would build: the last tick solves
    instead of adding, landmark slots are assigned in first-sighting order
    with same-tick ties broken by ascending id, and first sightings seed from
    the secondary pose at the sighting tick. Needs num_meas_slots >= N.
    """
    t_cap = cfg.num_iterations
    bsz, _, n_cap = vis.shape
    k = cfg.num_meas_slots
    dev = vis.device
    if k < n_cap:
        raise ValueError(
            "assemble_streams needs num_meas_slots >= landmark slots "
            f"(got {k} < {n_cap})"
        )
    if est_poses.shape[1] != t_cap:
        raise ValueError("stream length must equal cfg.num_iterations")
    tidx = torch.arange(t_cap, device=dev)
    live = tidx < t_cap - 1  # the final tick solves instead of adding
    vis_live = vis & live[None, :, None]

    # ---- first-sighting slot assignment; the first sighting as a min over
    # ticks, which no argmax tie rule can change
    first_t = torch.where(vis_live, tidx[None, :, None], t_cap).amin(dim=1)
    order = torch.argsort(first_t, dim=1, stable=True)  # ties -> ascending id
    slot_of_id = torch.argsort(order, dim=1, stable=True)  # its inverse
    m = (first_t < t_cap).sum(dim=1)
    slot_idx = torch.arange(n_cap, device=dev)
    has_slot = slot_idx[None, :] < m[:, None]
    ids = torch.where(has_slot, order, -1).to(torch.int32)

    # ---- landmark seeds: the secondary pose at the first-sighting tick
    tf = first_t.clamp(0, t_cap - 1)
    p_at = torch.gather(est_poses, 1, tf[:, :, None].expand(-1, -1, 3))
    r_at = torch.gather(r, 1, tf[:, None, :])[:, 0]
    b_at = torch.gather(b, 1, tf[:, None, :])[:, 0]
    seed_x = p_at[:, :, 0] + r_at * torch.cos(p_at[:, :, 2] + b_at)
    seed_y = p_at[:, :, 1] + r_at * torch.sin(p_at[:, :, 2] + b_at)
    seeds_by_id = torch.stack([seed_x, seed_y], dim=2)  # (B, N, 2) by id
    lms_init = torch.where(
        has_slot[:, :, None],
        torch.gather(seeds_by_id, 1, order[:, :, None].expand(-1, -1, 2)),
        0.0,
    )

    # ---- node values and odometry
    pose0 = torch.tensor(cfg.init_pose, dtype=torch.float32, device=dev)
    poses_init = torch.cat(
        [pose0.expand(bsz, 1, 3),
         torch.where(live[None, :, None], est_poses, 0.0)], dim=1,
    )  # (B, T+1, 3); the row of the last tick stays zero
    odom = torch.where(live[None, :, None], cmds, 0.0)
    poses_sol = torch.zeros((bsz, t_cap + 1, 3), dtype=torch.float32, device=dev)
    poses_sol[:, 0] = pose0

    # ---- measurement factor tensors (slot j = landmark id j, the
    # simulator's id-order emission; invalid slots zeroed)
    meas_rb = torch.where(vis_live[..., None], torch.stack([r, b], dim=-1), 0.0)
    meas_lm = torch.where(vis_live, slot_of_id[:, None, :], 0).to(torch.int32)
    meas_valid = vis_live
    if k > n_cap:
        def pad(a):  # zero slots n_cap..k-1 on the slot axis
            shape = list(a.shape)
            shape[2] = k - n_cap
            return torch.cat([a, a.new_zeros(shape)], dim=2)

        meas_rb, meas_lm, meas_valid = pad(meas_rb), pad(meas_lm), pad(meas_valid)

    return PoseGraphState(
        poses_init=poses_init,
        lms_init=lms_init,
        odom=odom,
        odom_valid=live.expand(bsz, t_cap),
        meas_rb=meas_rb,
        meas_lm=meas_lm,
        meas_valid=meas_valid,
        ids=ids,
        M=m.to(torch.int32),
        timestep=torch.full((bsz,), t_cap - 1, dtype=torch.int32, device=dev),
        cur_pose=est_poses[:, -1],
        poses_sol=poses_sol,
        lms_sol=torch.zeros((bsz, n_cap, 2), dtype=torch.float32, device=dev),
        solved=torch.zeros(bsz, dtype=torch.bool, device=dev),
    )


class LmSlots:
    """How a graph's measurement slots (B, T, K) map to landmark slots: the
    gather of a per-landmark value to every measurement and the scatter-add
    of per-measurement values to landmarks.

    ``by_column``: in every world, every valid measurement of column j binds
    to one slot (true of graphs from ``assemble_streams``). Then the scatter
    is a sum over ticks and a placement of K column sums, exact and the same
    in every run, and the gather broadcasts over ticks. Invalid measurements
    carry zero coefficients in every caller, so the slot they name is free.
    """

    def __init__(self, s: PoseGraphState, detect: bool = True):
        """``detect=False`` takes the general form without looking at the
        graph (no host synchronisation)."""
        idx = s.meas_lm.long()
        self.n = s.lms_init.shape[1]
        self.shape = tuple(idx.shape)
        self.by_column = False
        if detect:
            col = torch.where(s.meas_valid, idx, 0).amax(dim=1)  # (B, K)
            self.by_column = bool(
                ((idx == col[:, None, :]) | ~s.meas_valid).all())
        if self.by_column:
            self.col = col
            self.onehot = torch.nn.functional.one_hot(col, self.n).to(
                torch.float32)  # (B, K, N)
        else:
            self.flat = idx.reshape(self.shape[0], -1)

    @functools.cached_property
    def index32(self) -> torch.Tensor:
        """The map as the Schur matvec kernel reads it: (B, K) or (B, T K)."""
        return (self.col if self.by_column else self.flat).to(
            torch.int32).contiguous()

    def per_measurement(self) -> torch.Tensor:
        """Each measurement's slot, (B, T, K) int64."""
        if self.by_column:
            return self.col[:, None, :].expand(self.shape)
        return self.flat.reshape(self.shape)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """v (B, N) -> v at each measurement's slot, (B, T, K) or, by
        column, its broadcastable (B, 1, K)."""
        if self.by_column:
            return torch.gather(v, 1, self.col)[:, None, :]
        return torch.gather(v, 1, self.flat).reshape(self.shape)

    def scatter(self, vals: torch.Tensor) -> torch.Tensor:
        """vals (B, T, K) summed into their landmark slots, (B, N)."""
        if self.by_column:
            return (vals.sum(dim=1)[:, :, None] * self.onehot).sum(dim=1)
        out = torch.zeros((self.shape[0], self.n), dtype=vals.dtype,
                          device=vals.device)
        return out.scatter_add_(1, self.flat, vals.reshape(self.shape[0], -1))


# ----------------------------------------------------------------------
# Residuals, Jacobians, gradient
# ----------------------------------------------------------------------

def _prior_sigmas(cfg, device=None) -> torch.Tensor:
    """Pose-0 anchor sigmas: the reference's (1.3, 1.3, 1.2) in compat mode,
    the true initialisation uncertainty in honest mode."""
    pg = cfg.pose_graph
    sig = (pg.prior_sigmas if cfg.compat.pg_variances_as_sigmas
           else pg.prior_sigmas_honest)
    return torch.tensor(sig, dtype=torch.float32, device=device)


def _noise_sigmas(cfg, meas_scale: float = 1.0):
    (v00, v11), (w00, w11) = cfg.filter_noise()
    if cfg.compat.pg_variances_as_sigmas:
        # GTSAM models are built from variances passed as sigmas
        odom_s = (v00, v00, v11)
        meas_s = (w11, w00)  # (bearing, range)
    else:
        # honest model of the simulator's noise: U(-V, V) has std V/sqrt(3);
        # the unicycle has no lateral slip, so the lateral sigma is a small
        # regulariser
        odom_s = (v00 / S3, 1e-3, v11 / S3)
        meas_s = (w11 / S3, w00 / S3)
    meas_s = (meas_s[0] * meas_scale, meas_s[1] * meas_scale)
    return odom_s, meas_s


def _odom_moments(cfg, odom: torch.Tensor):
    """Clip-aware per-tick odometry moments (honest mode): the simulator
    clips the noisy command, so a saturated tick is biased toward the
    interior and less noisy than U(-V, V). Returns (eff (B, T, 2) expected
    executed [fwd, hdg], sig (B, T, 3) residual sigmas [fwd, lateral, hdg]).
    Compat mode returns the reference's factors: raw commands,
    variance-as-sigma scalars."""
    (v00, v11), _ = cfg.filter_noise()
    if cfg.compat.pg_variances_as_sigmas:
        sig = torch.tensor([v00, v00, v11], dtype=torch.float32,
                           device=odom.device)
        return odom, sig.expand(*odom.shape[:-1], 3)
    v_fwd = cfg.process_noise.V_00
    v_hdg = cfg.process_noise.V_11
    if v_fwd > 0.0:
        eff_d, sig_d = clip_uniform_moments(
            odom[..., 0], v_fwd, 0.0, cfg.constraints.commands.d_max
        )
        # a fully saturated tick has std -> 0; floor at 10% of the unclipped
        # std so that no factor becomes near-infinitely stiff
        sig_d = torch.clamp_min(sig_d, 0.1 * v_fwd / S3)
    else:
        eff_d, sig_d = odom[..., 0], torch.full_like(odom[..., 0], 1e-6)
    th_max = cfg.constraints.commands.th_max
    if v_hdg > 0.0:
        eff_th, sig_th = clip_uniform_moments(
            odom[..., 1], v_hdg, -th_max, th_max
        )
        sig_th = torch.clamp_min(sig_th, 0.1 * v_hdg / S3)
    else:
        eff_th, sig_th = odom[..., 1], torch.full_like(odom[..., 1], 1e-6)
    sig_lat = torch.full_like(sig_d, 1e-3)
    eff = torch.stack([eff_d, eff_th], dim=-1)
    sig = torch.stack([sig_d, sig_lat, sig_th], dim=-1)
    return eff, sig


def _logmap_vinv(th: torch.Tensor):
    """V(theta)^-1 of the SE(2) log map as (a, b), V^-1 = [[a, b], [-b, a]],
    with Taylor fallbacks below 1e-4."""
    small = th.abs() < 1e-4
    th_safe = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0 - _div(th * th, 6.0), torch.sin(th) / th_safe)
    b = torch.where(
        small, th / 2.0 - _div(th ** 3, 24.0), (1.0 - torch.cos(th)) / th_safe
    )
    den = a * a + b * b
    return a / den, b / den


def _residuals(cfg, s: PoseGraphState, poses, lms, meas_scale=1.0, slots=None,
               moments=None):
    """All whitened residuals and masks, vectorised over factors: r_prior
    (B, 3), r_odom (B, T, 3), r_meas (B, T, K, 2) in (bearing, range) order,
    rng_safe and the masked geometry (mdx, mdy), each (B, T, K).
    ``moments``: ``_odom_moments(cfg, s.odom)``, made by the caller."""
    slots = slots or LmSlots(s, detect=False)
    odom_eff, odom_sig = moments or _odom_moments(cfg, s.odom)
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    prior_s = _prior_sigmas(cfg, poses.device)

    # prior on pose 0
    p0 = s.poses_init[:, 0]
    r_prior = torch.cat(
        [poses[:, 0, :2] - p0[:, :2],
         wrap_angle(poses[:, 0, 2] - p0[:, 2])[:, None]], dim=1,
    ) / prior_s

    # odometry between-factors t -> t+1
    pa = poses[:, :-1]
    pb = poses[:, 1:]
    ca, sa = torch.cos(pa[..., 2]), torch.sin(pa[..., 2])
    dx = pb[..., 0] - pa[..., 0]
    dy = pb[..., 1] - pa[..., 1]
    lx = ca * dx + sa * dy
    ly = -sa * dx + ca * dy
    lth = wrap_angle(pb[..., 2] - pa[..., 2])
    if cfg.pose_graph.exact_logmap:
        # GTSAM Pose2 between-factor error: Logmap(measured^-1 (pa^-1 pb))
        m_th = odom_eff[..., 1]
        cm, sm = torch.cos(m_th), torch.sin(m_th)
        ex_ = lx - odom_eff[..., 0]
        ey_ = ly  # the measured y component is 0
        rx = cm * ex_ + sm * ey_
        ry = -sm * ex_ + cm * ey_
        rth = wrap_angle(lth - m_th)
        va, vb = _logmap_vinv(rth)
        r_odom = torch.stack(
            [(va * rx + vb * ry) / odom_sig[..., 0],
             (-vb * rx + va * ry) / odom_sig[..., 1],
             rth / odom_sig[..., 2]], dim=-1,
        )
    else:
        # local-coordinates approximation (difference in pose a's frame)
        r_odom = torch.stack(
            [(lx - odom_eff[..., 0]) / odom_sig[..., 0],
             (ly - 0.0) / odom_sig[..., 1],
             wrap_angle(lth - odom_eff[..., 1]) / odom_sig[..., 2]], dim=-1,
        )
    r_odom = torch.where(s.odom_valid[..., None], r_odom, 0.0)

    # bearing-range factors: the measurement at row t attaches to pose t+1
    pt = poses[:, 1:, None, :]  # (B, T, 1, 3)
    # double where: masked slots get unit geometry BEFORE sqrt and atan2, so
    # that they stay finite
    mdx = torch.where(s.meas_valid, slots.gather(lms[..., 0]) - pt[..., 0], 1.0)
    mdy = torch.where(s.meas_valid, slots.gather(lms[..., 1]) - pt[..., 1], 0.0)
    rng = torch.sqrt(mdx * mdx + mdy * mdy)
    rng_safe = torch.where(rng > 0, rng, 1.0)
    brg = wrap_angle(torch.atan2(mdy, mdx) - pt[..., 2])
    r_meas = torch.stack(
        [_div(wrap_angle(brg - s.meas_rb[..., 1]), meas_s[0]),
         _div(rng - s.meas_rb[..., 0], meas_s[1])], dim=-1,
    )
    r_meas = torch.where(s.meas_valid[..., None], r_meas, 0.0)
    return r_prior, r_odom, r_meas, rng_safe, (mdx, mdy)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each world's inner product of two arrays, (B,)."""
    return (a * b).reshape(a.shape[0], -1).sum(dim=1)


def graph_error(cfg, s: PoseGraphState, poses, lms, meas_scale=1.0,
                slots=None, res=None) -> torch.Tensor:
    """0.5 * sum of squared whitened residuals of each world, (B,)."""
    r_prior, r_odom, r_meas, _, _ = res or _residuals(
        cfg, s, poses, lms, meas_scale, slots)
    return 0.5 * (_dot(r_prior, r_prior) + _dot(r_odom, r_odom)
                  + _dot(r_meas, r_meas))


def _jacobians(cfg, s: PoseGraphState, poses, lms, meas_scale=1.0, slots=None,
               res=None, moments=None) -> dict:
    """Whitened prior and odometry Jacobians with the residuals (``res``: a
    ``_residuals`` result for these arguments, to save computing it again;
    ``moments`` as ``_residuals`` takes them).
    ja, jb (B, T, 3, 3): d residual / d pose_t and / d pose_{t+1}."""
    odom_eff, odom_sig = moments or _odom_moments(cfg, s.odom)
    prior_s = _prior_sigmas(cfg, poses.device)
    res = res or _residuals(cfg, s, poses, lms, meas_scale, slots, moments)
    r_prior, r_odom, r_meas, _, _ = res

    pa = poses[:, :-1]
    ca, sa = torch.cos(pa[..., 2]), torch.sin(pa[..., 2])
    dx = poses[:, 1:, 0] - pa[..., 0]
    dy = poses[:, 1:, 1] - pa[..., 1]
    zeros = torch.zeros_like(ca)
    ones = torch.ones_like(ca)
    ja = torch.stack(
        [torch.stack([-ca, -sa, -sa * dx + ca * dy], dim=-1),
         torch.stack([sa, -ca, -ca * dx - sa * dy], dim=-1),
         torch.stack([zeros, zeros, -ones], dim=-1)], dim=-2,
    )
    jb = torch.stack(
        [torch.stack([ca, sa, zeros], dim=-1),
         torch.stack([-sa, ca, zeros], dim=-1),
         torch.stack([zeros, zeros, ones], dim=-1)], dim=-2,
    )
    if cfg.pose_graph.exact_logmap:
        # the translation rows pick up M2 = V^-1(rel_th) R(-m_th); the
        # d(V^-1)/d(th) terms are proportional to the residual and dropped
        # (the Gauss-Newton small-residual approximation)
        m_th = odom_eff[..., 1]
        cm, sm = torch.cos(m_th), torch.sin(m_th)
        lth = wrap_angle(poses[:, 1:, 2] - pa[..., 2])
        va, vb = _logmap_vinv(wrap_angle(lth - m_th))
        m2 = torch.stack(
            [torch.stack([va * cm - vb * sm, va * sm + vb * cm], dim=-1),
             torch.stack([-vb * cm - va * sm, -vb * sm + va * cm], dim=-1)],
            dim=-2,
        )  # (B, T, 2, 2)

        def rotate(j):
            top = (m2[..., :, 0:1] * j[..., 0:1, :]
                   + m2[..., :, 1:2] * j[..., 1:2, :])
            return torch.cat([top, j[..., 2:, :]], dim=-2)

        ja, jb = rotate(ja), rotate(jb)
    inv_od = 1.0 / odom_sig  # per-tick whitening (clip-aware)
    mask_od = s.odom_valid[..., None, None].to(torch.float32)
    ja = ja * inv_od[..., :, None] * mask_od
    jb = jb * inv_od[..., :, None] * mask_od
    t_cap = s.odom.shape[1]
    n_cap = s.lms_init.shape[1]
    dev = poses.device
    return {
        "inv_pr": 1.0 / prior_s,
        "r_prior": r_prior,
        "ja": ja,
        "jb": jb,
        "r_odom": r_odom,
        # the (B, T, K, 2, 5) bearing-range Jacobian, made on demand (the
        # dense assembly needs it; the matrix-free paths use _meas_coeffs)
        "make_jm": lambda: _meas_jacobian(cfg, s, res, meas_scale),
        "r_meas": r_meas,
        "p0": s.poses_init[:, 0],
        "pose_active": torch.arange(t_cap + 1, device=dev)[None] <= s.timestep[:, None],
        "lm_active": torch.arange(n_cap, device=dev)[None] < s.M[:, None],
    }


def _meas_jacobian(cfg, s: PoseGraphState, res, meas_scale) -> torch.Tensor:
    """Whitened bearing-range Jacobians (B, T, K, 2, 5) from a ``_residuals``
    result: rows (bearing, range), columns (px, py, pth, lx, ly); zero
    where invalid."""
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    _, _, _, rng_safe, (mdx, mdy) = res
    r2 = rng_safe * rng_safe
    jm = torch.stack(
        [_div(torch.stack([mdy / r2, -mdx / r2, -torch.ones_like(rng_safe),
                           -mdy / r2, mdx / r2], dim=-1), meas_s[0]),
         _div(torch.stack([-mdx / rng_safe, -mdy / rng_safe,
                           torch.zeros_like(rng_safe), mdx / rng_safe,
                           mdy / rng_safe], dim=-1), meas_s[1])], dim=-2,
    )
    return jm * s.meas_valid.to(torch.float32)[..., None, None]


def _meas_coeffs(cfg, s: PoseGraphState, poses, lms, meas_scale, slots=None,
                 res=None):
    """Bearing-range Jacobian rows as five (B, T, K) coefficient arrays.

    rows (whitened): bearing = [ab, bb, cb, -ab, -bb],
                     range   = [ar, br,  0, -ar, -br]
    over the variables (px, py, pth, lx, ly); zero where invalid.
    """
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    _, _, r_meas, rng_safe, (mdx, mdy) = res or _residuals(
        cfg, s, poses, lms, meas_scale, slots)
    valid = s.meas_valid.to(torch.float32)
    r2 = rng_safe * rng_safe
    ab = _div(mdy / r2, meas_s[0]) * valid
    bb = _div(-mdx / r2, meas_s[0]) * valid
    cb = _div(-torch.ones_like(valid), meas_s[0]) * valid
    ar = _div(-mdx / rng_safe, meas_s[1]) * valid
    br = _div(-mdy / rng_safe, meas_s[1]) * valid
    return (ab, bb, cb, ar, br), r_meas


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., r, i) matrix times (..., i) vector, in float32 elementwise ops
    (no library product: its precision mode and order are the caller's)."""
    return (m * v[..., None, :]).sum(dim=-1)


def _mtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Transposed (..., r, i) matrix times (..., r) vector."""
    return (m * v[..., :, None]).sum(dim=-2)


def _mtm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b for (..., r, i) and (..., r, j) -> (..., i, j)."""
    return (a[..., :, :, None] * b[..., :, None, :]).sum(dim=-3)


def _meas_back(slots: LmSlots, coeffs, u_b, u_r, op, ol):
    """Accumulate J_meas^T u into the pose (B, T+1, 3) and landmark (B, N, 2)
    blocks (in place: both belong to the caller)."""
    ab, bb, cb, ar, br = coeffs
    px = ab * u_b + ar * u_r  # (B, T, K)
    py = bb * u_b + br * u_r
    pth = cb * u_b
    op[:, 1:] += torch.stack([px.sum(dim=2), py.sum(dim=2), pth.sum(dim=2)], dim=-1)
    ol += torch.stack([slots.scatter(-px), slots.scatter(-py)], dim=-1)
    return op, ol


def _zeros_like_graph(s: PoseGraphState):
    bsz, t_cap = s.odom.shape[:2]
    kw = dict(dtype=torch.float32, device=s.odom.device)
    return (torch.zeros((bsz, t_cap + 1, 3), **kw),
            torch.zeros((bsz, s.lms_init.shape[1], 2), **kw))


def _grad(cfg, s: PoseGraphState, jac, coeffs, r_meas, slots=None):
    """g = -J^T r as pose (B, T+1, 3) and landmark (B, N, 2) blocks."""
    slots = slots or LmSlots(s, detect=False)
    gp, gl = _zeros_like_graph(s)
    gp[:, 0] += -jac["inv_pr"] * jac["r_prior"]
    gp[:, :-1] += -_mtv(jac["ja"], jac["r_odom"])
    gp[:, 1:] += -_mtv(jac["jb"], jac["r_odom"])
    return _meas_back(slots, coeffs, -r_meas[..., 0], -r_meas[..., 1], gp, gl)


def _hv(s: PoseGraphState, jac, coeffs, vp, vl, slots=None):
    """Matrix-free H v = J^T (J v), H the Gauss-Newton Hessian."""
    slots = slots or LmSlots(s, detect=False)
    op, ol = _zeros_like_graph(s)
    op[:, 0] += jac["inv_pr"] ** 2 * vp[:, 0]
    # odometry: u = Ja v_t + Jb v_{t+1}
    u = _mv(jac["ja"], vp[:, :-1]) + _mv(jac["jb"], vp[:, 1:])
    op[:, :-1] += _mtv(jac["ja"], u)
    op[:, 1:] += _mtv(jac["jb"], u)
    # bearing-range: u = J_meas [v_pose(t+1); v_lm]
    ab, bb, cb, ar, br = coeffs
    ex = vp[:, 1:, 0:1] - slots.gather(vl[..., 0])
    ey = vp[:, 1:, 1:2] - slots.gather(vl[..., 1])
    u_b = ab * ex + bb * ey + cb * vp[:, 1:, 2:3]
    u_r = ar * ex + br * ey
    return _meas_back(slots, coeffs, u_b, u_r, op, ol)


def _h_diag(s: PoseGraphState, jac, coeffs, slots=None):
    """diag(J^T J) as pose and landmark blocks (the Jacobi preconditioner)."""
    slots = slots or LmSlots(s, detect=False)
    dp, dl = _zeros_like_graph(s)
    dp[:, 0] += jac["inv_pr"] ** 2
    dp[:, :-1] += (jac["ja"] * jac["ja"]).sum(dim=-2)
    dp[:, 1:] += (jac["jb"] * jac["jb"]).sum(dim=-2)
    ab, bb, cb, ar, br = coeffs
    qx = ab * ab + ar * ar  # (B, T, K)
    qy = bb * bb + br * br
    qth = cb * cb
    dp[:, 1:] += torch.stack([qx.sum(dim=2), qy.sum(dim=2), qth.sum(dim=2)], dim=-1)
    dl += torch.stack([slots.scatter(qx), slots.scatter(qy)], dim=-1)
    return dp, dl


# ----------------------------------------------------------------------
# Bulk solver: Schur-eliminated landmarks, CG on the poses, preconditioned
# by the exact block-tridiagonal chain (block-Thomas)
# ----------------------------------------------------------------------

def _inv3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) blocks by the adjugate (the blocks
    are Jacobi-scaled SPD plus damping: entries O(1), determinant away from
    0); a singular block is divided by 1 instead."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    det = torch.where(det.abs() > 1e-30, det, 1.0)
    adj = torch.stack(
        [torch.stack([c00, c10, c20], dim=-1),
         torch.stack([c01, c11, c21], dim=-1),
         torch.stack([c02, c12, c22], dim=-1)], dim=-2,
    )
    return adj / det[..., None, None]


def _pose_blocks(cfg, s: PoseGraphState, jac, coeffs, damping):
    """Block-tridiagonal pose part of the GN Hessian: diagonal blocks d
    (B, T+1, 3, 3) and couplings u (B, T, 3, 3) between consecutive nodes
    (the prior on node 0; between-factors couple t and t+1; bearing-range
    factors are unary on pose t+1). Damped (``damping`` a float or (B,)),
    inactive nodes pinned. Returns (d, u, active (B, T+1) float)."""
    bsz, t_cap = s.odom.shape[:2]
    ja, jb = jac["ja"], jac["jb"]
    i3 = torch.arange(3, device=ja.device)
    d = torch.zeros((bsz, t_cap + 1, 3, 3), dtype=torch.float32, device=ja.device)
    d[:, 0, i3, i3] += jac["inv_pr"] ** 2
    d[:, :-1] += _mtm(ja, ja)
    d[:, 1:] += _mtm(jb, jb)
    ab, bb, cb, ar, br = coeffs  # whitened, already masked by validity
    hxx = (ab * ab + ar * ar).sum(dim=2)
    hxy = (ab * bb + ar * br).sum(dim=2)
    hxt = (ab * cb).sum(dim=2)
    hyy = (bb * bb + br * br).sum(dim=2)
    hyt = (bb * cb).sum(dim=2)
    htt = (cb * cb).sum(dim=2)
    d[:, 1:] += torch.stack(
        [torch.stack([hxx, hxy, hxt], dim=-1),
         torch.stack([hxy, hyy, hyt], dim=-1),
         torch.stack([hxt, hyt, htt], dim=-1)], dim=-2,
    )
    u = _mtm(ja, jb)  # coupling block (t, t+1)

    active = jac["pose_active"].to(torch.float32)  # (B, T+1)
    diag = torch.diagonal(d, dim1=2, dim2=3)
    damping = torch.as_tensor(damping, dtype=torch.float32, device=ja.device)
    d[:, :, i3, i3] += (damping.reshape(-1, 1, 1) * diag
                        + (1.0 - active[:, :, None]))
    return d, u, active


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) a b, summed in index order k = 0, 1, 2 (the kernels')."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _mv3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) a times (..., 3) v, summed in index order."""
    return (a[..., :, 0] * v[..., 0:1] + a[..., :, 1] * v[..., 1:2]
            + a[..., :, 2] * v[..., 2:3])


def _check_blocks(name, t, shape, dev):
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected float32 {shape} on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _tridiag_factor(d: torch.Tensor, u: torch.Tensor) -> dict:
    """Block-Thomas (block-LDL) factorisation of SPD block-tridiagonal
    systems, d (B, T+1, 3, 3), u (B, T, 3, 3). Jacobi block scaling keeps
    the recursion O(1) in float32 (raw whitened entries reach ~1e7). Returns
    the reusable factor {"sinv" (B, T+1, 3, 3), "l" (B, T, 3, 3), "u" (the
    scaled couplings), "dsc" (B, T+1, 3)} for ``_tridiag_solve``. On CUDA
    tensors one launch of ``csrc/block_thomas.cu``; on the CPU the plain
    loop."""
    dev = d.device
    if dev.type == "cpu":
        return _tridiag_factor_reference(d, u)
    if dev.type != "cuda":
        raise ValueError(f"_tridiag_factor runs on cpu or cuda, not {dev}")
    if d.dim() != 4:
        raise ValueError(f"d must be (B, T+1, 3, 3), got {tuple(d.shape)}")
    bsz, t1 = d.shape[:2]
    _check_blocks("d", d, (bsz, t1, 3, 3), dev)
    _check_blocks("u", u, (bsz, t1 - 1, 3, 3), dev)
    d, u = d.contiguous(), u.contiguous()
    fac = {"sinv": torch.empty_like(d), "l": torch.empty_like(u),
           "u": torch.empty_like(u),
           "dsc": torch.empty((bsz, t1, 3), dtype=torch.float32, device=dev)}
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.les_block_thomas_factor(
            d.data_ptr(), u.data_ptr(), bsz, t1 - 1, fac["sinv"].data_ptr(),
            fac["l"].data_ptr(), fac["u"].data_ptr(), fac["dsc"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "block-Thomas factor kernel")
    launches["factor"] += 1
    return fac


def _tridiag_solve(fac: dict, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for rhs (B, T+1, 3): forward, then back
    substitution, each chain split into SOLVE_SEGMENTS segments joined by a
    scan. On CUDA tensors one launch of ``csrc/block_thomas.cu``; on the CPU
    its plain version, the same algorithm."""
    dev = rhs.device
    if dev.type == "cpu":
        return _tridiag_solve_reference(fac, rhs)
    if dev.type != "cuda":
        raise ValueError(f"_tridiag_solve runs on cpu or cuda, not {dev}")
    bsz, t1 = fac["dsc"].shape[:2]
    _check_blocks("rhs", rhs, (bsz, t1, 3), dev)
    _check_blocks("sinv", fac["sinv"], (bsz, t1, 3, 3), dev)
    for key in ("l", "u"):
        _check_blocks(key, fac[key], (bsz, t1 - 1, 3, 3), dev)
    for key in ("sinv", "l", "u", "dsc"):
        if not fac[key].is_contiguous():
            raise ValueError(f"factor[{key!r}] must be contiguous")
    rhs = rhs.contiguous()
    x = torch.empty_like(rhs)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.les_block_thomas_solve(
            fac["sinv"].data_ptr(), fac["l"].data_ptr(), fac["u"].data_ptr(),
            fac["dsc"].data_ptr(), rhs.data_ptr(), bsz, t1 - 1, x.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "block-Thomas solve kernel")
    launches["solve"] += 1
    return x


# the factor kernel's phases, as its -DLES_PHASE_CLOCKS build counts them:
# node 0 and each chunk's dsc and scaled blocks; issuing the next chunk's
# copies and waiting for this one's; the recursion; the results' stores
FACTOR_PHASES = ("scale", "stage", "walk", "store")
# the solve kernel's phases, the same
SOLVE_PHASES = ("stage_fwd", "compose_fwd", "scan_fwd", "replay_fwd",
                "stage_back", "compose_back", "scan_back", "replay_back",
                "store")


def solve_phase_clocks(fac: dict, rhs: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One solve on the card in the build that counts cycles by phase
    (``_build.PHASE_CLOCKS``): the clock64() cycles of each phase of
    ``SOLVE_PHASES``, thread 0 of every world summed, and x."""
    def launch():
        x = _tridiag_solve(fac, rhs)
        torch.cuda.synchronize(rhs.device)
        return x
    return _build.phase_cycles("les_block_thomas_phase_clocks", SOLVE_PHASES, launch)


def factor_phase_clocks(d: torch.Tensor, u: torch.Tensor) -> tuple[dict, dict]:
    """One factor on the card in the build that counts cycles by phase: the
    clock64() cycles of each phase of ``FACTOR_PHASES``, lane 0 of every
    world summed, and the factor."""
    def launch():
        fac = _tridiag_factor(d, u)
        torch.cuda.synchronize(d.device)
        return fac
    return _build.phase_cycles("les_block_thomas_factor_phase_clocks",
                               FACTOR_PHASES, launch)


def solve_occupancy(steps: int) -> dict:
    """The solve kernel's launch at ``steps`` as the card takes it
    (``_build.occupancy``)."""
    return _build.occupancy("les_block_thomas_occupancy", steps)


def _tridiag_factor_reference(d: torch.Tensor, u: torch.Tensor) -> dict:
    """The plain version of the factor kernel: a loop over t on (B, 3, 3)
    tensors, in the kernel's order of operations."""
    dsc = torch.rsqrt(torch.clamp_min(torch.diagonal(d, dim1=2, dim2=3), 1e-12))
    d_s = d * dsc[:, :, :, None] * dsc[:, :, None, :]
    u_s = u * dsc[:, :-1, :, None] * dsc[:, 1:, None, :]
    t_cap = u.shape[1]
    sinv = torch.empty_like(d)
    l_all = torch.empty_like(u)
    s_t = d_s[:, 0]
    for t in range(t_cap):
        sinv[:, t] = _inv3(s_t)
        l_all[:, t] = _mm3(u_s[:, t].transpose(1, 2), sinv[:, t])
        s_t = d_s[:, t + 1] - _mm3(l_all[:, t], u_s[:, t])
    sinv[:, t_cap] = _inv3(s_t)
    return {"sinv": sinv, "l": l_all, "u": u_s, "dsc": dsc}


def _tridiag_solve_sequential(fac: dict, rhs: torch.Tensor) -> torch.Tensor:
    """The solve as one sequential loop over t a pass (the JAX package's
    ``lax.scan``s): the yardstick of the segment scan's accuracy."""
    g_s = rhs * fac["dsc"]
    t_cap = fac["l"].shape[1]
    y = torch.empty_like(g_s)
    y[:, 0] = g_s[:, 0]
    for t in range(t_cap):
        y[:, t + 1] = g_s[:, t + 1] - _mv3(fac["l"][:, t], y[:, t])
    x = torch.empty_like(g_s)
    x[:, t_cap] = _mv3(fac["sinv"][:, t_cap], y[:, t_cap])
    for t in range(t_cap - 1, -1, -1):
        x[:, t] = _mv3(fac["sinv"][:, t],
                       y[:, t] - _mv3(fac["u"][:, t], x[:, t + 1]))
    return x * fac["dsc"]


def _warp_scan(a: torch.Tensor, b: torch.Tensor, up: bool):
    """Inclusive Kogge-Stone scan of the segments' affine maps v -> a v + b,
    a (B, S, 3, 3) and b (B, S, 3), over each warp of 32 segments as the
    solve kernel's shuffles compose them: at distance d = 1, 2, .., 16 lane
    i becomes map_i o map_{i-d} (``up``) or map_i o map_{i+d}, where that
    lane exists. Returns them as (B, W, 32, 3, 3) and (B, W, 32, 3), W warps."""
    a = a.reshape(a.shape[0], -1, 32, 3, 3)
    b = b.reshape(b.shape[0], -1, 32, 3)
    lane = torch.arange(32, device=b.device)
    d = 1
    while d < 32:
        shift, take = (d, lane >= d) if up else (-d, lane + d < 32)
        ao, bo = torch.roll(a, shift, dims=2), torch.roll(b, shift, dims=2)
        a, b = (torch.where(take[:, None, None], _mm3(a, ao), a),
                torch.where(take[:, None], _mv3(a, bo) + b, b))
        d *= 2
    return a, b


def _tridiag_solve_reference(fac: dict, rhs: torch.Tensor,
                             segments: int = SOLVE_SEGMENTS) -> torch.Tensor:
    """The plain version of the solve kernel, in its order of operations:
    the T steps of each pass in ``segments`` segments of L = ceil(T /
    segments) consecutive steps (a dimension here, a thread there; past the
    end, empty). A pass composes each segment's map from the identity, step
    by step in its direction; scans the maps over each warp of 32 segments;
    carries the pass's first value through the warps' maps in order; gives
    each segment its first value; replays its steps from it. Forward y_{k+1}
    = g_{k+1} - l_k y_k from y_0 = g_0; back x_k = sinv_k (y_k - us_k
    x_{k+1}) from x_T = sinv_T y_T, y_T being the last segment's replay."""
    if segments <= 0 or segments % 32:
        raise ValueError(f"segments must be a positive multiple of 32, got {segments}")
    g = rhs * fac["dsc"]
    bsz, t_cap, dev = g.shape[0], fac["l"].shape[1], g.device
    n_w, seg = segments // 32, -(-t_cap // segments)
    k = (torch.arange(segments, device=dev)[:, None] * seg
         + torch.arange(seg, device=dev))                  # (S, L) step index
    live = (k < t_cap)[:, :, None]                         # (S, L, 1)
    kc = k.clamp(max=max(t_cap - 1, 0))
    l_k, si_k, us_k = fac["l"][:, kc], fac["sinv"][:, kc], fac["u"][:, kc]
    g_k1 = g[:, kc + 1]                                    # (B, S, L, 3)
    eye = torch.eye(3, dtype=g.dtype, device=dev).expand(bsz, segments, 3, 3)
    zero = g.new_zeros(bsz, segments, 3)

    # ---- forward
    a, b = eye, zero
    for j in range(seg):
        on = live[:, j]
        a = torch.where(on[..., None], -_mm3(l_k[:, :, j], a), a)
        b = torch.where(on, g_k1[:, :, j] - _mv3(l_k[:, :, j], b), b)
    a, b = _warp_scan(a, b, True)
    w = [g[:, 0]]                       # the value each warp starts from
    for i in range(1, n_w):
        w.append(_mv3(a[:, i - 1, 31], w[-1]) + b[:, i - 1, 31])
    w = torch.stack(w, 1)[:, :, None]   # (B, W, 1, 3)
    end = _mv3(a, w) + b
    v = torch.cat([w, end[:, :, :-1]], 2).reshape(bsz, segments, 3)
    ys = []
    for j in range(seg):
        ys.append(v)
        v = torch.where(live[:, j], g_k1[:, :, j] - _mv3(l_k[:, :, j], v), v)
    y_t = v[:, (t_cap - 1) // seg] if t_cap else g[:, 0]

    # ---- back
    x_t = _mv3(fac["sinv"][:, t_cap], y_t)
    a, b = eye, zero
    for j in reversed(range(seg)):
        on = live[:, j]
        b_new = _mv3(si_k[:, :, j], ys[j] - _mv3(us_k[:, :, j], b))
        a = torch.where(on[..., None], -_mm3(si_k[:, :, j], _mm3(us_k[:, :, j], a)), a)
        b = torch.where(on, b_new, b)
    a, b = _warp_scan(a, b, False)
    w = [x_t]                           # the value each warp ends on
    for i in range(n_w - 2, -1, -1):
        w.insert(0, _mv3(a[:, i + 1, 0], w[0]) + b[:, i + 1, 0])
    w = torch.stack(w, 1)[:, :, None]
    end = _mv3(a, w) + b
    v = torch.cat([end[:, :, 1:], w], 2).reshape(bsz, segments, 3)
    xs = [None] * seg
    for j in reversed(range(seg)):
        v = torch.where(live[:, j], _mv3(si_k[:, :, j], ys[j] - _mv3(us_k[:, :, j], v)), v)
        xs[j] = v
    x = (torch.stack(xs, 2).reshape(bsz, segments * seg, 3)[:, :t_cap] if seg
         else g.new_empty(bsz, 0, 3))
    return torch.cat([x, x_t[:, None]], 1) * fac["dsc"]


def _lm_hessian_inv(cfg, s: PoseGraphState, jac, coeffs, damping, slots=None):
    """Per-landmark 2x2 GN Hessian blocks H_ll, inverted (landmarks are
    independent given the poses): (inv (B, N, 3) as [xx, xy, yy], active)."""
    slots = slots or LmSlots(s, detect=False)
    ab, bb, cb, ar, br = coeffs
    hxx = slots.scatter(ab * ab + ar * ar)
    hxy = slots.scatter(ab * bb + ar * br)
    hyy = slots.scatter(bb * bb + br * br)
    active = jac["lm_active"].to(torch.float32)
    damping = torch.as_tensor(damping, dtype=torch.float32, device=hxx.device)
    damp = (1.0 + damping).reshape(-1, 1)
    hxx = hxx * damp + (1.0 - active) + 1e-12
    hyy = hyy * damp + (1.0 - active) + 1e-12
    det = hxx * hyy - hxy * hxy
    det = torch.where(det.abs() > 1e-30, det, 1.0)
    return torch.stack([hyy / det, -hxy / det, hxx / det], dim=2), active


def _hll_inv_apply(hll_inv, w):
    """(B, N, 2) -> (B, N, 2): apply the per-landmark 2x2 inverse."""
    return torch.stack(
        [hll_inv[..., 0] * w[..., 0] + hll_inv[..., 1] * w[..., 1],
         hll_inv[..., 1] * w[..., 0] + hll_inv[..., 2] * w[..., 1]], dim=-1,
    )


def _hpl_t_apply(s: PoseGraphState, coeffs, vp, slots=None):
    """w_l = H_pl^T v_p: per measurement u = J_pose v_pose(t+1), then
    J_lm^T u summed per landmark. (B, T+1, 3) -> (B, N, 2)."""
    slots = slots or LmSlots(s, detect=False)
    ab, bb, cb, ar, br = coeffs
    vx, vy, vt = vp[:, 1:, 0:1], vp[:, 1:, 1:2], vp[:, 1:, 2:3]
    u_b = ab * vx + bb * vy + cb * vt
    u_r = ar * vx + br * vy
    return torch.stack(
        [slots.scatter(-(ab * u_b + ar * u_r)),
         slots.scatter(-(bb * u_b + br * u_r))], dim=-1,
    )


def _hpl_apply(s: PoseGraphState, coeffs, vl, slots=None):
    """y_p = H_pl v_l: per measurement u = J_lm v_lm, then J_pose^T u summed
    per pose row. (B, N, 2) -> (B, T+1, 3)."""
    slots = slots or LmSlots(s, detect=False)
    ab, bb, cb, ar, br = coeffs
    vlx, vly = slots.gather(vl[..., 0]), slots.gather(vl[..., 1])
    u_b = -(ab * vlx + bb * vly)
    u_r = -(ar * vlx + br * vly)
    yp = vl.new_zeros((vl.shape[0], ab.shape[1] + 1, 3))
    yp[:, 1:] += torch.stack(
        [(ab * u_b + ar * u_r).sum(dim=2),
         (bb * u_b + br * u_r).sum(dim=2),
         (cb * u_b).sum(dim=2)], dim=-1,
    )
    return yp


def _schur_mv(d, u, hll_inv, coeffs, slots: LmSlots, vp):
    """S vp = (chain + unary measurement blocks) vp - H_pl H_ll^-1 H_pl^T vp,
    the reduced pose system's matvec: d (B, T+1, 3, 3), u (B, T, 3, 3),
    hll_inv (B, N, 3), coeffs the five (B, T, K) arrays, vp (B, T+1, 3). On
    CUDA tensors one launch of ``csrc/schur_mv.cu``; on the CPU its plain
    version, the same order of sums."""
    dev = vp.device
    if dev.type == "cpu":
        return _schur_mv_reference(d, u, hll_inv, coeffs, slots, vp)
    if dev.type != "cuda":
        raise ValueError(f"_schur_mv runs on cpu or cuda, not {dev}")
    if vp.dim() != 3:
        raise ValueError(f"vp must be (B, T+1, 3), got {tuple(vp.shape)}")
    bsz, t1 = vp.shape[:2]
    t_cap, k_cap, n_cap = t1 - 1, slots.shape[2], slots.n
    if slots.shape != (bsz, t_cap, k_cap):
        raise ValueError(f"the slot map is for {slots.shape}, vp for B={bsz}, T={t_cap}")
    _check_blocks("vp", vp, (bsz, t1, 3), dev)
    _check_blocks("d", d, (bsz, t1, 3, 3), dev)
    _check_blocks("u", u, (bsz, t_cap, 3, 3), dev)
    _check_blocks("hll_inv", hll_inv, (bsz, n_cap, 3), dev)
    for name, c in zip("ab bb cb ar br".split(), coeffs):
        _check_blocks(name, c, (bsz, t_cap, k_cap), dev)
    index = slots.index32
    if index.device != dev:
        raise ValueError(f"the slot map lies on {index.device}, vp on {dev}")
    d, u, hll_inv, vp = (a.contiguous() for a in (d, u, hll_inv, vp))
    coeffs = [c.contiguous() for c in coeffs]
    sp = torch.empty_like(vp)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.les_schur_mv(
            d.data_ptr(), u.data_ptr(), *(c.data_ptr() for c in coeffs),
            hll_inv.data_ptr(), index.data_ptr(), int(slots.by_column),
            vp.data_ptr(), bsz, t_cap, k_cap, n_cap, sp.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "Schur matvec kernel")
    launches["schur_mv"] += 1
    return sp


def schur_mv_occupancy(k_cap: int, n_cap: int) -> dict:
    """The Schur matvec kernel's launch at K measurement slots and N
    landmarks as the card takes it (``_build.occupancy``)."""
    return _build.occupancy("les_schur_mv_occupancy", k_cap, n_cap)


def _schur_mv_reference(d, u, hll_inv, coeffs, slots: LmSlots, vp):
    """The plain version of the Schur matvec kernel, in its order of sums.
    H_pl^T vp: thread p of SCHUR_THREADS (a dimension here) takes
    measurements p, p + SCHUR_THREADS, .. of the flattened (T, K) rows in
    turn and adds each one's two terms to its own partial of the
    measurement's landmark; a halving tree over the threads (level h adds
    partial p + h to p, h = SCHUR_THREADS / 2 .. 1) gives the sums, w =
    H_ll^-1 sums. Then each pose row t + 1 sums its K terms of H_pl w in
    index order from 0, and sp = the chain part (d_t v_t + u_t v_{t+1} +
    u_{t-1}^T v_{t-1}, in that order) less that sum."""
    threads = SCHUR_THREADS
    ab, bb, cb, ar, br = coeffs
    bsz, t_cap, k_cap = ab.shape
    n_cap, tk = slots.n, t_cap * k_cap
    n_it = -(-tk // threads)

    def by_thread(a, fill=0):  # (B, T, K) -> (B, n_it, threads), filled past the end
        a = a.reshape(bsz, tk)
        pad = a.new_full((bsz, n_it * threads - tk), fill)
        return torch.cat([a, pad], 1).reshape(bsz, n_it, threads)

    v1 = vp[:, 1:, None, :].expand(bsz, t_cap, k_cap, 3)
    vx, vy, vt = (by_thread(v1[..., i]) for i in range(3))
    a_, b_, c_, ar_, br_ = (by_thread(c) for c in coeffs)
    idx = by_thread(slots.per_measurement(), -1)
    ub = a_ * vx + b_ * vy + c_ * vt
    ur = ar_ * vx + br_ * vy
    wx = -(a_ * ub + ar_ * ur)
    wy = -(b_ * ub + br_ * ur)
    lm = torch.arange(n_cap, device=vp.device)
    part = vp.new_zeros((bsz, threads, n_cap, 2))
    for i in range(n_it):
        hit = (idx[:, i, :, None] == lm)[..., None]               # (B, P, N, 1)
        val = torch.stack([wx[:, i], wy[:, i]], -1)[:, :, None]  # (B, P, 1, 2)
        part = part + torch.where(hit, val, 0.0)
    h = threads
    while h > 1:
        h //= 2
        part = part[:, :h] + part[:, h:2 * h]
    w = _hll_inv_apply(hll_inv, part[:, 0])                      # (B, N, 2)

    wlx, wly = slots.gather(w[..., 0]), slots.gather(w[..., 1])
    ub = -(ab * wlx + bb * wly)
    ur = -(ar * wlx + br * wly)
    terms = torch.stack([ab * ub + ar * ur, bb * ub + br * ur, cb * ub], -1)
    y = vp.new_zeros((bsz, t_cap, 3))
    for k in range(k_cap):
        y = y + terms[:, :, k]
    hv = _mv3(d, vp)
    hv[:, :-1] = hv[:, :-1] + _mv3(u, vp[:, 1:])
    hv[:, 1:] = hv[:, 1:] + _mv3(u.transpose(-1, -2), vp[:, :-1])
    return torch.cat([hv[:, :1], hv[:, 1:] - y], 1)


def _schur_mv_torch(d, u, hll_inv, coeffs, slots: LmSlots, vp):
    """S v = (chain + unary measurement blocks) v - H_pl H_ll^-1 H_pl^T v as
    torch passes (the matvec solve_schur_pcg ran before the kernel of
    ``csrc/schur_mv.cu``): the yardstick of that kernel's accuracy."""
    hv = _mv(d, vp)
    hv[:, :-1] += _mv(u, vp[:, 1:])
    hv[:, 1:] += _mtv(u, vp[:, :-1])
    w = _hll_inv_apply(hll_inv, _hpl_t_apply(None, coeffs, vp, slots))
    return hv - _hpl_apply(None, coeffs, w, slots)


def _retract(poses, lms, xp, xl, alpha: float):
    pn = poses + alpha * xp
    pn[..., 2] = wrap_angle(pn[..., 2])
    return pn, lms + alpha * xl


def _zero_theta(j: torch.Tensor) -> torch.Tensor:
    """(..., r, 3) Jacobian rows with the heading column set to 0."""
    return torch.cat([j[..., :2], torch.zeros_like(j[..., 2:])], dim=-1)


def _schur_system(cfg, s: PoseGraphState, poses, lms, meas_scale, damping,
                  slots: LmSlots, fix_theta: bool = False, moments=None,
                  work=None) -> dict:
    """What a Gauss-Newton step of ``solve_schur_pcg`` sets up at (poses,
    lms): the damped chain blocks d, u (``_pose_blocks``), the landmark
    inverses hll_inv, the measurement coefficients, the gradient blocks gp
    (unmasked) and gl (masked by the active landmarks), the active masks
    p_active (B, T+1), l_active (B, N) and the reduced right-hand side rhs =
    gp p_active - H_pl H_ll^-1 gl. ``fix_theta`` freezes the headings
    (chordal_init's linear position solve): every heading column of the
    Jacobians is zeroed, so H's heading block vanishes and is pinned to the
    identity, and the heading steps stay exactly 0. ``moments``:
    ``_odom_moments(cfg, s.odom)``, which depends on the graph alone.

    On CUDA tensors one launch of ``csrc/gn_system.cu`` (``_gn_system``;
    ``work`` its buffers for one ``solve_schur_pcg`` call, ``_system_work``);
    on the CPU the torch passes of ``_schur_system_torch``
    (``_schur_system_reference`` is the kernel's order of sums)."""
    moments = moments or _odom_moments(cfg, s.odom)
    dev = poses.device
    if dev.type == "cuda":
        return _gn_system(cfg, s, poses, lms, meas_scale, damping, slots,
                          fix_theta, work or _system_work(s, moments))
    if dev.type != "cpu":
        raise ValueError(f"_schur_system runs on cpu or cuda, not {dev}")
    return _schur_system_torch(cfg, s, poses, lms, meas_scale, damping, slots,
                               fix_theta, moments)


def _schur_system_torch(cfg, s: PoseGraphState, poses, lms, meas_scale, damping,
                        slots: LmSlots, fix_theta: bool = False, moments=None) -> dict:
    """``_schur_system`` as torch passes over the (B, T, K) slots, on any
    device (the system ``solve_schur_pcg`` set up before the kernel of
    ``csrc/gn_system.cu``)."""
    res = _residuals(cfg, s, poses, lms, meas_scale, slots, moments)
    jac = _jacobians(cfg, s, poses, lms, meas_scale, slots, res, moments)
    coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, meas_scale, slots, res)
    if fix_theta:
        jac = dict(jac, ja=_zero_theta(jac["ja"]), jb=_zero_theta(jac["jb"]))
        ab, bb, cb, ar, br = coeffs
        coeffs = (ab, bb, torch.zeros_like(cb), ar, br)
    gp, gl = _grad(cfg, s, jac, coeffs, r_meas, slots)
    if fix_theta:
        gp[..., 2] = 0.0
    d, u, p_active = _pose_blocks(cfg, s, jac, coeffs, damping)
    if fix_theta:
        d[..., 2, 2] += 1.0
    hll_inv, l_active = _lm_hessian_inv(cfg, s, jac, coeffs, damping, slots)
    gl = gl * l_active[:, :, None]
    rhs = gp * p_active[:, :, None] - _hpl_apply(
        s, coeffs, _hll_inv_apply(hll_inv, gl), slots)
    return dict(d=d, u=u, hll_inv=hll_inv, coeffs=coeffs, gp=gp, gl=gl,
                rhs=rhs, p_active=p_active, l_active=l_active)


def _system_work(s: PoseGraphState, moments) -> dict:
    """What every Gauss-Newton step of one ``solve_schur_pcg`` call hands
    the system kernel unchanged: the odometry moments and the graph's masks
    contiguous, and the five coefficient buffers (B, T, K) zeroed once: the
    kernel writes the valid slots only, and the graph's valid slots are the
    same in every step."""
    eff, sig = moments
    coeffs = torch.zeros((5,) + tuple(s.meas_valid.shape), dtype=torch.float32,
                         device=s.meas_valid.device)
    return {"eff": eff.contiguous(), "sig": sig.contiguous(),
            "odom_valid": s.odom_valid.contiguous(),
            "meas_valid": s.meas_valid.contiguous(),
            "coeffs": tuple(coeffs.unbind(0))}


def _gn_system(cfg, s: PoseGraphState, poses, lms, meas_scale, damping,
               slots: LmSlots, fix_theta: bool, work: dict) -> dict:
    """``_schur_system`` on CUDA tensors: one launch of the system kernel
    (``csrc/gn_system.cu``, P3), which writes every output of the torch
    passes, the coefficients into ``work``'s buffers."""
    dev = poses.device
    bsz, t1 = poses.shape[:2]
    t_cap, k_cap, n_cap = t1 - 1, s.meas_valid.shape[2], lms.shape[1]
    if slots.shape != (bsz, t_cap, k_cap) or slots.n != n_cap:
        raise ValueError(f"the slot map is for {slots.shape} and N={slots.n}, "
                         f"the iterate for B={bsz}, T={t_cap}, N={n_cap}")
    _check_blocks("poses", poses, (bsz, t1, 3), dev)
    _check_blocks("lms", lms, (bsz, n_cap, 2), dev)
    _check_blocks("poses_init", s.poses_init, (bsz, t1, 3), dev)
    _check_blocks("eff", work["eff"], (bsz, t_cap, 2), dev)
    _check_blocks("sig", work["sig"], (bsz, t_cap, 3), dev)
    _check_blocks("meas_rb", s.meas_rb, (bsz, t_cap, k_cap, 2), dev)
    for name, c in zip("ab bb cb ar br".split(), work["coeffs"]):
        _check_blocks(name, c, (bsz, t_cap, k_cap), dev)
        if not c.is_contiguous():
            raise ValueError(f"the {name} buffer must be contiguous")
    index = slots.index32
    lam = torch.as_tensor(damping, dtype=torch.float32, device=dev)
    lam = lam.expand(bsz).contiguous() if lam.dim() == 0 else lam.contiguous()
    _check_blocks("damping", lam, (bsz,), dev)
    for name, a in (("odom_valid", work["odom_valid"]), ("meas_valid", work["meas_valid"]),
                    ("slot map", index), ("timestep", s.timestep), ("M", s.M)):
        if a.device != dev:
            raise ValueError(f"the {name} lies on {a.device}, the iterate on {dev}")
    for name in ("odom_valid", "meas_valid"):  # read as bytes
        if work[name].dtype != torch.bool or not work[name].is_contiguous():
            raise ValueError(f"{name} must be a contiguous bool tensor")
    poses, lms, p_init, meas_rb = (a.contiguous() for a in (
        poses, lms, s.poses_init, s.meas_rb))
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"d": torch.empty((bsz, t1, 3, 3), **f32),
           "u": torch.empty((bsz, t_cap, 3, 3), **f32),
           "hll_inv": torch.empty((bsz, n_cap, 3), **f32),
           "gp": torch.empty((bsz, t1, 3), **f32),
           "gl": torch.empty((bsz, n_cap, 2), **f32),
           "rhs": torch.empty((bsz, t1, 3), **f32),
           "p_active": torch.empty((bsz, t1), **f32),
           "l_active": torch.empty((bsz, n_cap), **f32)}
    prior_s = _prior_sigmas(cfg)
    _, meas_s = _noise_sigmas(cfg, meas_scale)
    ts, m = (a.to(torch.int32).contiguous() for a in (s.timestep, s.M))
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.les_gn_system(
            poses.data_ptr(), lms.data_ptr(), p_init.data_ptr(),
            work["eff"].data_ptr(), work["sig"].data_ptr(),
            work["odom_valid"].data_ptr(), meas_rb.data_ptr(),
            work["meas_valid"].data_ptr(), index.data_ptr(), int(slots.by_column),
            ts.data_ptr(), m.data_ptr(), lam.data_ptr(),
            *(float(x) for x in prior_s), float(meas_s[0]), float(meas_s[1]),
            int(cfg.pose_graph.exact_logmap), int(fix_theta),
            bsz, t_cap, k_cap, n_cap,
            out["d"].data_ptr(), out["u"].data_ptr(),
            *(c.data_ptr() for c in work["coeffs"]),
            out["hll_inv"].data_ptr(), out["gp"].data_ptr(), out["gl"].data_ptr(),
            out["rhs"].data_ptr(), out["p_active"].data_ptr(),
            out["l_active"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "Gauss-Newton system kernel")
    _build.count(launches, "system")
    out["coeffs"] = work["coeffs"]
    return out


def system_occupancy(k_cap: int, n_cap: int) -> dict:
    """The system kernel's launch at K measurement slots and N landmarks as
    the card takes it (``_build.occupancy``)."""
    return _build.occupancy("les_gn_system_occupancy", k_cap, n_cap)


def _ksum(valid: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, T, K) a summed over each row's valid slots in index order from 0,
    (B, T): the system kernel's row sums."""
    y = a.new_zeros(a.shape[:2])
    for k in range(a.shape[2]):
        y = torch.where(valid[:, :, k], y + a[:, :, k], y)
    return y


def _schur_system_reference(cfg, s: PoseGraphState, poses, lms, meas_scale,
                            damping, slots: LmSlots, fix_theta: bool = False,
                            moments=None) -> dict:
    """The plain version of the system kernel (``csrc/gn_system.cu``): the
    quantities of ``_schur_system``, elementwise as there, summed in the
    kernel's order. Pose row t (thread t mod SYSTEM_THREADS there) adds, from
    0: the prior (t = 0), its odometry factor t's terms (t < T), factor t-1's
    (t > 0), then the sum over measurement row t-1's valid slots in index
    order from 0. The landmark sums (H_ll's three entries, g_l's two): each
    thread adds the valid measurements of its rows, row by row in order and
    by slot within a row, to its own partial of the measurement's landmark;
    a halving tree over the threads (level h adds partial p + h to p, h =
    SYSTEM_THREADS / 2 .. 1) gives the sums. Then the inverses, g_l masked,
    w = H_ll^-1 g_l, and rhs = gp p_active less each row's sum of H_pl w
    terms over its valid slots in index order."""
    moments = moments or _odom_moments(cfg, s.odom)
    res = _residuals(cfg, s, poses, lms, meas_scale, slots, moments)
    jac = _jacobians(cfg, s, poses, lms, meas_scale, slots, res, moments)
    coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, meas_scale, slots, res)
    ja, jb = jac["ja"], jac["jb"]
    if fix_theta:
        ja, jb = _zero_theta(ja), _zero_theta(jb)
        ab, bb, cb, ar, br = coeffs
        coeffs = (ab, bb, torch.zeros_like(cb), ar, br)
    ab, bb, cb, ar, br = coeffs
    valid = s.meas_valid
    bsz, t_cap, k_cap = valid.shape
    n_cap, dev = lms.shape[1], poses.device
    ub, ur = -r_meas[..., 0], -r_meas[..., 1]
    px, py = ab * ub + ar * ur, bb * ub + br * ur
    hxx, hxy, hyy = ab * ab + ar * ar, ab * bb + ar * br, bb * bb + br * br

    # ---- pose rows: chain blocks, unary measurement blocks, gradient
    i3 = torch.arange(3, device=dev)
    inv_pr = jac["inv_pr"]
    d = poses.new_zeros((bsz, t_cap + 1, 3, 3))
    d[:, 0, i3, i3] = d[:, 0, i3, i3] + inv_pr * inv_pr
    ja_t, jb_t = ja.transpose(-1, -2), jb.transpose(-1, -2)
    d[:, :-1] = d[:, :-1] + _mm3(ja_t, ja)
    d[:, 1:] = d[:, 1:] + _mm3(jb_t, jb)
    sxx, sxy, sxt = _ksum(valid, hxx), _ksum(valid, hxy), _ksum(valid, ab * cb)
    syy, syt, stt = _ksum(valid, hyy), _ksum(valid, bb * cb), _ksum(valid, cb * cb)
    d[:, 1:] = d[:, 1:] + torch.stack(
        [torch.stack([sxx, sxy, sxt], dim=-1),
         torch.stack([sxy, syy, syt], dim=-1),
         torch.stack([sxt, syt, stt], dim=-1)], dim=-2)
    u = _mm3(ja_t, jb)
    p_active = jac["pose_active"].to(torch.float32)
    lam = torch.as_tensor(damping, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    diag = torch.diagonal(d, dim1=2, dim2=3)
    d[:, :, i3, i3] = d[:, :, i3, i3] + (lam * diag + (1.0 - p_active[:, :, None]))
    if fix_theta:
        d[..., 2, 2] = d[..., 2, 2] + 1.0
    gp = poses.new_zeros((bsz, t_cap + 1, 3))
    gp[:, 0] = gp[:, 0] + -inv_pr * jac["r_prior"]
    gp[:, :-1] = gp[:, :-1] + -_mv3(ja_t, jac["r_odom"])
    gp[:, 1:] = gp[:, 1:] + -_mv3(jb_t, jac["r_odom"])
    gp[:, 1:] = gp[:, 1:] + torch.stack(
        [_ksum(valid, px), _ksum(valid, py), _ksum(valid, cb * ub)], dim=-1)
    if fix_theta:
        gp[..., 2] = 0.0

    # ---- landmark sums: thread (t + 1) mod P owns measurement row t
    threads = SYSTEM_THREADS
    n_it = -(-(t_cap + 1) // threads)

    def by_thread(a, fill):  # (B, T, K) -> (B, n_it, P, K) at pose row t + 1
        pad = a.new_full((bsz, n_it * threads, k_cap), fill)
        pad[:, 1:t_cap + 1] = a
        return pad.reshape(bsz, n_it, threads, k_cap)

    idx = by_thread(torch.where(valid, slots.per_measurement(), -1), -1)
    vals = [by_thread(v, 0.0) for v in (hxx, hxy, hyy, -px, -py)]
    lm = torch.arange(n_cap, device=dev)
    part = poses.new_zeros((bsz, threads, n_cap, 5))
    for i in range(n_it):
        for k in range(k_cap):
            hit = (idx[:, i, :, k, None] == lm)[..., None]                 # (B, P, N, 1)
            val = torch.stack([v[:, i, :, k] for v in vals], -1)[:, :, None]  # (B, P, 1, 5)
            part = torch.where(hit, part + val, part)
    h = threads
    while h > 1:
        h //= 2
        part = part[:, :h] + part[:, h:2 * h]
    sums = part[:, 0]                                                    # (B, N, 5)

    l_active = jac["lm_active"].to(torch.float32)
    damp = (1.0 + torch.as_tensor(damping, dtype=torch.float32, device=dev)).reshape(-1, 1)
    lxx = sums[..., 0] * damp + (1.0 - l_active) + 1e-12
    lyy = sums[..., 2] * damp + (1.0 - l_active) + 1e-12
    lxy = sums[..., 1]
    det = lxx * lyy - lxy * lxy
    det = torch.where(det.abs() > 1e-30, det, 1.0)
    hll_inv = torch.stack([lyy / det, -lxy / det, lxx / det], dim=2)
    gl = sums[..., 3:5] * l_active[:, :, None]

    # ---- reduced rhs
    w = _hll_inv_apply(hll_inv, gl)
    wx, wy = slots.gather(w[..., 0]), slots.gather(w[..., 1])
    ub2 = -(ab * wx + bb * wy)
    ur2 = -(ar * wx + br * wy)
    y = torch.stack([_ksum(valid, ab * ub2 + ar * ur2), _ksum(valid, bb * ub2 + br * ur2),
                     _ksum(valid, cb * ub2)], dim=-1)
    rhs = gp * p_active[:, :, None] - torch.cat([y.new_zeros((bsz, 1, 3)), y], 1)
    return dict(d=d, u=u, hll_inv=hll_inv, coeffs=coeffs, gp=gp, gl=gl,
                rhs=rhs, p_active=p_active, l_active=l_active)


def solve_schur_pcg(
    cfg, s: PoseGraphState, poses, lms,
    n_gn: int = 8, n_cg: int = 12, damping: float = 1e-4,
    meas_scale: float = 1.0, fix_theta: bool = False,
):
    """Bulk GN solver: eliminate the landmarks by Schur complement and solve
    the reduced pose system with CG preconditioned by its exact
    block-tridiagonal chain part (block-Thomas, factored once per GN step,
    O(T) per apply).

    The odometry chain carries the stiff information (whitened weights ~1e7)
    and lives inside the preconditioner, so CG only corrects for the much
    softer landmark coupling that the Schur complement spreads across
    co-visible poses. Levenberg-style relative damping adapts per world and
    GN iteration: a rejected step raises it, an accepted one lowers it. Each
    call starts at ``damping`` again. ``fix_theta``: headings frozen (see
    ``_schur_system``). Returns (poses, lms, err (B,)).

    While a profiler records (``utils/profiling``), each GN step is the span
    ``les.pg.gn`` around ``les.pg.gn.system`` (the system, its factor and
    the reduced rhs), ``les.pg.gn.cg`` (the CG loop) and
    ``les.pg.gn.line_search`` (the back-substitution, both trial points, the
    accept and the damping update); the counters ``pg.gn_world_steps`` and
    ``pg.gn_accepted`` count the worlds' steps and the accepted ones.
    """
    slots = LmSlots(s)
    err = graph_error(cfg, s, poses, lms, meas_scale, slots)
    lam = torch.full_like(err, damping)
    moments = _odom_moments(cfg, s.odom)  # the graph's alone: once a call
    work = _system_work(s, moments) if poses.device.type == "cuda" else None

    for _ in range(n_gn):
        with profiling.span("les.pg.gn"):
            with profiling.span("les.pg.gn.system"):
                # the blocks, the masked gradients and the reduced rhs g_p -
                # H_pl H_ll^-1 g_l
                sy = _schur_system(cfg, s, poses, lms, meas_scale, lam, slots,
                                   fix_theta, moments, work)
                d, u, hll_inv, coeffs = sy["d"], sy["u"], sy["hll_inv"], sy["coeffs"]
                fac = _tridiag_factor(d, u)
                l_active, gl, rhs = sy["l_active"], sy["gl"], sy["rhs"]
                p_mask = sy["p_active"][:, :, None]

            with profiling.span("les.pg.gn.cg"):
                xp = torch.zeros_like(rhs)
                r = rhs
                z = _tridiag_solve(fac, r)
                p = z
                rz = _dot(r, z)
                for _ in range(n_cg):
                    # S p: the chain part is exactly the preconditioner's matrix
                    sp = _schur_mv(d, u, hll_inv, coeffs, slots, p)
                    alpha = (rz / torch.clamp_min(_dot(p, sp), 1e-30))[:, None, None]
                    xp = xp + alpha * p
                    r = r - alpha * sp
                    z = _tridiag_solve(fac, r)
                    rz_new = _dot(r, z)
                    beta = rz_new / torch.where(rz.abs() > 1e-30, rz, 1.0)
                    p = z + beta[:, None, None] * p
                    rz = rz_new

            with profiling.span("les.pg.gn.line_search"):
                xp = xp * p_mask
                # landmark back-substitution
                xl = _hll_inv_apply(hll_inv, gl - _hpl_t_apply(s, coeffs, xp, slots))
                xl = xl * l_active[:, :, None]

                # halving line search, accept only what improves
                p1, l1 = _retract(poses, lms, xp, xl, 1.0)
                e1 = graph_error(cfg, s, p1, l1, meas_scale, slots)
                p2, l2 = _retract(poses, lms, xp, xl, 0.5)
                e2 = graph_error(cfg, s, p2, l2, meas_scale, slots)
                half = (e2 < e1)[:, None, None]
                e_new = torch.minimum(e1, e2)
                ok = (e_new < err) & torch.isfinite(e_new)
                okb = ok[:, None, None]
                poses = torch.where(okb, torch.where(half, p2, p1), poses)
                lms = torch.where(okb, torch.where(half, l2, l1), lms)
                err = torch.where(ok, e_new, err)
                lam = torch.where(
                    ok, torch.clamp_min(_div(lam, 3.0), 1e-6),
                    torch.clamp_max(lam * 8.0, 1e4),
                )
            if profiling.tracing():
                # a rejected step is a GN step spent for nothing on its world
                profiling.count("pg.gn_world_steps", ok.numel())
                profiling.count("pg.gn_accepted", ok.sum())
    return poses, lms, err


# ----------------------------------------------------------------------
# Chordal initialisation, the graduated solves and the dense LM
# ----------------------------------------------------------------------

def chordal_seed(cfg, s: PoseGraphState, slots=None):
    """The iterate chordal_init starts its linear solve from, from the
    factors alone: headings integrated from the anchored pose 0 along the
    chain of (clip-aware) expected turns (the graph's only rotation
    coupling is that chain, so rotation averaging is exact), positions
    dead-reckoned, each landmark at the mean of its measurements'
    back-projections through that trajectory. The landmark sums go through
    ``LmSlots`` (no atomics). Returns (poses (B, T+1, 3), lms (B, N, 2))."""
    slots = slots or LmSlots(s)
    eff, _ = _odom_moments(cfg, s.odom)
    p0 = s.poses_init[:, 0]
    dth = torch.where(s.odom_valid, eff[..., 1], 0.0)
    th = torch.cat([p0[:, 2:3], p0[:, 2:3] + torch.cumsum(dth, dim=1)], dim=1)
    d_eff = torch.where(s.odom_valid, eff[..., 0], 0.0)
    zero = torch.zeros_like(p0[:, :1])
    px = p0[:, 0:1] + torch.cat(
        [zero, torch.cumsum(d_eff * torch.cos(th[:, :-1]), dim=1)], dim=1)
    py = p0[:, 1:2] + torch.cat(
        [zero, torch.cumsum(d_eff * torch.sin(th[:, :-1]), dim=1)], dim=1)
    poses = torch.stack([px, py, wrap_angle(th)], dim=-1)
    # the measurement at row t attaches to pose t+1
    pt = poses[:, 1:, None, :]
    ang = pt[..., 2] + s.meas_rb[..., 1]
    gx = pt[..., 0] + s.meas_rb[..., 0] * torch.cos(ang)
    gy = pt[..., 1] + s.meas_rb[..., 0] * torch.sin(ang)
    valid = s.meas_valid.to(torch.float32)
    wsum = slots.scatter(valid)
    lms = (torch.stack([slots.scatter(gx * valid), slots.scatter(gy * valid)], dim=-1)
           / torch.clamp_min(wsum, 1.0)[..., None])
    return poses, lms


def chordal_init(cfg, s: PoseGraphState):
    """Chordal-style initialisation from the factors alone, independent of
    the secondary filter's node seeds (the analog of the reference's
    disabled SE-Sync path, pose_graph.cpp:31-63): ``chordal_seed``, then
    two Gauss-Newton steps of ``solve_schur_pcg`` with the headings fixed
    (the problem is linear there; the second step mops up CG truncation).
    Returns (poses, lms) for ``solve``."""
    poses, lms = chordal_seed(cfg, s)
    poses, lms, _ = solve_schur_pcg(
        cfg, s, poses, lms, n_gn=2,
        n_cg=max(cfg.pose_graph.bulk_cg_iters, 40), fix_theta=True,
    )
    return poses, lms


def _take(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where the world's cond (B,) holds, else b."""
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def solve(cfg, s: PoseGraphState, poses0=None, lms0=None):
    """Full graph optimisation (pose_graph.cpp:283-284). Returns (poses,
    lms, err (B,)).

    ``pose_graph.solver`` "dense" runs ``solve_dense``; "schur" a graduated
    schedule of ``solve_schur_pcg``: the measurement sigmas relaxed 16x,
    then 4x (max(8, bulk_gn_iters // 3) steps each), then bulk_gn_iters
    steps at 1x; the tight bearing sigmas make contorted local minima from
    a drifted start. A cold start begins at the seeds, or at
    ``chordal_init`` with ``pose_graph.init="chordal"``; a warm start
    (poses0, lms0) also runs the schedule from the raw seeds and keeps the
    lower residual of the two, world by world.
    """
    if cfg.pose_graph.solver == "dense":
        return solve_dense(cfg, s, poses0, lms0)
    pg = cfg.pose_graph
    if poses0 is None and pg.init == "chordal":
        start = chordal_init(cfg, s)
    else:
        start = (s.poses_init if poses0 is None else poses0,
                 s.lms_init if lms0 is None else lms0)
    stage_gn = max(8, pg.bulk_gn_iters // 3)

    def graduated(poses, lms):
        for scale in (16.0, 4.0):
            poses, lms, _ = solve_schur_pcg(
                cfg, s, poses, lms, n_gn=stage_gn, n_cg=pg.bulk_cg_iters,
                meas_scale=scale)
        return solve_schur_pcg(cfg, s, poses, lms, n_gn=pg.bulk_gn_iters,
                               n_cg=pg.bulk_cg_iters)

    poses, lms, err = graduated(*start)
    if poses0 is not None:
        poses_r, lms_r, err_r = graduated(s.poses_init, s.lms_init)
        take = err_r < err
        poses, lms = _take(take, poses_r, poses), _take(take, lms_r, lms)
        err = torch.minimum(err_r, err)
    return poses, lms, err


def solve_dense(cfg, s: PoseGraphState, poses0=None, lms0=None):
    """Graduated dense Levenberg-Marquardt (the reference implementation of
    the solve; GTSAM's defaults lambda0 = 1e-5, factor 10): a direct solve
    from the start and a graduated one (measurement sigmas 16x / 4x / 1x),
    the lower residual kept; a warm start also runs the graduated solve
    from the raw seeds. O((3T+2N)^3) an iteration a world. Returns (poses,
    lms, err (B,))."""
    pin_fp32()  # the Cholesky's internal products in full float32
    slots = LmSlots(s)
    poses0_ = s.poses_init if poses0 is None else poses0
    lms0_ = s.lms_init if lms0 is None else lms0

    def graduated(poses, lms):
        for scale in (16.0, 4.0, 1.0):
            poses, lms, err = _solve_stage(cfg, s, poses, lms, scale, slots)
        return poses, lms, err

    poses, lms, err = _solve_stage(cfg, s, poses0_, lms0_, 1.0, slots)
    candidates = [graduated(poses0_, lms0_)]
    if poses0 is not None:
        candidates.append(graduated(s.poses_init, s.lms_init))
    for poses_g, lms_g, err_g in candidates:
        take = err_g < err
        poses, lms = _take(take, poses_g, poses), _take(take, lms_g, lms)
        err = torch.minimum(err_g, err)
    return poses, lms, err


def _assemble(cfg, s: PoseGraphState, poses, lms, meas_scale=1.0, slots=None):
    """The dense damped-GN system of every world: (h (B, D, D) = J^T J, g
    (B, D) = -J^T r, var_active (B, D)), D = 3(T+1) + 2N, poses first.
    Inactive variables are pinned by identity rows.

    The blocks are summed without atomics: the chain's 3 x 3 blocks by
    node, a tick's pose-landmark blocks by a one-hot contraction over its K
    slots (a tick binds each landmark at most once, so each entry is one
    product), the landmark blocks through ``LmSlots``."""
    slots = slots or LmSlots(s)
    res = _residuals(cfg, s, poses, lms, meas_scale, slots)
    jac = _jacobians(cfg, s, poses, lms, meas_scale, slots, res)
    coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, meas_scale, slots, res)
    bsz, t_cap = s.odom.shape[:2]
    n_cap = lms.shape[1]
    n_p = 3 * (t_cap + 1)
    dev = poses.device
    ja, jb = jac["ja"], jac["jb"]
    jm = jac["make_jm"]()
    h55 = _mtm(jm, jm)  # (B, T, K, 5, 5)

    # ---- poses: block tridiagonal (prior, between-factors, the unary
    # bearing-range blocks of node t+1)
    dblk = torch.zeros((bsz, t_cap + 1, 3, 3), dtype=torch.float32, device=dev)
    i3 = torch.arange(3, device=dev)
    dblk[:, 0, i3, i3] += jac["inv_pr"] ** 2
    dblk[:, :-1] += _mtm(ja, ja)
    dblk[:, 1:] += _mtm(jb, jb)
    dblk[:, 1:] += h55[..., :3, :3].sum(dim=2)
    ublk = _mtm(ja, jb)  # (t, t+1)
    node = torch.arange(t_cap + 1, device=dev)
    hpp = torch.zeros((bsz, t_cap + 1, 3, t_cap + 1, 3), dtype=torch.float32,
                      device=dev)
    hpp[:, node, :, node, :] = dblk.transpose(0, 1)
    hpp[:, node[:-1], :, node[1:], :] = ublk.transpose(0, 1)
    hpp[:, node[1:], :, node[:-1], :] = ublk.transpose(-1, -2).transpose(0, 1)

    # ---- poses x landmarks: node t+1 against each landmark its tick binds
    onehot = torch.nn.functional.one_hot(slots.per_measurement(), n_cap).to(
        torch.float32)  # (B, T, K, N)
    hpl = (onehot[..., None, :, None]
           * h55[..., :3, None, 3:]).sum(dim=2)  # (B, T, 3, N, 2)

    # ---- landmarks: 2 x 2 blocks summed over every measurement
    hxx, hxy, hyy = (slots.scatter(h55[..., a, b]) for a, b in ((3, 3), (3, 4), (4, 4)))
    hll = torch.stack([torch.stack([hxx, hxy], -1), torch.stack([hxy, hyy], -1)], -2)
    lm = torch.arange(n_cap, device=dev)
    hlm = torch.zeros((bsz, n_cap, 2, n_cap, 2), dtype=torch.float32, device=dev)
    hlm[:, lm, :, lm, :] = hll.transpose(0, 1)

    dim = n_p + 2 * n_cap
    h = torch.zeros((bsz, dim, dim), dtype=torch.float32, device=dev)
    h[:, :n_p, :n_p] = hpp.reshape(bsz, n_p, n_p)
    h[:, 3:n_p, n_p:] = hpl.reshape(bsz, 3 * t_cap, 2 * n_cap)
    h[:, n_p:, 3:n_p] = h[:, 3:n_p, n_p:].transpose(1, 2)
    h[:, n_p:, n_p:] = hlm.reshape(bsz, 2 * n_cap, 2 * n_cap)
    gp, gl = _grad(cfg, s, jac, coeffs, r_meas, slots)
    g = torch.cat([gp.reshape(bsz, -1), gl.reshape(bsz, -1)], dim=1)

    var_active = torch.cat([jac["pose_active"].repeat_interleave(3, dim=1),
                            jac["lm_active"].repeat_interleave(2, dim=1)], dim=1)
    h = h + torch.diag_embed(torch.where(var_active, 0.0, 1.0))
    return h, torch.where(var_active, g, 0.0), var_active


def _solve_stage(cfg, s: PoseGraphState, poses, lms, meas_scale, slots=None):
    """Levenberg-Marquardt at one measurement scale, every world on its own
    schedule: the loop runs until every world is done or max_lm_iters, and
    a finished world's iterate, lambda and error stay as they were (JAX's
    ``while_loop`` under ``vmap``). Each step solves the Jacobi-scaled
    damped system by Cholesky (``cholesky_ex``): where a world's matrix is
    not positive definite its step is NaN, its error NaN, and the step is
    rejected (JAX's ``cho_factor`` returns NaN there). Returns (poses,
    lms, err)."""
    pg = cfg.pose_graph
    slots = slots or LmSlots(s)
    err = graph_error(cfg, s, poses, lms, meas_scale, slots)
    n_p = 3 * poses.shape[1]
    lam = torch.full_like(err, pg.lambda_init)
    done = torch.zeros_like(err, dtype=torch.bool)
    for _ in range(pg.max_lm_iters):
        if bool(done.all()):
            break
        h, g, _ = _assemble(cfg, s, poses, lms, meas_scale, slots)
        hd = h + lam[:, None, None] * torch.eye(h.shape[1], device=h.device)
        # Jacobi scaling: the whitened equations span ~8 orders of
        # magnitude (odometry weights 1/sigma^2 against the weak prior)
        dscale = torch.rsqrt(torch.clamp_min(torch.diagonal(hd, dim1=1, dim2=2), 1e-12))
        hs = hd * dscale[:, :, None] * dscale[:, None, :]
        chol, info = torch.linalg.cholesky_ex(hs)
        delta = torch.cholesky_solve((g * dscale)[..., None], chol)[..., 0] * dscale
        delta = torch.where((info == 0)[:, None], delta, float("nan"))
        poses_new = poses + delta[:, :n_p].reshape(poses.shape)
        poses_new[..., 2] = wrap_angle(poses_new[..., 2])
        lms_new = lms + delta[:, n_p:].reshape(lms.shape)
        err_new = graph_error(cfg, s, poses_new, lms_new, meas_scale, slots)
        accept = (err_new < err) & torch.isfinite(err_new) & ~done
        poses, lms = _take(accept, poses_new, poses), _take(accept, lms_new, lms)
        lam_new = torch.where(accept, _div(lam, pg.lambda_factor),
                              lam * pg.lambda_factor)
        rel = (err - err_new).abs() / torch.clamp_min(err, 1e-12)
        finished = (accept & (rel < pg.rel_err_tol)) | (lam_new > 1e10)
        lam = torch.where(done, lam, lam_new)
        err = torch.where(accept, err_new, err)
        done = done | finished
    return poses, lms, err


def finalize(cfg, s: PoseGraphState) -> PoseGraphState:
    """The final solve of a finished graph: in iterative mode warm-started
    from the per-tick solution history (initial_estimate = result,
    pose_graph.cpp:262-267), else cold."""
    if cfg.pose_graph.solve_graph_every_iteration:
        poses, lms, _ = solve(cfg, s, poses0=s.poses_sol, lms0=s.lms_sol)
    else:
        poses, lms, _ = solve(cfg, s)
    return s.replace(poses_sol=poses, lms_sol=lms, solved=torch.ones_like(s.solved))


# ----------------------------------------------------------------------
# Iterative mode: matrix-free PCG Gauss-Newton, re-solved every tick
# ----------------------------------------------------------------------

def solve_pcg_gn(
    cfg, s: PoseGraphState, poses, lms,
    n_gn: int = 1, n_cg: int = 12, meas_scale: float = 1.0,
    damping: float = 1e-4, slots=None,
):
    """Matrix-free damped Gauss-Newton with Jacobi-preconditioned CG: O(n_cg
    F) with F = T + T K factor slots. With a warm start (the previous tick's
    solution) one GN step of a dozen CG iterations tracks the optimum.
    Iteration counts are fixed (no early exit); inactive variables are
    pinned by masks. Returns (poses, lms)."""
    slots = slots or LmSlots(s)

    def dot(ap, al, bp, bl):
        return _dot(ap, bp) + _dot(al, bl)

    for _ in range(n_gn):
        res = _residuals(cfg, s, poses, lms, meas_scale, slots)
        err_old = graph_error(cfg, s, poses, lms, meas_scale, slots, res)
        jac = _jacobians(cfg, s, poses, lms, meas_scale, slots, res)
        coeffs, r_meas = _meas_coeffs(cfg, s, poses, lms, meas_scale, slots, res)
        mp = jac["pose_active"][:, :, None].to(torch.float32)
        ml = jac["lm_active"][:, :, None].to(torch.float32)
        gp, gl = _grad(cfg, s, jac, coeffs, r_meas, slots)
        gp, gl = gp * mp, gl * ml
        dp, dl = _h_diag(s, jac, coeffs, slots)
        # damped Jacobi preconditioner; inactive variables get a unit diagonal
        dp = torch.where(mp > 0, dp * (1.0 + damping) + 1e-12, 1.0)
        dl = torch.where(ml > 0, dl * (1.0 + damping) + 1e-12, 1.0)

        def hv(vp, vl):
            op, ol = _hv(s, jac, coeffs, vp * mp, vl * ml, slots)
            # Levenberg damping keeps the warm-started step conservative
            return (op + damping * dp * vp) * mp, (ol + damping * dl * vl) * ml

        # PCG on H delta = g from delta = 0
        xp, xl = torch.zeros_like(gp), torch.zeros_like(gl)
        rp, rl = gp, gl
        zp, zl = rp / dp, rl / dl
        pp, pl = zp, zl
        rz = dot(rp, rl, zp, zl)
        for _ in range(n_cg):
            hp_, hl_ = hv(pp, pl)
            denom = dot(pp, pl, hp_, hl_)
            alpha = rz / torch.where(denom.abs() > 1e-20, denom, 1.0)
            alpha = torch.where(denom > 0, alpha, 0.0)[:, None, None]  # H PSD guard
            xp = xp + alpha * pp
            xl = xl + alpha * pl
            rp = rp - alpha * hp_
            rl = rl - alpha * hl_
            zp, zl = rp / dp, rl / dl
            rz_new = dot(rp, rl, zp, zl)
            beta = (rz_new / torch.where(rz.abs() > 1e-20, rz, 1.0))[:, None, None]
            pp = zp + beta * pp
            pl = zl + beta * pl
            rz = rz_new
        # accept only improving steps (a rejected step keeps the warm start)
        poses_new, lms_new = _retract(poses, lms, xp, xl, 1.0)
        err_new = graph_error(cfg, s, poses_new, lms_new, meas_scale, slots)
        ok = ((err_new < err_old) & torch.isfinite(err_new))[:, None, None]
        poses = torch.where(ok, poses_new, poses)
        lms = torch.where(ok, lms_new, lms)
    return poses, lms


def replay_iterative(cfg, s: PoseGraphState, ticks, poses_sol, lms_sol, m_at):
    """Re-enact the per-tick incremental solves of iterative mode
    (solve_graph_every_iteration) on fully assembled graphs.

    For each live tick t of ``ticks`` (a sequence of ints): present the
    graph as it stood at the end of tick t (prefix masks on the odometry and
    measurement rows, timestep t+1, landmark count m_at[:, t]), copy the
    newly added node's seed into the warm solution, and run the
    ``solve_pcg_gn`` step that ``solve_iteration`` runs. m_at (B, T): the
    landmark count at the end of each tick. Returns (poses_sol, lms_sol).
    """
    pg = cfg.pose_graph
    dev = s.odom.device
    tidx = torch.arange(s.odom.shape[1], device=dev)
    slot = torch.arange(s.lms_init.shape[1], device=dev)[None, :, None]
    slots = LmSlots(s)  # a prefix of the rows keeps the slot map
    for t in ticks:
        t = int(t)
        m_prev = m_at[:, t - 1] if t > 0 else torch.zeros_like(m_at[:, 0])
        upto = tidx <= t
        s_t = s.replace(
            timestep=torch.full_like(s.timestep, t + 1),
            M=m_at[:, t],
            odom_valid=s.odom_valid & upto,
            meas_valid=s.meas_valid & upto[None, :, None],
        )
        poses0 = poses_sol.clone()
        poses0[:, t + 1] = s.poses_init[:, t + 1]
        lms0 = torch.where(slot < m_prev[:, None, None], lms_sol, s.lms_init)
        poses_sol, lms_sol = solve_pcg_gn(
            cfg, s_t, poses0, lms0, n_gn=pg.gn_steps_per_tick,
            n_cg=pg.pcg_iters, slots=slots,
        )
    return poses_sol, lms_sol


def solve_iteration(cfg, s: PoseGraphState, m_prev, node_t=None) -> PoseGraphState:
    """One per-tick incremental solve: warm-start from the previous solution
    with the newly added pose node (and any new landmarks) taken from the
    secondary seeds, run PCG-GN, and store the result as the next initial
    estimate. ``node_t``: the just-added node index, the same in every world
    (default: world 0's timestep); m_prev (B,)."""
    pg = cfg.pose_graph
    t = int(s.timestep[0]) if node_t is None else int(node_t)
    poses0 = s.poses_sol.clone()
    poses0[:, t] = s.poses_init[:, t]
    slot = torch.arange(s.lms_init.shape[1], device=s.odom.device)[None, :, None]
    lms0 = torch.where(slot < m_prev[:, None, None], s.lms_sol, s.lms_init)
    poses, lms = solve_pcg_gn(
        cfg, s, poses0, lms0, n_gn=pg.gn_steps_per_tick, n_cg=pg.pcg_iters
    )
    return s.replace(poses_sol=poses, lms_sol=lms,
                     solved=torch.ones_like(s.solved))
