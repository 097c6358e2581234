"""The primitives of the fused rollout kernels as standalone operations: the
CUDA kernels' wrappers and their plain versions.

Counterpart of the Pallas microbenchmark kernels of ``scripts/
micro_downdate.py``, ``scripts/micro_ukf.py`` and ``scripts/
micro_ukf_probe.py``. Each function runs ``passes`` (or ``n``) passes of one
primitive over every world's covariance, which stays on the chip between the
passes: on CUDA tensors in one launch of the hand-written kernel in
``csrc/micro_ops.cu`` (whose source note gives the design), on CPU tensors
through its ``*_reference``, the same float32 algebra in the same order as
batched torch. There is no fallback from one to the other. Timing a launch
and dividing by its passes gives the primitive's cost on the card; the tools
in ``live_ekf_slam_tpu_torch/tools`` do that.

The layout is the rollout kernels': worlds on the leading axis, matrices
``(B, D, D)``, vectors ``(B, D)``. ``convert.micro_inputs_from_numpy`` turns
the TPU scripts' world-minor arrays into it. Of the TPU scripts' variants
those stay that differ in arithmetic, in summation order or in what a warp
reads contiguously; their block width and their choice of tiled axis have no
counterpart here.
"""

from __future__ import annotations

import torch

from live_ekf_slam_tpu_torch.ops import _build
from live_ekf_slam_tpu_torch.ops.fused_ukf import CHOL_EPS, lane_sum, row_dot
from live_ekf_slam_tpu_torch.ops.kernel_math import atan2, wrap

# launches of each kernel family (not of the plain versions)
launches = {"rank_update": 0, "column_gather": 0, "chol": 0, "matvec": 0,
            "joseph": 0, "zstats": 0, "zstats_sincos": 0}

RANKS = (1, 2, 4, 8, 16)
GATHER_SPELLINGS = ("select", "take")
CHOL_VARIANTS = ("full", "trail", "lower")
MATVEC_ORDERS = ("row", "col", "unrolled")
JOSEPH_SPELLINGS = ("prod9", "hoist", "terms")
JOSEPH_TERMS = 7
# the largest D that rank_update, joseph, chol, matvec and the select gather
# take on CUDA: their kernels hold a world's matrix, padded to TILE x TILE,
# in one warp's registers (take and zstats serve any D whose inputs fit
# shared memory)
TILE = 48


def _code(name: str, value: str, choices: tuple) -> int:
    if value not in choices:
        raise ValueError(f"unknown {name} {value!r}: one of {choices}")
    return choices.index(value)


def _check(name: str, t: torch.Tensor, shape: tuple, dev: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the first argument on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _matrix_dims(name: str, p: torch.Tensor) -> tuple[int, int]:
    if p.dim() != 3 or p.shape[1] != p.shape[2] or 0 in p.shape:
        raise ValueError(f"{name} must be (B, D, D), got {tuple(p.shape)}")
    _check(name, p, tuple(p.shape), p.device)
    return p.shape[0], p.shape[1]


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel launches); anything else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cpu"


def _passes(n: int) -> int:
    if int(n) < 1:
        raise ValueError(f"at least one pass, got {n}")
    return int(n)


def _fits_tile(family: str, d: int) -> None:
    if d > TILE:
        raise ValueError(f"{family} on CUDA serves D <= {TILE} (a world's matrix "
                         f"in one warp's registers), got D = {d}")


def _launch(family: str, entry: str, dev: torch.device, *args) -> None:
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _build.check(rc, f"{family} kernel")
    launches[family] += 1


# ---------------------------------------------------------------- rank_update
def rank_update(p: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                passes: int) -> torch.Tensor:
    """``passes`` passes of P <- P - sum_r k_r h_r^T over p (B, D, D), with
    k and h (B, R, D), R in 1, 2, 4, 8, 16 rank-1 terms a pass, subtracted
    from each entry one after the other (R = 2 is the rollouts' downdate).
    Returns the new P. On CUDA, D <= ``TILE``."""
    b, d = _matrix_dims("p", p)
    passes = _passes(passes)
    if k.dim() != 3 or k.shape[1] not in RANKS:
        raise ValueError(f"k must be (B, R, D) with R in {RANKS}, got "
                         f"{tuple(k.shape)}")
    r = k.shape[1]
    _check("k", k, (b, r, d), p.device)
    _check("h", h, (b, r, d), p.device)
    if _on_cpu(p, "rank_update"):
        return rank_update_reference(p, k, h, passes)
    _fits_tile("rank_update", d)
    out = torch.empty_like(p)
    _launch("rank_update", "les_micro_rank_update", p.device, p.data_ptr(),
            k.data_ptr(), h.data_ptr(), out.data_ptr(), b, d, r, passes)
    return out


def rank_update_reference(p, k, h, passes: int) -> torch.Tensor:
    """The plain version of ``rank_update``."""
    for _ in range(passes):
        for r in range(k.shape[1]):
            p = p - k[:, r, :, None] * h[:, r, None, :]
    return p


# -------------------------------------------------------------- column_gather
def column_gather(p: torch.Tensor, idx: torch.Tensor, n: int,
                  spelling: str = "take") -> torch.Tensor:
    """out[b, a] = P[b, a, idx[b]] added ``n`` times onto zero: p (B, D, D),
    idx (B,) int32 in [0, D), one column a world. ``spelling="select"``
    multiplies each row by the one-hot of idx and sums it in index order;
    ``"take"`` reads the one entry. Both give the same (B, D) values where
    the rows are finite; a row holding an infinity or a NaN off idx gives
    NaN by select (a product by zero, as the TPU script's one-hot) and the
    entry by take. The range of idx is the caller's to ensure
    (``check_index``, once, where idx is made): reading it back here would
    stall the host in every launch. On CUDA, select serves D <= ``TILE``."""
    b, d = _matrix_dims("p", p)
    n = _passes(n)
    code = _code("spelling", spelling, GATHER_SPELLINGS)
    _check("idx", idx, (b,), p.device, torch.int32)
    if _on_cpu(p, "column_gather"):
        return column_gather_reference(p, idx, n, spelling)
    if spelling == "select":
        _fits_tile("column_gather select", d)
    out = torch.empty((b, d), dtype=torch.float32, device=p.device)
    _launch("column_gather", "les_micro_column_gather", p.device, p.data_ptr(),
            idx.data_ptr(), out.data_ptr(), b, d, n, code)
    return out


def check_index(idx: torch.Tensor, d: int) -> torch.Tensor:
    """idx, after checking that every entry lies in [0, d); reads it back
    from the card, so call it where idx is made, not around a launch."""
    if bool(((idx < 0) | (idx >= d)).any()):
        raise ValueError(f"idx must lie in [0, {d})")
    return idx


def column_gather_reference(p, idx, n: int, spelling: str = "take"):
    """The plain version of ``column_gather``."""
    b, d, _ = p.shape
    if spelling == "select":
        sel = (torch.arange(d, device=p.device)[None, :]
               == idx[:, None]).to(torch.float32)  # (B, D) one-hot
        g = torch.zeros((b, d), dtype=torch.float32, device=p.device)
        for c in range(d):
            g = g + p[:, :, c] * sel[:, c:c + 1]
    else:
        g = torch.gather(p, 2, idx.long()[:, None, None].expand(b, d, 1))[..., 0]
    out = torch.zeros_like(g)
    for _ in range(n):
        out = out + g
    return out


# ----------------------------------------------------------------------- chol
def chol(p: torch.Tensor, n: int = 1, variant: str = "full",
         du: int | None = None) -> torch.Tensor:
    """The pivot-clamped Cholesky of the UKF predict, ``n`` times from p
    afresh; returns the last factorisation's (B, D, D) array. Pivots
    0 .. du-1 (default all D): a pivot at or below ``CHOL_EPS`` zeroes its
    column and leaves sqrt(CHOL_EPS) on the diagonal.

    ``variant`` chooses the columns the trailing update of a row walks at
    pivot j: ``"full"`` all D (the entries left of the pivot subtract zero),
    ``"trail"`` those from ((j+1)//8)*8 on, ``"lower"`` only j+1 .. the
    row's diagonal, which is the rollout kernel's loop. All three give the
    same lower triangle. ``"full"`` and ``"trail"`` start from the whole of
    p: past column du they leave the symmetric trailing update, before it
    zeros above the diagonal; ``"lower"`` starts from p's lower triangle and
    leaves zeros above the diagonal throughout. On CUDA, D <= ``TILE``."""
    b, d = _matrix_dims("p", p)
    n = _passes(n)
    code = _code("variant", variant, CHOL_VARIANTS)
    du = d if du is None else int(du)
    if not 1 <= du <= d:
        raise ValueError(f"du must lie in [1, {d}], got {du}")
    if _on_cpu(p, "chol"):
        return chol_reference(p, n, variant, du)
    _fits_tile("chol", d)
    out = torch.empty_like(p)
    _launch("chol", "les_micro_chol", p.device, p.data_ptr(), out.data_ptr(),
            b, d, du, n, code)
    return out


def chol_reference(p, n: int = 1, variant: str = "full", du: int | None = None):
    """The plain version of ``chol``. Every factorisation starts from p and
    none reads another's result, so it runs one."""
    d = p.shape[-1]
    du = d if du is None else du
    idx = torch.arange(d, device=p.device)
    L = torch.tril(p) if variant == "lower" else p.clone()
    for j in range(du):
        pivot = L[:, j, j]
        ok = (pivot > CHOL_EPS).to(torch.float32)
        dval = torch.sqrt(torch.clamp_min(pivot, CHOL_EPS))
        below = torch.where(idx > j, L[:, :, j], 0.0) * (ok / dval)[:, None]
        if j + 1 < du:
            outer = below[:, j + 1:, None] * below[:, None, :]
            if variant == "full":
                L[:, j + 1:, :] = L[:, j + 1:, :] - outer
            elif variant == "trail":
                c0 = ((j + 1) // 8) * 8
                L[:, j + 1:, c0:] = L[:, j + 1:, c0:] - outer[:, :, c0:]
            else:
                L[:, j + 1:, j + 1:] = (L[:, j + 1:, j + 1:]
                                        - torch.tril(outer[:, :, j + 1:]))
        L[:, :, j] = below + (idx == j).to(torch.float32) * dval[:, None]
    return L


# --------------------------------------------------------------------- matvec
def matvec(l: torch.Tensor, g: torch.Tensor, n: int,
           order: str = "row") -> torch.Tensor:
    """``n`` passes of out <- out + M g_a for each of the A vectors of g
    (B, A, D), onto zero; l (B, D, D); returns out (B, D).

    ``order="row"``: M = L, each row's products summed in index order, the
    sum then added to out (the rollout kernel's matvec). ``"col"``: M = L^T,
    each output summed over the rows in the warp's order (``lane_sum``).
    ``"unrolled"``: M = L, the D products of a row added onto out one after
    the other. On CUDA, D <= ``TILE``."""
    b, d = _matrix_dims("l", l)
    n = _passes(n)
    code = _code("order", order, MATVEC_ORDERS)
    if g.dim() != 3 or g.shape[1] < 1:
        raise ValueError(f"g must be (B, A, D), got {tuple(g.shape)}")
    a = g.shape[1]
    _check("g", g, (b, a, d), l.device)
    if _on_cpu(l, "matvec"):
        return matvec_reference(l, g, n, order)
    _fits_tile("matvec", d)
    out = torch.empty((b, d), dtype=torch.float32, device=l.device)
    _launch("matvec", "les_micro_matvec", l.device, l.data_ptr(), g.data_ptr(),
            out.data_ptr(), b, d, a, n, code)
    return out


def matvec_reference(l, g, n: int, order: str = "row") -> torch.Tensor:
    """The plain version of ``matvec``."""
    b, d, _ = l.shape
    out = torch.zeros((b, d), dtype=torch.float32, device=l.device)
    for _ in range(n):
        for a in range(g.shape[1]):
            ga = g[:, a]
            if order == "row":
                out = out + row_dot(l, ga[:, None])[:, 0]
            elif order == "col":
                out = out + lane_sum((l * ga[:, :, None]).transpose(1, 2))
            else:
                for c in range(d):
                    out = out + l[:, :, c] * ga[:, c:c + 1]
    return out


# --------------------------------------------------------------------- joseph
def joseph(p: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor,
           cr: torch.Tensor, cb: torch.Tensor, s: torch.Tensor, n: int,
           spelling: str = "prod9", n_terms: int = JOSEPH_TERMS) -> torch.Tensor:
    """``n`` passes of the one-pass symmetric Joseph update of p (B, D, D)
    with gains k0, k1 and cross-covariances cr, cb (B, D) and s (B, 3) =
    (s00, s01, s11); returns the new P. Every entry of both triangles comes
    from its own expression. On CUDA, D <= ``TILE``.

    ``spelling="prod9"`` is the rollouts' expression, ``"hoist"`` builds the
    three symmetric gain products first, ``"terms"`` adds the first
    ``n_terms`` (1..7) outer-product terms one after the other: -k0 cr^T,
    -cr k0^T, -k1 cb^T, -cb k1^T, s00 k0 k0^T, s11 k1 k1^T,
    s01 (k0 k1^T + k1 k0^T)."""
    b, d = _matrix_dims("p", p)
    n = _passes(n)
    code = _code("spelling", spelling, JOSEPH_SPELLINGS)
    if spelling == "terms" and not 1 <= n_terms <= JOSEPH_TERMS:
        raise ValueError(f"n_terms must lie in [1, {JOSEPH_TERMS}], got {n_terms}")
    for name, v in (("k0", k0), ("k1", k1), ("cr", cr), ("cb", cb)):
        _check(name, v, (b, d), p.device)
    _check("s", s, (b, 3), p.device)
    if _on_cpu(p, "joseph"):
        return joseph_reference(p, k0, k1, cr, cb, s, n, spelling, n_terms)
    _fits_tile("joseph", d)
    out = torch.empty_like(p)
    _launch("joseph", "les_micro_joseph", p.device, p.data_ptr(), k0.data_ptr(),
            k1.data_ptr(), cr.data_ptr(), cb.data_ptr(), s.data_ptr(),
            out.data_ptr(), b, d, n, code, int(n_terms))
    return out


def joseph_reference(p, k0, k1, cr, cb, s, n: int, spelling: str = "prod9",
                     n_terms: int = JOSEPH_TERMS) -> torch.Tensor:
    """The plain version of ``joseph``."""
    ko0, ko1, cro, cbo = (v[:, :, None] for v in (k0, k1, cr, cb))
    kT0, kT1, crT, cbT = (v[:, None, :] for v in (k0, k1, cr, cb))
    s00, s01, s11 = (s[:, i, None, None] for i in range(3))
    for _ in range(n):
        if spelling == "prod9":
            p = p + (
                -(ko0 * crT + cro * kT0)
                - (ko1 * cbT + cbo * kT1)
                + s00 * (ko0 * kT0)
                + s01 * (ko0 * kT1 + ko1 * kT0)
                + s11 * (ko1 * kT1)
            )
        elif spelling == "hoist":
            g00 = ko0 * kT0
            g11 = ko1 * kT1
            g01 = ko0 * kT1 + ko1 * kT0
            p = p + (
                s00 * g00 + s01 * g01 + s11 * g11
                - (ko0 * crT + cro * kT0)
                - (ko1 * cbT + cbo * kT1)
            )
        else:
            terms = [
                -(ko0 * crT),
                -(cro * kT0),
                -(ko1 * cbT),
                -(cbo * kT1),
                s00 * (ko0 * kT0),
                s11 * (ko1 * kT1),
                s01 * (ko0 * kT1 + ko1 * kT0),
            ]
            for t in terms[:n_terms]:
                p = p + t
    return p


def occupancy(op: str, d: int = TILE, rank: int = 2, spelling: str = "prod9",
              n_terms: int = JOSEPH_TERMS, variant: str = "lower",
              order: str = "row", vectors: int = 4) -> dict:
    """The launch at D = d as the card takes it (``_build.occupancy``) of
    ``rank_update`` (``op="rank_update"``, ``rank``), ``joseph``
    (``spelling``, ``n_terms``), ``chol`` (``variant``), ``matvec``
    (``order``, ``vectors`` a pass), ``column_gather`` (``spelling``
    "select" or "take") or ``zstats``."""
    if op == "rank_update":
        return _build.occupancy("les_micro_occupancy", 0, rank, 0, d)
    if op == "joseph":
        return _build.occupancy("les_micro_occupancy", 1,
                                _code("spelling", spelling, JOSEPH_SPELLINGS), n_terms, d)
    if op == "chol":
        return _build.occupancy("les_micro_occupancy", 2,
                                _code("variant", variant, CHOL_VARIANTS), 0, d)
    if op == "matvec":
        return _build.occupancy("les_micro_occupancy", 3,
                                _code("order", order, MATVEC_ORDERS), vectors, d)
    if op == "column_gather":
        return _build.occupancy("les_micro_occupancy", 4,
                                _code("spelling", spelling, GATHER_SPELLINGS), 0, d)
    if op == "zstats":
        return _build.occupancy("les_micro_occupancy", 5, 0, 0, d)
    raise ValueError(f"no occupancy entry for {op!r}")


def occupancy_kwargs(op: str, variant: str, vectors: int = 4) -> dict:
    """The keywords of ``occupancy`` for a kernel's variant as the tools and
    chip_smoke.py name it ("R=2", "R=2 (probe)", "prod9", "terms=3",
    "lower", "row", "row x4", "take", "zstats"); matvec with ``vectors`` a
    pass."""
    v = variant.split(" ")[0]
    if op == "rank_update":
        return {"rank": int(v.split("=")[1])}
    if op == "joseph":
        spelling, _, n = v.partition("=")
        return {"spelling": spelling, "n_terms": int(n) if n else JOSEPH_TERMS}
    if op == "chol":
        return {"variant": v}
    if op == "matvec":
        return {"order": v, "vectors": vectors}
    if op == "column_gather":
        return {"spelling": v}
    if op == "zstats":
        return {}
    raise ValueError(f"no micro family: {op!r}")


# --------------------------------------------------------------------- zstats
def zstats(sp: torch.Tensor, sm: torch.Tensor, lm: torch.Tensor,
           wm: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` passes of the per-landmark sigma measurement block: sp, sm
    (B, 3, D) hold x, y and yaw of the + and - sigma halves, lm (B, 2) the
    landmark, wm (B, D) the column weights. Each pass takes range and
    bearing of the landmark from every sigma point (polynomial ``atan2``,
    ``wrap``), the weighted range mean and circular bearing mean, the
    deviations, and adds s00 + s01 + s11 to the world's output (B,). Sums
    over the columns run in the warp's order (``lane_sum``), which the
    kernel keeps though it deals the sigma points over the lanes otherwise."""
    if sp.dim() != 3 or sp.shape[1] != 3 or 0 in sp.shape:
        raise ValueError(f"sp must be (B, 3, D), got {tuple(sp.shape)}")
    b, _, d = sp.shape
    n = _passes(n)
    dev = sp.device
    _check("sp", sp, (b, 3, d), dev)
    _check("sm", sm, (b, 3, d), dev)
    _check("lm", lm, (b, 2), dev)
    _check("wm", wm, (b, d), dev)
    if _on_cpu(sp, "zstats"):
        return zstats_reference(sp, sm, lm, wm, n)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    _launch("zstats", "les_micro_zstats", dev, sp.data_ptr(), sm.data_ptr(),
            lm.data_ptr(), wm.data_ptr(), out.data_ptr(), b, d, n)
    return out


def zstats_sincos(x: torch.Tensor) -> torch.Tensor:
    """(n, 2): the sine and cosine of each of x (n,) as the zstats kernel
    computes them, a check of its bits: on CUDA its own function (the CUDA
    library's sinf and cosf without their path for |x| >= 105615, which
    zstats' wrapped bearings never take), on the CPU ``torch.sin`` and
    ``torch.cos``, which it must equal bit for bit on the card wherever the
    bearing lies."""
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"x must be (n,), n >= 1, got {tuple(x.shape)}")
    _check("x", x, tuple(x.shape), x.device)
    if _on_cpu(x, "zstats_sincos"):
        return torch.stack([torch.sin(x), torch.cos(x)], dim=1)
    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    _launch("zstats_sincos", "les_micro_zstats_sincos", x.device, x.data_ptr(),
            out.data_ptr(), x.shape[0])
    return out


def zstats_reference(sp, sm, lm, wm, n: int) -> torch.Tensor:
    """The plain version of ``zstats``."""
    lmx, lmy = lm[:, 0:1], lm[:, 1:2]

    def z_of(sig):
        ddx = lmx - sig[:, 0]
        ddy = lmy - sig[:, 1]
        r = torch.sqrt(ddx * ddx + ddy * ddy)
        return r, wrap(atan2(ddy, ddx) - sig[:, 2])

    r_p, b_p = z_of(sp)
    r_m, b_m = z_of(sm)
    z_r = lane_sum(wm * (r_p + r_m))[:, None]
    sb = lane_sum(wm * (torch.sin(b_p) + torch.sin(b_m)))
    cb = lane_sum(wm * (torch.cos(b_p) + torch.cos(b_m)))
    z_b = atan2(sb, cb)[:, None]
    dr_p, dr_m = r_p - z_r, r_m - z_r
    db_p = wrap(b_p - z_b)
    db_m = wrap(b_m - z_b)
    s00 = lane_sum(wm * (dr_p * dr_p + dr_m * dr_m))
    s01 = lane_sum(wm * (dr_p * db_p + dr_m * db_m))
    s11 = lane_sum(wm * (db_p * db_p + db_m * db_m))
    out = torch.zeros_like(s00)
    for _ in range(n):
        out = out + s00 + s01 + s11
    return out
