"""Bundle adjustment (mirror of ``compv_tpu/slam/ba.py``, single device).

State: cameras (F, 6) [rodrigues rvec | tvec], landmarks (L, 3), shared
intrinsics (fx, fy, cx, cy); observations in fixed-capacity padded arrays
cam_idx (O,), lm_idx (O,), uv (O, 2), valid (O,). The solver is damped
Gauss-Newton whose normal system (J^T J + lam I) dx = -J^T r is solved
matrix-free by a fixed number of CG iterations (optionally block-Jacobi
PCG), with the Jacobian linearized once per step into per-observation 2x6
and 2x3 blocks (``obs_jacobian_blocks``: ``torch.func.jacfwd`` under
``torch.func.vmap``, where the reference vmaps ``jax.jacfwd``).

J^T u is a sum over observations into the (F, 6) / (L, 3) parameter tables.
Where the reference index-adds (``.at[idx].add``), this port sums through an
(n, K) table of each index's observations (``index_table``, built once per
solve from the fixed indices: a stable sort and two searchsorted): a gather
and a sum over K. On the card an ``index_add_`` accumulates with atomics in
an order that changes from run to run, and ``run_sfm`` takes discrete
decisions on these sums; a gather-and-sum adds in the same order every run.

The block-Jacobi preconditioner inverts the damped 3x3 landmark blocks in
float64 and casts back, as the Schur step does: a landmark seen along one
ray has a block of order |J|^2 along the ray and lam across it, and the
float32 adjugate's det of such a block can round to 0 or below while the
float64 det stays positive.

Distributed (``psum_axis``, a ``parallel.mesh.FrameMesh``): each rank holds
the replicated parameters and its own observations, and the reference's
psums (the cost, J^T u, the preconditioner's blocks) are ordered sums over
the ranks (``parallel._collectives.ordered_sum``), so every rank applies
the same update. ``ba_step_reduce_scatter`` shards the CG state instead.

Left out: the TPU's camera one-hot (``_cam_onehot``: the reference builds it
only on a TPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.math.rotation import (matrix_to_rodrigues,
                                           rodrigues_to_matrix)

__all__ = ["BAProblem", "BAConfig", "rodrigues_to_matrix",
           "matrix_to_rodrigues", "project_points", "ba_residuals",
           "ba_solve", "ba_step", "ba_step_reduce_scatter", "reproj_rmse",
           "obs_jacobian_blocks",
           "index_table", "segment_sum", "inv3x3_spd"]


# ----------------------------------------------------------------- projection

class BAProblem(NamedTuple):
    cameras: torch.Tensor     # (F, 6) [rvec | tvec]
    landmarks: torch.Tensor   # (L, 3)
    intrinsics: torch.Tensor  # (4,) fx, fy, cx, cy
    cam_idx: torch.Tensor     # (O,) i32
    lm_idx: torch.Tensor      # (O,) i32
    uv: torch.Tensor          # (O, 2) observed pixels
    valid: torch.Tensor       # (O,) bool


@dataclass(frozen=True)
class BAConfig:
    iterations: int = 10        # outer damped-GN iterations
    cg_iterations: int = 20     # inner CG iterations per GN step
    damping: float = 1e-3       # initial LM lambda
    optimize_landmarks: bool = True
    optimize_cameras: bool = True
    robust_delta: float = 0.0   # >0: IRLS Cauchy-like down-weighting of
                                # observations with residual norm >> delta px
                                # (weights frozen per GN step)
    precondition: bool = False  # block-Jacobi PCG: per-camera 6x6 and
                                # per-landmark 3x3 diagonal blocks of
                                # J^T J + lam, inverted once per step


def _pinhole(pc: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    zc = pc[..., 2]
    z = torch.where(zc.abs() < 1e-9, zc.new_tensor(1e-9), zc)
    u = intr[0] * pc[..., 0] / z + intr[2]
    v = intr[1] * pc[..., 1] / z + intr[3]
    return torch.stack([u, v], -1)


def project_points(cameras: torch.Tensor, landmarks: torch.Tensor,
                   intrinsics: torch.Tensor, cam_idx: torch.Tensor,
                   lm_idx: torch.Tensor) -> torch.Tensor:
    """(O, 2) projected pixels for each observation: u = fx x / z + cx."""
    cam = cameras[cam_idx.long()]
    pts = landmarks[lm_idx.long()]
    rms = rodrigues_to_matrix(cam[:, :3])
    pc = (rms @ pts[:, :, None])[:, :, 0] + cam[:, 3:]
    return _pinhole(pc, intrinsics)


def ba_residuals(cameras: torch.Tensor, landmarks: torch.Tensor,
                 prob: BAProblem) -> torch.Tensor:
    """(O, 2) reprojection residuals, zero at invalid observations."""
    pred = project_points(cameras, landmarks, prob.intrinsics,
                          prob.cam_idx, prob.lm_idx)
    return torch.where(prob.valid[:, None], pred - prob.uv, 0.0)


def reproj_rmse(prob: BAProblem) -> torch.Tensor:
    r = ba_residuals(prob.cameras, prob.landmarks, prob)
    n = prob.valid.sum().clamp_min(1)
    return ((r * r).sum() / (2.0 * n)).sqrt()


# ----------------------------------------------------------------- blocks

def obs_jacobian_blocks(cameras, landmarks, intrinsics, cam_idx, lm_idx,
                        uv, valid):
    """Per-observation residual r (O, 2) and Jacobian blocks A = dr/dcam
    (O, 2, 6), B = dr/dlm (O, 2, 3), zero at invalid observations: one
    vmapped forward-mode Jacobian over the 9 parameters an observation
    touches, once per GN step."""

    def f(c, x, uv1):
        pc = rodrigues_to_matrix(c[:3]) @ x + c[3:]
        return _pinhole(pc, intrinsics) - uv1

    cams_o = cameras[cam_idx.long()]
    lms_o = landmarks[lm_idx.long()]
    r = torch.func.vmap(f)(cams_o, lms_o, uv)
    a, b = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1)))(
        cams_o, lms_o, uv)
    m2 = valid[:, None]
    m3 = valid[:, None, None]
    return (torch.where(m2, r, 0.0), torch.where(m3, a, 0.0),
            torch.where(m3, b, 0.0))


# ----------------------------------------------------------------- sums

def index_table(idx: torch.Tensor, valid: torch.Tensor, n: int,
                k: int | None = None):
    """((n, k) table, (n,) counts): row i lists the valid observations with
    ``idx == i`` in ascending order, padded with O (the zero row that
    ``segment_sum`` appends). A stable sort of the keys and two
    searchsorted, as the reference's ``_obs_of_lm_table``; ``k = None``
    takes the largest count (one wait for the device). Observations past
    ``k`` of an index are left out."""
    o = idx.shape[0]
    dev = idx.device
    key = torch.where(valid, idx.long(), n)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    ar = torch.arange(n, device=dev)
    starts = torch.searchsorted(key_sorted, ar, right=False)
    counts = torch.searchsorted(key_sorted, ar, right=True) - starts
    if k is None:
        k = max(int(counts.max()) if n else 0, 1)
    kk = torch.arange(k, device=dev)
    pos = starts[:, None] + kk[None, :]
    in_seg = kk[None, :] < counts[:, None]
    order_pad = torch.cat([order, torch.full((1,), o, dtype=order.dtype,
                                             device=dev)])
    table = torch.where(in_seg, order_pad[pos.clamp_max(o)], o)
    return table, counts


def segment_sum(table: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per row of ``table`` (n, K), the sum of the rows of ``vals`` (O, ...)
    it lists (index O reads zero): the deterministic index-add."""
    pad = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    return pad[table].sum(dim=1)


class _Tables(NamedTuple):
    cam: torch.Tensor   # (F, Kc) observations of each camera
    lm: torch.Tensor    # (L, Kl) observations of each landmark


def _tables(prob: BAProblem) -> _Tables:
    f, l = prob.cameras.shape[0], prob.landmarks.shape[0]
    return _Tables(index_table(prob.cam_idx, prob.valid, f)[0],
                   index_table(prob.lm_idx, prob.valid, l)[0])


# ----------------------------------------------------------------- solver

def _flatten(cams, lms):
    return torch.cat([cams.reshape(-1), lms.reshape(-1)])


def _unflatten(x, f, l):
    return x[: f * 6].reshape(f, 6), x[f * 6:].reshape(l, 3)


def _gauge_mask(f: int, l: int, cfg: BAConfig, dtype, device,
                cam_mask=None) -> torch.Tensor:
    """Parameter-space mask: camera 0 fixed (gauge), the False cameras of
    ``cam_mask`` (F,) frozen (windowed BA), and whatever the config
    freezes."""
    cam_m = torch.ones((f, 6), dtype=dtype, device=device)
    cam_m[0] = 0.0
    if cam_mask is not None:
        cam_m = cam_m * cam_mask.to(dtype)[:, None]
    if not cfg.optimize_cameras:
        cam_m = torch.zeros((f, 6), dtype=dtype, device=device)
    lm_m = (torch.ones if cfg.optimize_landmarks else torch.zeros)(
        (l, 3), dtype=dtype, device=device)
    return _flatten(cam_m, lm_m)


def _robust_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights w = delta / sqrt(delta^2 + |r|^2), (O,)."""
    d2 = torch.tensor(delta, dtype=r.dtype, device=r.device) ** 2
    return (d2 / (d2 + (r * r).sum(dim=1))).sqrt()


def _linearize(prob: BAProblem, cfg: BAConfig):
    """Entry residuals and Jacobian blocks of one GN step, IRLS-whitened
    when ``cfg.robust_delta > 0`` (weights from the step's entry
    residuals, frozen for the step). Returns (r0, A, B, w or None)."""
    r, a, b = obs_jacobian_blocks(prob.cameras, prob.landmarks,
                                  prob.intrinsics, prob.cam_idx,
                                  prob.lm_idx, prob.uv, prob.valid)
    if cfg.robust_delta <= 0:
        return r, a, b, None
    w = _robust_weights(r, cfg.robust_delta)
    return r * w[:, None], a * w[:, None, None], b * w[:, None, None], w


def inv3x3_spd(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) inverse of damped SPD 3x3 blocks
    (det > 0 by construction)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([ca, c * h - b * i, b * f - c * e], -1),
        torch.stack([cb, a * i - c * g, c * d - a * f], -1),
        torch.stack([cc, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _jv(a, b, cam_idx, lm_idx, dc, dl):
    """J v: the per-observation blocks against the gathered updates."""
    return ((a * dc[cam_idx.long()][:, None, :]).sum(-1)
            + (b * dl[lm_idx.long()][:, None, :]).sum(-1))


def _jtu(a, b, u, tables: _Tables):
    """J^T u summed into the (F, 6) / (L, 3) parameter tables."""
    au = (a * u[:, :, None]).sum(1)
    bu = (b * u[:, :, None]).sum(1)
    return segment_sum(tables.cam, au), segment_sum(tables.lm, bu)


def _cg(matvec, b, iters: int, precond=None):
    """Conjugate gradient with a fixed iteration count; ``precond``
    (z = M^-1 r) gives the PCG recurrence. Nothing waits on the device."""
    apply_m = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b)
    r = b
    p = apply_m(r)
    rs = torch.dot(r, p)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.dot(p, ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rs_new = torch.dot(r, z)
        beta = rs_new / rs.clamp_min(1e-30)
        p = z + beta * p
        rs = rs_new
    return x


def _psum(mesh):
    """x -> the ordered sum of x over ``mesh``'s ranks (identity without
    one)."""
    if mesh is None:
        return lambda x: x
    # imported here: parallel/ imports this module
    from compv_tpu_torch.parallel._collectives import ordered_sum
    return lambda x: ordered_sum(x, mesh)


def ba_step(prob: BAProblem, lam: torch.Tensor, cfg: BAConfig,
            psum_axis=None, *, cam_mask=None, tables: _Tables | None = None):
    """One damped-GN step. Returns (new BAProblem, new lambda,
    cost_before). ``tables`` are the observation tables of ``prob``'s
    indices (``ba_solve`` builds them once per solve); without them the
    step builds its own. With ``psum_axis`` (a ``FrameMesh``) ``prob``
    holds this rank's observations, and every sum over observations is
    summed over the ranks too."""
    f = prob.cameras.shape[0]
    l = prob.landmarks.shape[0]
    dtype, dev = prob.cameras.dtype, prob.cameras.device
    psum = _psum(psum_axis)
    if tables is None:
        tables = _tables(prob)
    mask = _gauge_mask(f, l, cfg, dtype, dev, cam_mask)
    mc, ml = _unflatten(mask, f, l)

    r0, a, b, w = _linearize(prob, cfg)
    cost = psum((r0 * r0).sum())

    def jt(u):
        gc, gl = _jtu(a, b, u, tables)
        return psum(_flatten(gc * mc, gl * ml))

    def jtj_mv(v):
        vm = v * mask
        dc, dl = _unflatten(vm, f, l)
        return jt(_jv(a, b, prob.cam_idx, prob.lm_idx, dc, dl)) + lam * vm

    precond = None
    if cfg.precondition:
        # block-Jacobi: the diagonal 6x6 / 3x3 blocks of J^T J + lam; the
        # gauge-fixed blocks are masked anyway, lam > 0 keeps each SPD
        aa = (a[:, :, :, None] * a[:, :, None, :]).sum(1).reshape(-1, 36)
        bb2 = (b[:, :, :, None] * b[:, :, None, :]).sum(1).reshape(-1, 9)
        hcc = (psum(segment_sum(tables.cam, aa)).reshape(f, 6, 6)
               + lam * torch.eye(6, dtype=dtype, device=dev))
        hll = (psum(segment_sum(tables.lm, bb2)).reshape(l, 3, 3)
               + lam * torch.eye(3, dtype=dtype, device=dev))
        minv_c = torch.linalg.inv_ex(hcc).inverse
        minv_l = inv3x3_spd(hll.double()).to(dtype)   # module docstring

        def precond(r):
            rc, rl = _unflatten(r * mask, f, l)
            zc = (minv_c @ rc[:, :, None])[:, :, 0]
            zl = (minv_l @ rl[:, :, None])[:, :, 0]
            return _flatten(zc, zl) * mask

    g = jt(r0)
    dx = _cg(jtj_mv, -g, cfg.cg_iterations, precond)
    x1 = _flatten(prob.cameras, prob.landmarks) + dx * mask
    cams1, lms1 = _unflatten(x1, f, l)
    return _accept(prob, cams1, lms1, w, lam, cost, psum)


def _accept(prob, cams1, lms1, w, lam, cost, psum):
    """The step's accept test: the new parameters where their (frozen-IRLS)
    cost is below ``cost``, lam halved; else the old ones, lam x 4."""
    r1 = ba_residuals(cams1, lms1, prob)
    if w is not None:
        r1 = r1 * w[:, None]
    cost1 = psum((r1 * r1).sum())

    improved = cost1 < cost
    cams = torch.where(improved, cams1, prob.cameras)
    lms = torch.where(improved, lms1, prob.landmarks)
    lam_new = torch.where(improved, lam * 0.5, lam * 4.0)
    return prob._replace(cameras=cams, landmarks=lms), lam_new, cost


def ba_step_reduce_scatter(prob: BAProblem, lam: torch.Tensor, cfg: BAConfig,
                           axis):
    """One damped-GN step with the CG state sharded over ``axis`` (a
    ``FrameMesh``; ``prob`` holds this rank's observations): each rank keeps
    its 1 / D of the padded parameter vector through CG, the full vector is
    all-gathered before each J v, and J^T u is reduce-scattered after it;
    the dot products and costs are ordered sums. The reference's
    ``ba_step_reduce_scatter``: it takes no preconditioner and no camera
    mask. Its reduction order differs from ``ba_step``'s."""
    from compv_tpu_torch.parallel._collectives import (
        all_gather_cat, reduce_scatter_ordered)
    from compv_tpu_torch.parallel.mesh import RowSharding

    f = prob.cameras.shape[0]
    l = prob.landmarks.shape[0]
    dtype, dev = prob.cameras.dtype, prob.cameras.device
    tables = _tables(prob)
    mask = _gauge_mask(f, l, cfg, dtype, dev)
    mc, ml = _unflatten(mask, f, l)
    n = f * 6 + l * 3
    pad = -n % axis.size
    rows = RowSharding(axis)

    psum = _psum(axis)

    def pad_v(v):
        return torch.cat([v, v.new_zeros(pad)]) if pad else v

    r0, a, b, w = _linearize(prob, cfg)
    cost = psum((r0 * r0).sum())

    def jt_local(u):
        gc, gl = _jtu(a, b, u, tables)
        return _flatten(gc * mc, gl * ml)          # this rank's partial

    def gather_full(v_shard):
        return all_gather_cat(v_shard, axis)[:n]

    def jtj_mv_shard(v_shard):
        vm = gather_full(v_shard) * mask
        dc, dl = _unflatten(vm, f, l)
        jv = _jv(a, b, prob.cam_idx, prob.lm_idx, dc, dl)
        return (reduce_scatter_ordered(pad_v(jt_local(jv)), axis)
                + lam * rows.shard(pad_v(vm)))

    rhs = -reduce_scatter_ordered(pad_v(jt_local(r0)), axis)
    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    rs = psum(torch.dot(rhs, rhs))
    for _ in range(cfg.cg_iterations):
        ap = jtj_mv_shard(p)
        alpha = rs / psum(torch.dot(p, ap)).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = psum(torch.dot(r, r))
        beta = rs_new / rs.clamp_min(1e-30)
        p = r + beta * p
        rs = rs_new

    x1 = _flatten(prob.cameras, prob.landmarks) + gather_full(x) * mask
    cams1, lms1 = _unflatten(x1, f, l)
    return _accept(prob, cams1, lms1, w, lam, cost, psum)


def ba_solve(prob: BAProblem, cfg: BAConfig = BAConfig(), cam_mask=None):
    """The damped-GN loop. Returns (problem, final cost). ``cam_mask`` (F,)
    bool freezes the False cameras (windowed BA). The observation tables
    are built once (one wait for the device); the loop itself never waits
    on it."""
    tables = _tables(prob)
    lam = torch.tensor(cfg.damping, dtype=prob.cameras.dtype,
                       device=prob.cameras.device)
    for _ in range(cfg.iterations):
        prob, lam, _ = ba_step(prob, lam, cfg, cam_mask=cam_mask,
                               tables=tables)
    r = ba_residuals(prob.cameras, prob.landmarks, prob)
    return prob, (r * r).sum()
