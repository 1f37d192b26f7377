"""Bundle adjustment by explicit Schur-complement reduction (mirror of
``compv_tpu/slam/ba_schur.py``, single device).

Landmarks are eliminated analytically (their damped 3x3 Hessian blocks
invert in closed form) and the reduced camera system S = Hcc - W Hll^-1 W^T
is solved densely by a Cholesky factorization:

  * observations are grouped per landmark through a padded (L, K) index
    table (``_obs_of_lm_table``: one stable sort and two searchsorted; K a
    cap sized on the host from the data), so Hll, gl, the per-observation
    cross blocks U = Jc^T Jl and the back-substitution are dense einsums;
  * S is accumulated over landmark chunks of ``SchurConfig.lm_chunk`` in a
    host loop (the reference's ``lax.scan``): each chunk builds its (Lc, K,
    F) camera one-hot and contracts W and Z = U Y against it, so memory is
    O(Lc F 18 + F^2 36);
  * Hcc and gc, sums over observations per camera, go through the camera
    table of ``slam/ba.py`` (a gather and a sum), not an index-add: the
    same order every run on the card;
  * the step's linear algebra (Hcc, W, Y, S, the factorization, the
    back-substitution) runs in float64 from the float32 Jacobian blocks;
    the parameters, the costs and the accept test stay float32. A landmark
    seen from nearly one direction has Y = (Hll + lam)^-1 of order 1/lam
    along its ray, and W Y W^T cancels against Hcc: in float32 the entries
    of S carry errors far above the smallest eigenvalues of the window's
    cameras, so that S comes out indefinite on some steps and not on
    others by the luck of the rounding, and such a step is rejected. At
    the 128-frame golden (Schur, an 8-frame window) the port assembled in
    float32 failed to factor S on a fifth of its steps and drifted far
    past the golden's bar; assembled in float64 it factors every step and
    meets the golden (``chip_smoke.py --sfm-128``, PERF.md section 6).

Distributed (``psum_axis``, a ``parallel.mesh.FrameMesh``; each rank holds
its own observations): every accumulated term is a sum over observations,
so the ranks' partials, summed in rank order
(``parallel._collectives.ordered_sum``), give the dense system of all
observations on every rank. The W / Z chunks are summed before the W Y W^T
product (a landmark's observations may lie on several ranks, and the
product is bilinear); with ``SchurConfig.lm_partitioned`` (each landmark's
observations on one rank) the products are rank-local and S and its
right-hand side are summed after them. The sums carry float64, as the
local step holds.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.slam.ba import (BAProblem, _Tables, _psum,
                                     _robust_weights, ba_residuals,
                                     index_table, inv3x3_spd,
                                     obs_jacobian_blocks, segment_sum)

__all__ = ["SchurConfig", "ba_step_schur", "ba_solve_schur",
           "max_obs_per_landmark"]


@dataclass(frozen=True)
class SchurConfig:
    iterations: int = 10
    damping: float = 1e-3
    lm_chunk: int = 512          # landmarks eliminated per chunk
    lm_partitioned: bool = False  # obs sharding keeps each lm on one rank
    robust_delta: float = 0.0    # IRLS (Cauchy-like) whitening, matching
                                 # BAConfig.robust_delta


def max_obs_per_landmark(lm_idx, valid, num_landmarks: int) -> int:
    """Host-side helper: the per-landmark observation cap of the Schur step,
    rounded up to a multiple of 4 (the reference's rule)."""
    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") \
            else np.asarray(x)

    li = host(lm_idx)[host(valid)]
    k = int(np.bincount(li, minlength=num_landmarks).max()) if li.size else 1
    return max(4, -4 * (-k // 4))


def _obs_of_lm_table(lm_idx, valid, l: int, k: int, o: int):
    """(L, K) table of observation indices per landmark (pad = o, the zero
    row appended before a gather) and the (L,) counts."""
    del o     # the pad is the observation count, which index_table reads
    return index_table(lm_idx, valid, l, k)


def _schur_tables(prob: BAProblem, k: int) -> _Tables:
    f, l = prob.cameras.shape[0], prob.landmarks.shape[0]
    return _Tables(index_table(prob.cam_idx, prob.valid, f)[0],
                   _obs_of_lm_table(prob.lm_idx, prob.valid, l, k,
                                    prob.cam_idx.shape[0])[0])


@at_x64_off
def ba_step_schur(prob: BAProblem, lam: torch.Tensor, cfg: SchurConfig,
                  psum_axis=None, *, max_obs_per_lm: int = 16, cam_mask=None,
                  tables: _Tables | None = None):
    """One damped-GN step with explicit Schur elimination of landmarks.
    Camera 0 is gauge-fixed, and so is every False camera of ``cam_mask``.
    Returns (new prob, new lam, cost_before).

    Observations beyond the cap ``max_obs_per_lm`` of a landmark are left
    out of the step on both sides (``ba_solve_schur`` sizes the cap from
    the data). ``tables`` (camera and landmark observation tables, built
    once by ``ba_solve_schur``) are built here when not given. With
    ``psum_axis`` (a ``FrameMesh``) ``prob`` holds this rank's observations
    and the sums are summed over the ranks (module docstring)."""
    f = prob.cameras.shape[0]
    l = prob.landmarks.shape[0]
    o = prob.cam_idx.shape[0]
    k = max_obs_per_lm
    dtype, dev = prob.cameras.dtype, prob.cameras.device
    psum = _psum(psum_axis)
    if tables is None:
        tables = _schur_tables(prob, k)

    r, jc, jl = obs_jacobian_blocks(prob.cameras, prob.landmarks,
                                    prob.intrinsics, prob.cam_idx,
                                    prob.lm_idx, prob.uv, prob.valid)
    w = None
    if cfg.robust_delta > 0:
        w = _robust_weights(r, cfg.robust_delta)
        r = r * w[:, None]
        jc = jc * w[:, None, None]
        jl = jl * w[:, None, None]
    cost = psum((r * r).sum())
    # the linear algebra in float64 (module docstring); the parameters, the
    # costs and the accept test stay in the problem's dtype
    r, jc, jl = r.double(), jc.double(), jl.double()
    dtype = torch.float64
    lam64 = lam.to(dtype)

    # the camera side keeps only the observations the landmark table holds
    table = tables.lm
    kept = torch.zeros((o + 1,), dtype=torch.bool, device=dev)
    kept[table.reshape(-1)] = True
    kept = kept[:o]
    jc_k = torch.where(kept[:, None, None], jc, 0.0)
    r_k = torch.where(kept[:, None], r, 0.0)
    hcc = segment_sum(tables.cam, torch.einsum("oia,oib->oab", jc_k, jc_k))
    gc = segment_sum(tables.cam, torch.einsum("oia,oi->oa", jc_k, r_k))
    hcc, gc = psum(hcc), psum(gc)

    def zpad(x):
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])

    jc_l = zpad(jc)[table]                        # (L, K, 2, 6)
    jl_l = zpad(jl)[table]                        # (L, K, 2, 3)
    r_l = zpad(r)[table]                          # (L, K, 2)
    cam_l = torch.cat([prob.cam_idx.long(),
                       torch.full((1,), f, dtype=torch.long,
                                  device=dev)])[table]      # (L, K), pad f

    hll = psum(torch.einsum("lkia,lkib->lab", jl_l, jl_l))    # (L, 3, 3)
    gl = psum(torch.einsum("lkia,lki->la", jl_l, r_l))        # (L, 3)
    u = torch.einsum("lkia,lkib->lkab", jc_l, jl_l)           # (L, K, 6, 3)
    # (L, K) blocks are the step's memory: merged tracks can give a
    # landmark thousands of observations
    del jc_l, jl_l, r_l

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    hcc_d = hcc + lam64 * eye6
    y = inv3x3_spd(hll + lam64 * eye3)                        # (L, 3, 3)
    z = torch.einsum("lkab,lbc->lkac", u, y)                  # (L, K, 6, 3)

    # reduced camera system, accumulated over landmark chunks
    s_off = torch.zeros((f, 6, f, 6), dtype=dtype, device=dev)
    rhs_red = torch.zeros((f, 6), dtype=dtype, device=dev)
    cams_f = torch.arange(f, device=dev)
    lc = min(cfg.lm_chunk, l)
    starts = range(0, l, lc)
    if psum_axis is not None:
        # a chunk in which no rank holds an observation adds exactly zero:
        # its sums are skipped (one small sum and one wait decide which)
        held = torch.stack([(table[c0:c0 + lc] < o).any() for c0 in starts])
        starts = [c0 for c0, n in zip(starts, psum(held.to(torch.int32))
                                      .tolist()) if n]
    for c0 in starts:
        sl = slice(c0, c0 + lc)
        onehot = (cam_l[sl][:, :, None] == cams_f).to(dtype)  # (lc, K, F)
        w_ch = torch.einsum("pkf,pkab->pfab", onehot, u[sl])
        z_ch = torch.einsum("pkf,pkab->pfab", onehot, z[sl])
        if not cfg.lm_partitioned:
            # a landmark's W sums observations of every rank, and W Y W^T
            # is bilinear: sum before the product
            w_ch, z_ch = psum(torch.stack([w_ch, z_ch]))
        s_off -= torch.einsum("pfab,pgcb->fagc", z_ch, w_ch)
        rhs_red -= torch.einsum("pfab,pb->fa", z_ch, gl[sl])
    if cfg.lm_partitioned:
        # the ranks that hold none of a landmark's observations add zero
        s_off, rhs_red = psum(s_off), psum(rhs_red)

    s = s_off.permute(0, 2, 1, 3).clone()                     # (F, F, 6, 6)
    s[cams_f, cams_f] += hcc_d
    rhs_c = gc + rhs_red

    # gauge: pin camera 0 and the cameras cam_mask freezes (identity block,
    # zero right-hand side)
    pin = torch.zeros((f,), dtype=torch.bool, device=dev)
    pin[0] = True
    if cam_mask is not None:
        pin = pin | ~cam_mask
    keep = (~pin).to(dtype)
    s = s * keep[:, None, None, None] * keep[None, :, None, None]
    s[cams_f, cams_f] += eye6[None] * pin.to(dtype)[:, None, None]
    rhs_c = rhs_c * keep[:, None]

    # S is SPD after damping and pinning in exact arithmetic. As the
    # reference's cho_factor (lower=False): the factor of S's upper triangle
    # (the lower one of S^T), NaN where it fails, so the step is rejected
    # and lam grows (cholesky_ex alone would hand back a partial factor).
    # Nothing waits on the info.
    s_mat = s.permute(0, 2, 1, 3).reshape(6 * f, 6 * f)
    fac = torch.linalg.cholesky_ex(s_mat.mT)
    chol = torch.where(fac.info == 0, fac.L, torch.nan)
    dx_c = -torch.cholesky_solve(rhs_c.reshape(-1, 1), chol).reshape(f, 6)

    # back-substitute landmarks: dl = -Y (gl + W^T dx_c)
    dc_pad = torch.cat([dx_c, dx_c.new_zeros((1, 6))])
    wt_dx = psum(torch.einsum("lkab,lka->lb", u, dc_pad[cam_l]))  # (L, 3)
    dx_l = -torch.einsum("lab,lb->la", y, gl + wt_dx)

    cams1 = prob.cameras + dx_c.to(prob.cameras.dtype)
    lms1 = prob.landmarks + dx_l.to(prob.landmarks.dtype)
    r1 = ba_residuals(cams1, lms1, prob)
    if w is not None:
        r1 = r1 * w[:, None]          # frozen IRLS weights, like ba_step
    cost1 = psum((r1 * r1).sum())
    better = cost1 < cost
    cams = torch.where(better, cams1, prob.cameras)
    lms = torch.where(better, lms1, prob.landmarks)
    lam_new = torch.where(better, lam * 0.5, lam * 4.0)
    return prob._replace(cameras=cams, landmarks=lms), lam_new, cost


@at_x64_off
def ba_solve_schur(prob: BAProblem, cfg: SchurConfig = SchurConfig(),
                   cam_mask=None):
    """Damped-GN loop of Schur steps. Returns (problem, final cost). Sizes
    the per-landmark cap from the data on the host, so no observation is
    dropped, and builds the observation tables once; the loop never waits
    on the device. ``cam_mask`` (F,) bool freezes the False cameras."""
    k = max_obs_per_landmark(prob.lm_idx, prob.valid,
                             prob.landmarks.shape[0])
    tables = _schur_tables(prob, k)
    lam = torch.tensor(cfg.damping, dtype=prob.cameras.dtype,
                       device=prob.cameras.device)
    for _ in range(cfg.iterations):
        prob, lam, _ = ba_step_schur(prob, lam, cfg, max_obs_per_lm=k,
                                     cam_mask=cam_mask, tables=tables)
    r = ba_residuals(prob.cameras, prob.landmarks, prob)
    return prob, (r * r).sum()
