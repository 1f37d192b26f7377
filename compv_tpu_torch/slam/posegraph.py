"""Pose-graph optimization over SE(3) (mirror of
``compv_tpu/slam/posegraph.py``).

Nodes are (rvec, tvec) world-from-camera poses; edges are relative-pose
measurements i -> j with scalar weights. An edge's residual is chordal, in
matrix form: vec(R_m^T R_i^T R_j - I) / sqrt(2) and R_m^T (R_i^T (t_j -
t_i) - t_m), smooth everywhere (a log map is not at theta = pi). The graph
is solved by damped Gauss-Newton on local pose increments, pose 0 fixed,
with J^T J + lam I solved matrix-free by a fixed number of CG iterations.

The reference applies J and J^T inside CG by ``jax.jvp`` and ``jax.vjp``
of the residuals in the increments. The port linearizes once per step
instead: ``torch.func.jacfwd`` (forward mode, the jvp against each basis
tangent) of one edge's residual in the increments of its two nodes, under
``torch.func.vmap``, gives (E, 12, 6) blocks for each end; J v and J^T u
are then the same linear maps as the reference's jvp and vjp, as products
with those blocks. A jvp and a vjp through ``torch.func`` at every CG
iteration would run the residual's rotations and products again inside
each matvec; with the blocks a matvec is a few batched products. The
gather of a node's increment onto its edges and the sum of the edges'
cotangents onto their nodes are outside the differentiated function: the
sum goes through per-node tables of edges (``slam.ba.index_table`` /
``segment_sum``, built once per solve), so it adds in the same order on
every run (the reference's vjp scatter-adds; on the card an
``index_add_`` would sum in a run-to-run order). The loops (steps, CG
iterations) never wait on the device.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.math.rotation import (matrix_to_rodrigues,
                                           rodrigues_to_matrix)
from compv_tpu_torch.slam.ba import index_table, segment_sum

__all__ = ["PoseGraph", "PoseGraphConfig", "compose", "invert",
           "relative_pose", "optimize_pose_graph", "graph_residuals"]


@at_x64_off(floats=("rvec_a", "tvec_a", "rvec_b", "tvec_b"))
def compose(rvec_a, tvec_a, rvec_b, tvec_b):
    """T_a . T_b as (rvec, tvec): R = Ra Rb, t = Ra tb + ta."""
    ra = rodrigues_to_matrix(rvec_a)
    rb = rodrigues_to_matrix(rvec_b)
    t = (ra @ tvec_b[..., None])[..., 0] + tvec_a
    return matrix_to_rodrigues(ra @ rb), t


@at_x64_off(floats=("rvec", "tvec"))
def invert(rvec, tvec):
    rt = rodrigues_to_matrix(rvec).transpose(-1, -2)
    return matrix_to_rodrigues(rt), -(rt @ tvec[..., None])[..., 0]


@at_x64_off(floats=("rvec_i", "tvec_i", "rvec_j", "tvec_j"))
def relative_pose(rvec_i, tvec_i, rvec_j, tvec_j):
    """T_i^-1 . T_j (what an odometry edge stores)."""
    ri, ti = invert(rvec_i, tvec_i)
    return compose(ri, ti, rvec_j, tvec_j)


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (N, 6) [rvec | tvec]
    edge_i: torch.Tensor       # (E,) i32
    edge_j: torch.Tensor       # (E,) i32
    edge_meas: torch.Tensor    # (E, 6) measured relative pose i -> j
    edge_weight: torch.Tensor  # (E,) f32
    edge_valid: torch.Tensor   # (E,) bool


@dataclass(frozen=True)
class PoseGraphConfig:
    iterations: int = 20
    cg_iterations: int = 30
    damping: float = 1e-3


_CHORDAL_SCALE = 0.70710678  # 1/sqrt(2): ||R - I||_F ~ sqrt(2) theta


def _residual_mat(r_i, t_i, r_j, t_j, r_m, t_m):
    """(E, 12) chordal residuals from batched matrices."""
    r_it = r_i.transpose(-1, -2)
    r_mt = r_m.transpose(-1, -2)
    r_err = r_mt @ (r_it @ r_j)
    t_rel = (r_it @ (t_j - t_i)[..., None])[..., 0]
    t_err = (r_mt @ (t_rel - t_m)[..., None])[..., 0]
    eye = torch.eye(3, dtype=r_err.dtype, device=r_err.device)
    rot = (r_err - eye).reshape(*r_err.shape[:-2], 9) * _CHORDAL_SCALE
    return torch.cat([rot, t_err], dim=-1)


@at_x64_off(floats=("poses",))
def graph_residuals(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """(E, 12) weighted residuals at ``poses``, zero at invalid edges."""
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    rot = rodrigues_to_matrix(poses[:, :3])
    res = _residual_mat(rot[ei], poses[ei, 3:], rot[ej], poses[ej, 3:],
                        rodrigues_to_matrix(graph.edge_meas[:, :3]),
                        graph.edge_meas[:, 3:])
    w = graph.edge_weight.clamp_min(0.0).sqrt()[:, None]
    return torch.where(graph.edge_valid[:, None], res * w, 0.0)


def _cg(matvec, b, iters: int):
    """Conjugate gradient from zero with a fixed iteration count."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.dot(b, b)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.dot(p, ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        beta = rs_new / rs.clamp_min(1e-30)
        p = r + beta * p
        rs = rs_new
    return x


@at_x64_off
def optimize_pose_graph(graph: PoseGraph,
                        config: PoseGraphConfig = PoseGraphConfig()):
    """Damped GN with CG on local pose increments; pose 0 fixed. Returns
    (graph with the optimized poses, final cost)."""
    n = graph.poses.shape[0]
    dtype, dev = graph.poses.dtype, graph.poses.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    mask = torch.ones((n, 6), dtype=dtype, device=dev)
    mask[0] = 0.0
    # the edges of each node, as the first (i) and as the second (j) end
    tab_i = index_table(ei, graph.edge_valid, n)[0]
    tab_j = index_table(ej, graph.edge_valid, n)[0]
    r_m = rodrigues_to_matrix(graph.edge_meas[:, :3])
    t_m = graph.edge_meas[:, 3:]
    w = torch.where(graph.edge_valid, graph.edge_weight.clamp_min(0.0).sqrt(),
                    0.0)[:, None]

    def residuals(rot, t):
        """(E, 12) weighted residuals of (N, 3, 3) rotations and (N, 3)."""
        return _residual_mat(rot[ei], t[ei], rot[ej], t[ej], r_m, t_m) * w

    def gather(v):
        return v[ei], v[ej]

    def scatter(gi, gj):
        return segment_sum(tab_i, gi) + segment_sum(tab_j, gj)

    poses = graph.poses
    lam = torch.tensor(config.damping, dtype=dtype, device=dev)
    for _ in range(config.iterations):
        # the current estimate in matrix form: increments enter only
        # through Exp(delta), never through a matrix -> rvec log
        r_cur = rodrigues_to_matrix(poses[:, :3])
        t_cur = poses[:, 3:]
        ri, ti = r_cur[ei], t_cur[ei]
        rj, tj = r_cur[ej], t_cur[ej]

        def edge_res(di, dj, ri_e, ti_e, rj_e, tj_e, rm_e, tm_e, w_e):
            """One edge's (12,) residual after the increments (6,) of its
            two nodes."""
            ri1 = ri_e @ rodrigues_to_matrix(di[:3])
            ti1 = ti_e + ri_e @ di[3:]
            rj1 = rj_e @ rodrigues_to_matrix(dj[:3])
            tj1 = tj_e + rj_e @ dj[3:]
            return _residual_mat(ri1, ti1, rj1, tj1, rm_e, tm_e) * w_e

        zero = torch.zeros((ei.shape[0], 6), dtype=dtype, device=dev)
        args = (zero, zero, ri, ti, rj, tj, r_m, t_m, w)
        r0 = torch.func.vmap(edge_res)(*args)                  # (E, 12)
        # the linearization at zero: (E, 12, 6) blocks for each end
        a_i, a_j = torch.func.vmap(torch.func.jacfwd(edge_res,
                                                     argnums=(0, 1)))(*args)
        cost0 = (r0 * r0).sum()

        def jt(u):
            """J^T u of (E, 12) cotangents, summed onto the (N, 6) nodes."""
            return scatter((a_i * u[..., None]).sum(1),
                           (a_j * u[..., None]).sum(1)) * mask

        g = jt(r0)

        def mv(v):
            vm = v.reshape(n, 6) * mask
            vi, vj = gather(vm)
            jv = (a_i @ vi[..., None])[..., 0] + (a_j @ vj[..., None])[..., 0]
            return (jt(jv) + lam * vm).reshape(-1)

        d = _cg(mv, -g.reshape(-1), config.cg_iterations).reshape(n, 6) * mask
        r_new = r_cur @ rodrigues_to_matrix(d[:, :3])
        t_new = t_cur + (r_cur @ d[:, 3:, None])[..., 0]
        res1 = residuals(r_new, t_new)
        better = (res1 * res1).sum() < cost0
        # the rvec conversion is value-only (outside AD)
        poses1 = torch.cat([matrix_to_rodrigues(r_new), t_new], dim=1)
        poses = torch.where(better, poses1, poses)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    res = graph_residuals(poses, graph)
    return graph._replace(poses=poses), (res * res).sum()
