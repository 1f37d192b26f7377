"""Axis-angle rotations (``compv_tpu/slam/ba.py``'s rotation helpers,
re-exported by ``slam/ba.py``). They live here, below both ``calib`` and
``slam``, so that the RANSAC modules can use them without importing the SLAM
package. Both take leading batch dimensions.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import at_x64_off

__all__ = ["rodrigues_to_matrix", "matrix_to_rodrigues"]


def _skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


@at_x64_off(floats=("rvec",))
def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)
    (CompVMathTrig::rodriguesVectorToMatrix, compv_math_trig.h:22-35).
    Both branches are made finite before the select, so the small-angle
    series never meets a 0/0 and gradients stay finite at theta = 0."""
    theta2 = (rvec * rvec).sum(-1)
    small = theta2 < 1e-12
    # constants as tensors of the input's type: under forward-mode AD a
    # 0-d tensor divided by a Python float comes out float64
    one, six, n24 = (theta2.new_tensor(v) for v in (1.0, 6.0, 24.0))
    theta2_safe = torch.where(small, one, theta2)
    theta = theta2_safe.sqrt()
    a = torch.where(small, 1.0 - theta2 / six, theta.sin() / theta)
    b = torch.where(small, 0.5 - theta2 / n24,
                    (1.0 - theta.cos()) / theta2_safe)
    km = _skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * km + b[..., None, None] * (km @ km)


@at_x64_off(floats=("r",))
def matrix_to_rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3). Three
    select-safe branches: the small-angle series, the general w theta /
    (2 sin theta), and near pi, where the axis comes from the diagonal of
    (R + I) / 2 with signs from its dominant row."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = ((tr - 1.0) * 0.5).clamp(-1.0, 1.0)
    theta = cos_t.clamp(-1.0 + 1e-7, 1.0 - 1e-7).arccos()
    w = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1)
    small = theta < 1e-4
    near_pi = cos_t < -0.999
    theta_safe = torch.where(small | near_pi, 1.0, theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta_safe / (2.0 * theta_safe.sin()))
    rvec_general = w * scale[..., None]

    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    b = (r + eye) * 0.5
    axis = torch.diagonal(b, dim1=-2, dim2=-1).clamp(0.0, 1.0).sqrt()
    k = axis.argmax(-1)
    row = torch.gather(b, -2, k[..., None, None].expand(
        *k.shape, 1, 3))[..., 0, :]
    own = torch.arange(3, device=r.device) == k[..., None]
    signs = torch.where(own, 1.0, torch.where(row >= 0, 1.0, -1.0))
    axis_n = axis * signs
    axis_n = axis_n / torch.linalg.vector_norm(
        axis_n, dim=-1, keepdim=True).clamp_min(1e-12)
    rvec_pi = axis_n * cos_t.arccos()[..., None]
    return torch.where(near_pi[..., None], rvec_pi, rvec_general)
