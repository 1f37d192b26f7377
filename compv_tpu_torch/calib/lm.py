"""Levenberg-Marquardt for small dense problems (mirror of
``compv_tpu/calib/lm.py``, which replaces the reference's vendored
lmfit-6.1 ``lmmin``, compv_core_calib_camera.cxx:1028,1117).

The Jacobian comes from ``torch.func.jacfwd`` (forward mode: residuals far
outnumber parameters), the damped normal equations are solved densely with
``torch.linalg.solve_ex``, and the damping schedule is a Python loop whose
state (parameters, lambda, cost) stays in tensors: the loop never waits on
the device. A step is taken where it lowers the cost and stays finite,
else lambda grows (the reference's selects).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

__all__ = ["LMConfig", "LMResult", "levenberg_marquardt"]


@dataclass(frozen=True)
class LMConfig:
    iterations: int = 30
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    min_diag: float = 1e-12


class LMResult(NamedTuple):
    params: torch.Tensor
    cost: torch.Tensor          # final sum of squared residuals
    initial_cost: torch.Tensor


def levenberg_marquardt(residual_fn: Callable[[torch.Tensor], torch.Tensor],
                        x0: torch.Tensor,
                        config: LMConfig = LMConfig()) -> LMResult:
    """Minimize ||residual_fn(x)||^2 from x0; residual_fn: (P,) -> (R,),
    written in torch ops that forward-mode AD can carry and whose
    Jacobian keeps x's dtype (TypeError otherwise)."""
    x = torch.as_tensor(x0)

    def with_value(v):
        r = residual_fn(v)
        return r, r

    jac_fn = torch.func.jacfwd(with_value, has_aux=True)
    r0 = residual_fn(x)
    c0 = (r0 * r0).sum()
    cost = c0
    lam = torch.tensor(config.init_lambda, dtype=x.dtype, device=x.device)
    for _ in range(config.iterations):
        j, r = jac_fn(x)                    # (R, P), (R,)
        if j.dtype != x.dtype:
            raise TypeError(
                f"residual_fn's Jacobian is {j.dtype} for {x.dtype} "
                "parameters: under forward-mode AD a 0-d tensor combined "
                "with a Python float comes out float64; use tensor constants")
        jtj = j.T @ j
        g = j.T @ r
        # Marquardt scaling: damp by the diagonal
        diag = torch.diagonal(jtj).clamp_min(config.min_diag)
        dx = torch.linalg.solve_ex(jtj + lam * torch.diag(diag), -g).result
        x_new = x + dx
        r_new = residual_fn(x_new)
        cost_new = (r_new * r_new).sum()
        improved = (cost_new < cost) & torch.isfinite(x_new).all()
        x = torch.where(improved, x_new, x)
        lam = torch.where(improved, lam * config.lambda_down,
                          lam * config.lambda_up)
        cost = torch.where(improved, cost_new, cost)
    return LMResult(params=x, cost=cost, initial_cost=c0)
