"""PCA with JSON model files (mirror of ``compv_tpu/math/pca.py``; reference
CompVMathPCA, base/math/compv_math_pca.cxx): mean and principal axes by the
covariance's ``eigh``, projection, back-projection, save / load. The JSON
files are the reference's format: either package loads the other's.
Principal axes agree with the reference's up to sign. Every entry takes
float64 as float32 and int64 as int32 (``core.types.at_x64_off``).
"""
from __future__ import annotations

import json
from typing import NamedTuple

import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.device import require_cuda

__all__ = ["PcaModel", "pca_compute", "pca_project", "pca_backproject",
           "pca_save_json", "pca_load_json"]


class PcaModel(NamedTuple):
    mean: torch.Tensor        # (D,)
    vectors: torch.Tensor     # (K, D) principal axes, rows
    values: torch.Tensor      # (K,) eigenvalues, descending


@at_x64_off
def pca_compute(data: torch.Tensor, num_components: int) -> PcaModel:
    """(N, D) observations -> the top-K PCA model."""
    mean = data.mean(dim=0)
    centered = data - mean
    # divided by a device tensor: the card's division by a host scalar
    # multiplies by its reciprocal
    cov = centered.T @ centered / data.new_tensor(max(data.shape[0] - 1, 1))
    vals, vecs = torch.linalg.eigh(cov)
    vals = vals.flip(0)[:num_components]
    vecs = vecs.flip(1)[:, :num_components]
    return PcaModel(mean=mean, vectors=vecs.T.contiguous(), values=vals)


@at_x64_off
def pca_project(model: PcaModel, data: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, K)."""
    return (data - model.mean) @ model.vectors.T


@at_x64_off
def pca_backproject(model: PcaModel, proj: torch.Tensor) -> torch.Tensor:
    """(N, K) -> (N, D)."""
    return proj @ model.vectors + model.mean


def pca_save_json(model: PcaModel, path: str) -> None:
    obj = {name: getattr(model, name).detach().cpu().tolist()
           for name in ("mean", "vectors", "values")}
    with open(path, "w") as f:
        json.dump(obj, f)


def pca_load_json(path: str, device=None) -> PcaModel:
    """A model file of either package, as float32 tensors on ``device``
    (the card when none is given)."""
    with open(path) as f:
        obj = json.load(f)
    dev = device if device is not None else require_cuda()
    return PcaModel(*[torch.tensor(obj[name], dtype=torch.float32,
                                   device=dev)
                      for name in ("mean", "vectors", "values")])
