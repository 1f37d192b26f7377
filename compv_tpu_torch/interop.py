"""Moving configs, keypoints and results between ``compv_tpu`` and this
package.

No function here imports ``compv_tpu`` (its package init pulls in JAX):
configs are matched by class name and copied field by field, and
keypoints, results and state maps (label maps, seeded ``init`` maps)
travel as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from compv_tpu_torch.calib.checkerboard import (CheckerboardConfig,
                                                CheckerboardResult)
from compv_tpu_torch.calib.homography import HomographyConfig
from compv_tpu_torch.core.types import Keypoints, Lines
from compv_tpu_torch.features.canny import CannyConfig
from compv_tpu_torch.features.ccl import CclConfig, CclResult
from compv_tpu_torch.features.fast import FastConfig
from compv_tpu_torch.features.hough import HoughKhtConfig, HoughShtConfig
from compv_tpu_torch.features.mser import MserConfig, MserResult
from compv_tpu_torch.features.orb import OrbConfig
from compv_tpu_torch.slam.frontend import FrontendConfig

__all__ = ["config_from_reference", "keypoints_from_numpy",
           "keypoints_to_numpy", "result_from_numpy", "result_to_numpy"]

_CONFIGS = {c.__name__: c for c in (FrontendConfig, OrbConfig,
                                     HomographyConfig, FastConfig,
                                     CclConfig, MserConfig, CannyConfig,
                                     HoughShtConfig, HoughKhtConfig,
                                     CheckerboardConfig)}

_DTYPES = {"level": torch.int32, "valid": torch.bool}

# field dtypes of the fixed-capacity results, by result type
_RESULT_DTYPES = {
    CclResult: {"cx": torch.float32, "cy": torch.float32,
                "valid": torch.bool},
    MserResult: {"variation": torch.float32, "valid": torch.bool},
    Lines: {"rho": torch.float32, "theta": torch.float32,
            "strength": torch.float32, "valid": torch.bool},
}


def config_from_reference(cfg):
    """The port's counterpart of a ``compv_tpu`` config (FrontendConfig,
    OrbConfig, HomographyConfig, FastConfig, CclConfig, MserConfig,
    CannyConfig, HoughShtConfig, HoughKhtConfig or CheckerboardConfig),
    built field by field; nested configs are converted too."""
    cls = _CONFIGS.get(type(cfg).__name__)
    if cls is None or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"no port counterpart for {type(cfg).__name__}")
    values = {}
    for f in dataclasses.fields(cls):
        v = getattr(cfg, f.name)
        values[f.name] = (config_from_reference(v)
                          if dataclasses.is_dataclass(v) else v)
    return cls(**values)


def keypoints_from_numpy(kp, device=None) -> Keypoints:
    """Keypoints from anything with the Keypoints fields as attributes
    (a ``compv_tpu`` Keypoints, or a dict of arrays), on ``device``."""
    get = kp.__getitem__ if isinstance(kp, dict) else lambda k: getattr(kp, k)
    return Keypoints(*[
        torch.as_tensor(np.array(get(name)),
                        dtype=_DTYPES.get(name, torch.float32), device=device)
        for name in Keypoints._fields])


def keypoints_to_numpy(kp: Keypoints) -> dict[str, np.ndarray]:
    """{field: numpy array} of a port Keypoints (copied to the host)."""
    return {name: getattr(kp, name).detach().cpu().numpy()
            for name in Keypoints._fields}


def result_from_numpy(cls, res, device=None):
    """A port ``CclResult``, ``MserResult``, ``Lines`` or
    ``CheckerboardResult`` (``cls``) from anything with its fields as
    attributes (the ``compv_tpu`` result, or a dict of arrays), on
    ``device``; integer fields are i32, nested results are converted too."""
    get = res.__getitem__ if isinstance(res, dict) else (
        lambda k: getattr(res, k))
    if cls is CheckerboardResult:
        return CheckerboardResult(
            corners=torch.as_tensor(np.array(get("corners")),
                                    dtype=torch.float32, device=device),
            valid=torch.as_tensor(np.array(get("valid")), dtype=torch.bool,
                                  device=device),
            h_lines=result_from_numpy(Lines, get("h_lines"), device),
            v_lines=result_from_numpy(Lines, get("v_lines"), device))
    if cls not in _RESULT_DTYPES:
        raise TypeError(f"no numpy conversion for {cls.__name__}")
    dtypes = _RESULT_DTYPES[cls]
    return cls(*[
        torch.as_tensor(np.array(get(name)),
                        dtype=dtypes.get(name, torch.int32), device=device)
        for name in cls._fields])


def result_to_numpy(res) -> dict:
    """{field: numpy array} of a port ``CclResult``, ``MserResult``,
    ``Lines`` or ``CheckerboardResult`` (nested results as dicts)."""
    return {name: (result_to_numpy(v) if isinstance(v, tuple)
                   else v.detach().cpu().numpy())
            for name, v in zip(res._fields, res)}
