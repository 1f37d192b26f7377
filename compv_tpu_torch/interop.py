"""Moving configs and keypoints between ``compv_tpu`` and this package.

Neither function imports ``compv_tpu`` (its package init pulls in JAX):
configs are matched by class name and copied field by field, and keypoints
travel as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from compv_tpu_torch.calib.homography import HomographyConfig
from compv_tpu_torch.core.types import Keypoints
from compv_tpu_torch.features.fast import FastConfig
from compv_tpu_torch.features.orb import OrbConfig
from compv_tpu_torch.slam.frontend import FrontendConfig

__all__ = ["config_from_reference", "keypoints_from_numpy",
           "keypoints_to_numpy"]

_CONFIGS = {c.__name__: c for c in (FrontendConfig, OrbConfig,
                                     HomographyConfig, FastConfig)}

_DTYPES = {"level": torch.int32, "valid": torch.bool}


def config_from_reference(cfg):
    """The port's counterpart of a ``compv_tpu`` config (FrontendConfig,
    OrbConfig, HomographyConfig or FastConfig), built field by field; nested
    configs are converted too."""
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
