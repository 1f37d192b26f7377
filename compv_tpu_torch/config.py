"""Config system: file-backed construction of the port's config dataclasses
(mirror of ``compv_tpu/config.py``).

Every algorithm exposes a frozen dataclass with the reference's defaults;
this module loads and saves them from JSON or a simple YAML, by name, so a
pipeline is configured reproducibly from a file. The 19 names are the
reference's, and a file either package saves loads in the other.

One difference from the reference: a JSON or YAML list read into a field
whose default is a tuple becomes a tuple again (``MserConfig.run_tiers``).
The reference keeps the list, so its loaded ``MserConfig`` is unequal to
the one it saved and cannot be hashed.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

__all__ = ["CONFIG_REGISTRY", "config_to_dict", "config_from_dict",
           "load_config", "save_config", "parse_simple_yaml"]


def _registry() -> Dict[str, Type]:
    from compv_tpu_torch.calib.camera import CalibrationConfig
    from compv_tpu_torch.calib.checkerboard import CheckerboardConfig
    from compv_tpu_torch.calib.homography import HomographyConfig
    from compv_tpu_torch.calib.lm import LMConfig
    from compv_tpu_torch.calib.ransac import RansacConfig
    from compv_tpu_torch.features.canny import CannyConfig
    from compv_tpu_torch.features.ccl import CclConfig
    from compv_tpu_torch.features.fast import FastConfig
    from compv_tpu_torch.features.hog import HogConfig
    from compv_tpu_torch.features.hough import HoughKhtConfig, HoughShtConfig
    from compv_tpu_torch.features.mser import MserConfig
    from compv_tpu_torch.features.orb import OrbConfig
    from compv_tpu_torch.matchers.bruteforce import MatcherConfig
    from compv_tpu_torch.ml.svm import SvmConfig
    from compv_tpu_torch.slam.ba import BAConfig
    from compv_tpu_torch.slam.frontend import FrontendConfig
    from compv_tpu_torch.slam.pipeline import PlanarTrackerConfig
    from compv_tpu_torch.slam.posegraph import PoseGraphConfig
    return {
        "fast": FastConfig, "orb": OrbConfig, "canny": CannyConfig,
        "hough_sht": HoughShtConfig, "hough_kht": HoughKhtConfig,
        "hog": HogConfig, "ccl": CclConfig, "mser": MserConfig,
        "matcher": MatcherConfig, "homography": HomographyConfig,
        "ransac": RansacConfig, "lm": LMConfig,
        "calibration": CalibrationConfig, "checkerboard": CheckerboardConfig,
        "ba": BAConfig, "frontend": FrontendConfig,
        "planar_tracker": PlanarTrackerConfig, "pose_graph": PoseGraphConfig,
        "svm": SvmConfig,
    }


CONFIG_REGISTRY: Dict[str, Type] = {}


def _ensure_registry():
    if not CONFIG_REGISTRY:
        CONFIG_REGISTRY.update(_registry())
    return CONFIG_REGISTRY


def config_to_dict(cfg: Any) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = config_to_dict(v) if dataclasses.is_dataclass(v) else v
    return out


def _as_tuple(v):
    """A list read from a file, as the tuple it was saved from."""
    return tuple(_as_tuple(x) for x in v) if isinstance(v, list) else v


def config_from_dict(name_or_cls, data: dict):
    """The config named ``name_or_cls`` (or of that class) with the fields
    in ``data``; missing fields keep their defaults, nested configs are
    built from nested dicts, and a list becomes a tuple where the field's
    default is one."""
    cls = (_ensure_registry()[name_or_cls] if isinstance(name_or_cls, str)
           else name_or_cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            kwargs[f.name] = config_from_dict(type(f.default), v)
        elif isinstance(f.default, tuple):
            kwargs[f.name] = _as_tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def parse_simple_yaml(text: str) -> dict:
    """Minimal YAML subset: ``key: scalar`` lines and nesting by
    indentation (the reference ships a mini-YAML too, compv_yaml.h:50-63)."""
    root: dict = {}
    stack = [(0, root)]
    for raw in text.splitlines():
        if not raw.strip() or raw.strip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        key, _, val = raw.strip().partition(":")
        val = val.strip()
        while stack and indent < stack[-1][0]:
            stack.pop()
        cur = stack[-1][1]
        if not val:
            child: dict = {}
            cur[key] = child
            stack.append((indent + 2, child))
        elif val.lower() in ("true", "false"):
            cur[key] = val.lower() == "true"
        else:
            try:
                cur[key] = int(val)
            except ValueError:
                try:
                    cur[key] = float(val)
                except ValueError:
                    cur[key] = val.strip("'\"")
    return root


def load_config(path: str, name: str):
    """Load ``name``'s config dataclass from a JSON or YAML file holding
    {name: {field: value, ...}, ...}."""
    with open(path) as f:
        text = f.read()
    data = (json.loads(text) if path.endswith(".json")
            else parse_simple_yaml(text))
    return config_from_dict(name, data.get(name, {}))


def save_config(path: str, **configs) -> None:
    """Write ``name=config`` pairs as one JSON object."""
    obj = {k: config_to_dict(v) for k, v in configs.items()}
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
