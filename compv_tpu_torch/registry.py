"""Factory registry: create detectors, edge detectors and matchers by name
(mirror of ``compv_tpu/registry.py``).

The reference library registers its algorithms at init and instantiates
them through id-based factories (compv_features.h:166-261,
compv_core.cxx:149-160). Here the same late-binding surface exists by
name: each factory returns a (function, default config) pair. The
functions are the port's, and run on the device of their input tensor.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

__all__ = ["create_detector", "create_matcher", "create_edge_detector",
           "list_algorithms"]


def create_detector(name: str, **overrides) -> Tuple[Callable, Any]:
    """'fast' | 'orb' | 'mser' -> (fn(img, config) -> result, config)."""
    if name == "fast":
        from compv_tpu_torch.features.fast import FastConfig, fast_detect
        return fast_detect, FastConfig(**overrides)
    if name == "orb":
        from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
        return orb_detect_describe, OrbConfig(**overrides)
    if name == "mser":
        from compv_tpu_torch.features.mser import MserConfig, mser_detect
        return mser_detect, MserConfig(**overrides)
    raise KeyError(f"unknown detector {name!r}; have fast|orb|mser")


def create_edge_detector(name: str, **overrides) -> Tuple[Callable, Any]:
    """'sobel' | 'scharr' | 'prewitt' -> (fn(img, cfg=None), None);
    'canny' -> (canny, CannyConfig)."""
    if name in ("sobel", "scharr", "prewitt"):
        from compv_tpu_torch.features.edges import edge_detect
        return (lambda img, cfg=None, _op=name: edge_detect(img, _op)), None
    if name == "canny":
        from compv_tpu_torch.features.canny import CannyConfig, canny
        return canny, CannyConfig(**overrides)
    raise KeyError(f"unknown edge detector {name!r}")


def create_matcher(name: str, **overrides) -> Tuple[Callable, Any]:
    """'bruteforce' -> (fn(q_bits, t_bits, config, ...), config). (The
    reference's FLANN matcher is an empty stub; the ANN equivalent is
    ``ml.ann_build`` / ``ml.ann_search``.)"""
    if name == "bruteforce":
        from compv_tpu_torch.matchers.bruteforce import (MatcherConfig,
                                                         match_bruteforce)
        return match_bruteforce, MatcherConfig(**overrides)
    raise KeyError(f"unknown matcher {name!r}")


def list_algorithms() -> Dict[str, list]:
    return {
        "detectors": ["fast", "orb", "mser"],
        "edges": ["sobel", "scharr", "prewitt", "canny"],
        "hough": ["sht", "kht"],
        "matchers": ["bruteforce"],
        "ccl": ["pointer-jumping (LSL-equivalent)"],
        "hog": ["std"],
    }
