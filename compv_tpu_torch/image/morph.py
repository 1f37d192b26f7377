"""Morphology: erode, dilate, open, close, gradient, top / black hat
(mirror of ``compv_tpu/image/morph.py``; reference CompVMathMorph,
base/math/compv_math_morph.cxx). Each operator is the minimum or maximum
over the structuring element's shifts of one padded buffer: integer images
pad with 255 (erode) or 0 (dilate), float images with +inf / -inf, as the
reference does. Exact on every device.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from compv_tpu_torch.core.types import at_x64_off, is_integer_dtype

__all__ = ["strel", "erode", "dilate", "open_", "close_", "morph_gradient",
           "top_hat", "black_hat"]


def strel(shape: str = "cross", size: int = 3) -> np.ndarray:
    """Structuring element (reference COMPV_MATH_MORPH_STREL_TYPE cross /
    rect); a copy of the reference's helper."""
    if shape == "rect":
        return np.ones((size, size), bool)
    if shape == "cross":
        s = np.zeros((size, size), bool)
        s[size // 2, :] = True
        s[:, size // 2] = True
        return s
    raise ValueError(shape)


def _morph(img: torch.Tensor, se, is_erode: bool) -> torch.Tensor:
    if isinstance(se, torch.Tensor):    # a host constant, as in the
        se = se.detach().cpu().numpy()  # reference; read where it lies
    se = np.asarray(se, bool)
    kh, kw = se.shape
    if is_integer_dtype(img.dtype):
        f = img.to(torch.int32)
        pad_v = 255 if is_erode else 0
    else:
        f = img.to(torch.float32)
        pad_v = float("inf") if is_erode else float("-inf")
    ph, pw = kh // 2, kw // 2
    h, w = f.shape[-2:]
    padded = F.pad(f, (pw, pw, ph, ph), value=pad_v)
    pick = torch.minimum if is_erode else torch.maximum
    acc = None
    for dy, dx in zip(*np.nonzero(se)):
        tap = padded[..., dy:dy + h, dx:dx + w]
        acc = tap if acc is None else pick(acc, tap)
    return acc.to(img.dtype)


@at_x64_off
def erode(img: torch.Tensor, se=None) -> torch.Tensor:
    return _morph(img, strel() if se is None else se, True)


@at_x64_off
def dilate(img: torch.Tensor, se=None) -> torch.Tensor:
    return _morph(img, strel() if se is None else se, False)


@at_x64_off
def open_(img: torch.Tensor, se=None) -> torch.Tensor:
    return dilate(erode(img, se), se)


@at_x64_off
def close_(img: torch.Tensor, se=None) -> torch.Tensor:
    return erode(dilate(img, se), se)


def _clipped_difference(a: torch.Tensor, b: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    return (a.to(torch.int32) - b.to(torch.int32)).clamp(0, 255).to(dtype)


@at_x64_off
def morph_gradient(img: torch.Tensor, se=None) -> torch.Tensor:
    return _clipped_difference(dilate(img, se), erode(img, se), img.dtype)


@at_x64_off
def top_hat(img: torch.Tensor, se=None) -> torch.Tensor:
    return _clipped_difference(img, open_(img, se), img.dtype)


@at_x64_off
def black_hat(img: torch.Tensor, se=None) -> torch.Tensor:
    return _clipped_difference(close_(img, se), img, img.dtype)
