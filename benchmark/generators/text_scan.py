"""The ``text_scan`` generator: a pool of scanned text pages.

A mix of this kind (``traffic/<mix>.json`` with ``"kind": "text_scan"``)
sets the page size, the pool, and the recipe of ``bench.py``'s text scene
(``_images()``): a ``background`` page with glyph rows every
``row_pitch`` px from ``row_start`` and glyph cells every ``col_pitch``
px from ``col_start``, a share ``empty_share`` of cells left empty; each
glyph a ``glyph_width`` x ``glyph_height`` box (ranges inclusive, clipped
``margin`` px short of the page's right and bottom edges) of random
strokes at ``fill``, thickened one pixel to the right inside its box, in
``ink``; then a Gaussian antialias (``blur_sigma``, taps to 4 sigma, edge
replicated) and sensor noise (``noise_sigma``), rounded and clamped to u8.
Layout from a NumPy generator, blur and noise on the device, all from the
seed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import scenes


def glyph_layer(p: dict, rng) -> np.ndarray:
    """(H, W) bool ink mask of one page."""
    h, w = p["height"], p["width"]
    my, mx = p["margin"]
    rows = np.arange(p["row_start"], h - my, p["row_pitch"])
    cols = np.arange(p["col_start"], w - mx, p["col_pitch"])
    gw_lo, gw_hi = p["glyph_width"]
    gh_lo, gh_hi = p["glyph_height"]
    nr, nc = len(rows), len(cols)
    used = rng.random((nr, nc)) >= p["empty_share"]
    gw = np.minimum(rng.integers(gw_lo, gw_hi + 1, (nr, nc)),
                    (w - mx - cols)[None, :])
    gh = np.minimum(rng.integers(gh_lo, gh_hi + 1, (nr, nc)),
                    (h - my - rows)[:, None])
    strokes = rng.random((nr, nc, gh_hi, gw_hi)) < p["fill"]
    inside = ((np.arange(gh_hi)[:, None] < gh[..., None, None])
              & (np.arange(gw_hi)[None, :] < gw[..., None, None])
              & used[..., None, None])
    glyph = strokes & inside
    glyph[..., 1:] |= glyph[..., :-1]          # strokes connect like type
    glyph &= inside
    cells = np.zeros((nr, p["row_pitch"], nc, p["col_pitch"]), bool)
    cells[:, :gh_hi, :, :gw_hi] = glyph.transpose(0, 2, 1, 3)
    ink = np.zeros((h, w), bool)
    y0, x0 = p["row_start"], p["col_start"]
    block = cells.reshape(nr * p["row_pitch"], nc * p["col_pitch"])
    block = block[:h - y0, :w - x0]
    ink[y0:y0 + block.shape[0], x0:x0 + block.shape[1]] = block
    return ink


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of a (P, H, W) float image, taps to 4 sigma, as
    weighted sums of shifted copies (no convolution library call)."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    h, w = img.shape[1:]
    out = F.pad(img[:, None], (r, r, r, r), mode="replicate")[:, 0]
    rows = sum(float(k[i]) * out[:, :, i:i + w] for i in range(2 * r + 1))
    return sum(float(k[i]) * rows[:, i:i + h] for i in range(2 * r + 1))


def make(p: dict, seed: int, device):
    """The pool: (P, H, W) u8 pages on ``device``."""
    rng = np.random.default_rng([int(seed), 2])
    gen = scenes.device_generator(rng.integers(1 << 62), device)
    ink = np.stack([glyph_layer(p, rng) for _ in range(p["pool"])])
    ink = torch.from_numpy(ink).to(device)
    page = torch.where(ink, float(p["ink"]), float(p["background"]))
    page = gaussian_blur(page, p["blur_sigma"])
    noise = torch.randn(page.shape, generator=gen, device=device)
    page = page + noise * p["noise_sigma"]
    return page.round().clamp(0, 255).to(torch.uint8)
