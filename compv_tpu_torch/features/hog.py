"""HOG (R-HOG) dense descriptor (mirror of ``compv_tpu/features/hog.py``;
reference CompVHogStd, core/features/hog/compv_core_feature_hog_std.cxx):
central-difference gradients -> magnitude and direction -> cell histograms
(nearest, bilinear or bilinear through a quantized direction) -> block
normalization (none, L1, L1-sqrt, L2, L2-Hys) -> (n_blocks_y, n_blocks_x,
block^2 * nbins) float32.

Numerics against the reference, which is jitted: XLA folds
``ang / span * nb`` into one product with f32(nb / span), and so does the
port (computed the other way, ~3,500 of 131,072 pixels of a scene crop
voted into another LUT step). XLA:CPU may also fuse ``gx*gx + gy*gy`` into
a multiply-add (on u8 images both products are exact), and its
``arctan2`` can differ from ``torch.atan2`` by an ulp. ``bilinear`` is
continuous in the angle and agrees within an absolute tolerance;
``nearest`` and ``bilinear_lut`` are step functions of it, and a pixel at
a step's edge can vote into the next bin (the tests count those pixels:
none of the 720p scene's 923,040 in any mode).

The cell histograms are one-hot votes summed over a (ch, cs, cw, cs, nb)
view, never ``index_add_``: float atomics would add in a run-to-run order
on the card, and this way two card runs are bit-identical.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["HogConfig", "hog_descriptor", "gradient_fast"]


@dataclass(frozen=True)
class HogConfig:
    cell_size: int = 8          # COMPV_HOG_SET_INT_CELL_SIZE (8x8)
    block_size: int = 2         # in cells (2x2)
    block_stride: int = 1       # in cells
    nbins: int = 9              # COMPV_HOG_SET_INT_NBINS
    norm: str = "l2hys"         # none | l1 | l1sqrt | l2 | l2hys
    signed_gradient: bool = False  # unsigned [0, 180) like the reference
    interp: str = "bilinear"    # nearest | bilinear | bilinear_lut
    lut_bins: int = 1024        # direction quantization of bilinear_lut
    l2hys_clip: float = 0.2


def gradient_fast(img: torch.Tensor):
    """Central-difference gradients with replicated borders (reference
    GradientFast): (gx, gy) float32."""
    f = img.to(torch.float32)
    fx = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    fy = torch.cat([f[:1], f, f[-1:]], dim=0)
    gx = (fx[:, 2:] - fx[:, :-2]) * 0.5
    gy = (fy[2:, :] - fy[:-2, :]) * 0.5
    return gx, gy


def _cell_hist(bins: torch.Tensor, vote: torch.Tensor, ch: int, cs: int,
               cw: int, nb: int) -> torch.Tensor:
    """(hh, ww) bins and votes -> (ch, cw, nb) sums over each cell. The
    one-hot is a comparison with the bin ids (``F.one_hot`` checks its
    input's range, which waits for the card)."""
    ids = torch.arange(nb, device=bins.device)
    v = (bins[..., None] == ids).to(torch.float32) * vote[..., None]
    return v.reshape(ch, cs, cw, cs, nb).sum(dim=(1, 3))


def _normalize(vec: torch.Tensor, config: HogConfig) -> torch.Tensor:
    eps = 1e-6
    if config.norm == "none":
        return vec
    if config.norm in ("l1", "l1sqrt"):
        out = vec / (vec.abs().sum(dim=-1, keepdim=True) + eps)
        return out.sqrt() if config.norm == "l1sqrt" else out

    def l2(v):
        return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + eps * eps)

    if config.norm == "l2":
        return l2(vec)
    if config.norm == "l2hys":
        return l2(l2(vec).clamp(0.0, config.l2hys_clip))
    raise ValueError(config.norm)


def hog_descriptor(img: torch.Tensor, config: HogConfig = HogConfig()
                   ) -> torch.Tensor:
    """(H, W) image -> (n_blocks_y, n_blocks_x, block^2 * nbins) float32.
    The image is cropped to whole cells. One with fewer cells a side than
    ``block_size - block_stride`` raises ``ValueError`` (the reference
    fails inside there, or returns a block count of -1 as 0)."""
    if config.interp not in ("nearest", "bilinear", "bilinear_lut"):
        raise ValueError(config.interp)
    h, w = img.shape
    cs, nb = config.cell_size, config.nbins
    ch, cw = h // cs, w // cs
    hh, ww = ch * cs, cw * cs
    bs, stride = config.block_size, config.block_stride
    if min(ch, cw) < bs - stride:
        raise ValueError(
            f"a {h}x{w} image holds {ch}x{cw} cells of {cs} px, short of a "
            f"{bs}x{bs}-cell block row or column")

    gx, gy = gradient_fast(img)
    gx, gy = gx[:hh, :ww], gy[:hh, :ww]
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)                       # [-pi, pi]
    span = 2 * math.pi if config.signed_gradient else math.pi
    ang = torch.where(ang < 0, ang + span, ang)
    # ang / span * nb, as XLA folds it: one product with f32(nb / span)
    pos = ang * torch.tensor(nb / span, dtype=torch.float32,
                             device=img.device)     # [0, nb)
    if config.interp == "bilinear_lut":
        # the direction quantized to lut_bins steps, each voting from its
        # step's representative angle: what indexing the reference's table
        # gives (divided by a device tensor: the card's division by a host
        # scalar multiplies by its reciprocal)
        q = torch.floor(pos / pos.new_tensor(nb) * config.lut_bins).clamp(
            0, config.lut_bins - 1)
        pos = (q + 0.5) * (nb / config.lut_bins)
    if config.interp == "nearest":
        b0 = torch.floor(pos).to(torch.int64).clamp(0, nb - 1)
        hist = _cell_hist(b0, mag, ch, cs, cw, nb)
    else:
        # bilinear vote into the two nearest bin centres (centres at k + 0.5)
        pc = pos - 0.5
        b0f = torch.floor(pc)
        frac = pc - b0f
        b0 = torch.remainder(b0f.to(torch.int64), nb)
        b1 = torch.remainder(b0 + 1, nb)
        hist = (_cell_hist(b0, mag * (1.0 - frac), ch, cs, cw, nb)
                + _cell_hist(b1, mag * frac, ch, cs, cw, nb))

    bs, stride = config.block_size, config.block_stride
    n_by = (ch - bs) // stride + 1
    n_bx = (cw - bs) // stride + 1
    dev = img.device
    idx_y = (torch.arange(n_by, device=dev) * stride)[:, None] + torch.arange(
        bs, device=dev)[None, :]
    idx_x = (torch.arange(n_bx, device=dev) * stride)[:, None] + torch.arange(
        bs, device=dev)[None, :]
    blocks = hist[idx_y][:, :, idx_x]               # (by, bs, bx, bs, nb)
    vec = blocks.permute(0, 2, 1, 3, 4).reshape(n_by, n_bx, bs * bs * nb)
    return _normalize(vec, config)
