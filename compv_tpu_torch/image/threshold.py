"""Global and Otsu thresholding (mirror of ``compv_tpu/image/threshold.py``
``threshold_global``, ``otsu_value``, ``threshold_otsu``).

Otsu's between-class variance is float32 arithmetic on the histogram, and
its argmax can turn on the last bit of a prefix sum: the class moment
``cumsum(hist * bins)`` exceeds 2^24 on any image of more than ~66k pixels.
The reference's XLA:CPU build evaluates a 256-long f32 cumsum as 16 blocks
of 16: a sequential sum inside each block, plus a sequential exclusive sum
of the block totals. ``_cumsum_f32_256`` evaluates it in the same order,
so the threshold agrees bit for bit on every device (``torch.cumsum``
accumulates in double on the CPU and in float on the GPU, and would not).
"""
from __future__ import annotations

import torch

from compv_tpu_torch.image.histogram import histogram256

__all__ = ["threshold_global", "otsu_value", "threshold_otsu"]


def threshold_global(img: torch.Tensor, thresh, maxval: int = 255,
                     inverse: bool = False) -> torch.Tensor:
    """u8 in -> u8 binary out: out = (v > thresh) ? maxval : 0."""
    thresh = torch.as_tensor(thresh, dtype=torch.int32, device=img.device)
    m = img.to(torch.int32) > thresh
    if inverse:
        m = ~m
    return torch.where(m, torch.tensor(maxval, dtype=torch.uint8,
                                       device=img.device),
                       torch.tensor(0, dtype=torch.uint8, device=img.device))


def _cumsum_f32_256(v: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumsum of a (256,) f32 vector in XLA:CPU's order."""
    blocks = v.reshape(16, 16)
    inner = torch.empty_like(blocks)
    acc = torch.zeros(16, dtype=torch.float32, device=v.device)
    for j in range(16):
        acc = acc + blocks[:, j]
        inner[:, j] = acc
    before = torch.empty(16, dtype=torch.float32, device=v.device)
    run = torch.zeros((), dtype=torch.float32, device=v.device)
    for b in range(16):
        before[b] = run
        run = run + inner[b, 15]
    return (inner + before[:, None]).reshape(256)


def otsu_value(img: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold from the 256-bin histogram (maximize between-class
    variance), as in the reference's histogram-based Otsu. () i32; the
    first maximum wins, as with ``jnp.argmax``."""
    hist = histogram256(img).to(torch.float32)
    total = hist.sum()                         # exact: counts < 2^24
    bins = torch.arange(256, dtype=torch.float32, device=img.device)
    w0 = _cumsum_f32_256(hist)
    sum0 = _cumsum_f32_256(hist * bins)
    sum_all = sum0[-1]
    w1 = total - w0
    mu0 = sum0 / torch.clamp(w0, min=1e-9)
    mu1 = (sum_all - sum0) / torch.clamp(w1, min=1e-9)
    d = mu0 - mu1
    between = w0 * w1 * (d * d)
    between = torch.where((w0 > 0) & (w1 > 0), between, -1.0)
    return torch.argmax(between).to(torch.int32)


def threshold_otsu(img: torch.Tensor, maxval: int = 255):
    """Returns (binary u8 image, otsu threshold)."""
    t = otsu_value(img)
    return threshold_global(img, t, maxval), t
