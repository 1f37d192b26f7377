"""Thresholding: global, Otsu, adaptive mean, Wolf-Jolion (mirror of
``compv_tpu/image/threshold.py``).

Otsu's between-class variance is float32 arithmetic on the histogram, and
its argmax can turn on the last bit of a prefix sum: the class moment
``cumsum(hist * bins)`` exceeds 2^24 on any image of more than ~66k pixels.
The reference's XLA:CPU build evaluates a 256-long f32 cumsum as 16 blocks
of 16: a sequential sum inside each block, plus a sequential exclusive sum
of the block totals. ``_cumsum_f32_256`` evaluates it in the same order,
so the threshold agrees bit for bit on every device (``torch.cumsum``
accumulates in double on the CPU and in float on the GPU, and would not).

The adaptive threshold's box mean is the port's ``convolve_separable``
(the reference's shift-and-add, tap by tap); Wolf's local moments are
``box_mean_var``'s exact int32 sums. Neither reference function is jitted,
so no fused multiply-add enters, and both outputs are bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from compv_tpu_torch.image.histogram import histogram256
from compv_tpu_torch.image.integral import box_mean_var
from compv_tpu_torch.ops.conv import convolve_separable

__all__ = ["threshold_global", "otsu_value", "threshold_otsu",
           "threshold_adaptive", "threshold_wolf"]


def threshold_global(img: torch.Tensor, thresh, maxval: int = 255,
                     inverse: bool = False) -> torch.Tensor:
    """u8 in -> u8 binary out: out = (v > thresh) ? maxval : 0."""
    thresh = torch.as_tensor(thresh, dtype=torch.int32, device=img.device)
    m = img.to(torch.int32) > thresh
    if inverse:
        m = ~m
    return _binary(m, maxval)


def _binary(m: torch.Tensor, maxval: int) -> torch.Tensor:
    """maxval where ``m``, else 0, as u8."""
    return torch.where(m, torch.tensor(maxval, dtype=torch.uint8,
                                       device=m.device),
                       torch.tensor(0, dtype=torch.uint8, device=m.device))


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


def threshold_adaptive(img: torch.Tensor, block_size: int = 5,
                       delta: float = 8.0, maxval: int = 255,
                       inverse: bool = False) -> torch.Tensor:
    """Adaptive mean threshold: out = (v > mean_block - delta) ? maxval : 0,
    the box mean by a separable convolution with replicated borders."""
    k = np.full((block_size,), 1.0 / block_size, np.float32)
    mean = convolve_separable(img, k, k, border="replicate")
    m = img.to(torch.float32) > (mean - delta)
    if inverse:
        m = ~m
    return _binary(m, maxval)


def threshold_wolf(img: torch.Tensor, block_size: int = 41, k: float = 0.5,
                   maxval: int = 255) -> torch.Tensor:
    """Wolf-Jolion local binarization: T = (1-k) m + k M + k (s / R)(m - M)
    with local mean m and standard deviation s over clipped windows, the
    global minimum M and R the largest local s."""
    mean, var = box_mean_var(img, block_size)
    std = torch.sqrt(var)
    f = img.to(torch.float32)
    m_glob = f.min()
    r = torch.clamp_min(std.max(), 1e-9)
    t = (1.0 - k) * mean + k * m_glob + k * (std / r) * (mean - m_glob)
    return _binary(f > t, maxval)
