"""Color conversion (mirror of ``compv_tpu/image/color.py``; reference
base/image/compv_image_conv_*.cxx): any -> gray, RGB <-> YUV (444, I420,
NV12, NV21, I422, YUYV, UYVY), HSV, HSL, RGB565, channel split / merge.

The same fixed-point arithmetic as the reference, on int32, where ``>>`` is
the arithmetic shift of C, so u8 outputs are bit-exact
(compv_image_conv_common.cxx:29-41, :196-215):

    Y = ((33R + 65G + 13B) >> 7) + 16
    U = ((-38R - 74G + 112B) >> 8) + 128
    V = ((112R - 94G - 18B) >> 8) + 128
    R = (37Y' + 51V') >> 5,  G = (37Y' - 13U' - 26V') >> 5,
    B = (37Y' + 65U') >> 5     (Y' = Y - 16, U' = U - 128, V' = V - 128)

HSV and HSL keep the reference's float32 operation order (``255 c / v``,
``30 (g - b) / c``) and round half to even. A division by a constant
divides by a 0-d tensor on the input's device: PyTorch's CUDA division by
a host scalar multiplies by its reciprocal instead, which is not the
correctly rounded quotient of the CPU and the reference. The 565 paths
work in int32 (PyTorch has no ``>>`` for uint16 on the CPU) and return
``torch.uint16`` where the reference returns u16. Chroma is upsampled by
repetition, the reference's branch off the TPU.

Images are channel-last: gray (H, W) u8, RGB (H, W, 3) u8; planar YUV comes
as separate planes.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import at_x64_off

__all__ = [
    "rgb_to_gray", "bgr_to_gray", "rgba_to_gray",
    "rgb_to_yuv444", "yuv_to_rgb", "i420_to_rgb", "nv12_to_rgb",
    "nv21_to_rgb", "yuyv_to_rgb", "uyvy_to_rgb", "i422_to_rgb",
    "rgb_to_i420", "rgb_to_hsv", "yuv444_to_hsv",
    "split_channels", "merge_channels", "to_gray", "rgb_to_hsl",
    "rgb565_to_rgb", "rgb_to_rgb565",
]


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _clamp_u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------- to gray

def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) u8 RGB -> (H,W) u8 luma."""
    c = _i32(rgb)
    y = ((33 * c[..., 0] + 65 * c[..., 1] + 13 * c[..., 2]) >> 7) + 16
    return _clamp_u8(y)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    # reordered as int32: PyTorch's CUDA indexing has no uint16 / uint32
    return rgb_to_gray(_i32(bgr)[..., [2, 1, 0]])


def rgba_to_gray(rgba: torch.Tensor) -> torch.Tensor:
    return rgb_to_gray(rgba[..., :3])


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """Any->gray facade: channel-last u8 in, (H,W) u8 out."""
    if img.ndim == 2:
        return img.to(torch.uint8)
    c = img.shape[-1]
    if c in (3, 4):
        return rgb_to_gray(img[..., :3])
    raise ValueError(f"unsupported channel count {c}")


# ---------------------------------------------------------------- RGB -> YUV

def rgb_to_yuv444(rgb: torch.Tensor):
    """(H,W,3) u8 -> (Y, U, V) planes, each (H,W) u8."""
    c = _i32(rgb)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = ((33 * r + 65 * g + 13 * b) >> 7) + 16
    u = ((-38 * r - 74 * g + 112 * b) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b) >> 8) + 128
    return _clamp_u8(y), _clamp_u8(u), _clamp_u8(v)


def rgb_to_i420(rgb: torch.Tensor):
    """(H,W,3) u8 -> I420 planes Y (H,W), U / V (H/2, W/2): chroma is the
    top-left sample of each 2x2 block, as the reference subsamples."""
    y, u, v = rgb_to_yuv444(rgb)
    return y, u[::2, ::2], v[::2, ::2]


# ---------------------------------------------------------------- YUV -> RGB

def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Full-resolution Y, U, V planes (H,W) u8 -> (H,W,3) u8 RGB."""
    yp = _i32(y) - 16
    up = _i32(u) - 128
    vp = _i32(v) - 128
    t = 37 * yp
    r = (t + 51 * vp) >> 5
    g = (t - 13 * up - 26 * vp) >> 5
    b = (t + 65 * up) >> 5
    return torch.stack([_clamp_u8(r), _clamp_u8(g), _clamp_u8(b)], dim=-1)


def _upsample_cols(p: torch.Tensor, w: int) -> torch.Tensor:
    """Nearest 2x column upsample (H, W2) -> (H, w)."""
    return p.repeat_interleave(2, dim=1)[:, :w]


def _upsample2(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest 2x chroma upsample to (h, w)."""
    return _upsample_cols(p.repeat_interleave(2, dim=0)[:h], w)


def i420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    h, w = y.shape
    return yuv_to_rgb(y, _upsample2(u, h, w), _upsample2(v, h, w))


def _pairs(uv: torch.Tensor) -> torch.Tensor:
    if uv.ndim == 2:
        return uv.reshape(uv.shape[0], uv.shape[1] // 2, 2)
    return uv


def nv12_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """NV12: interleaved chroma (H/2, W/2, 2) or (H/2, W), U first."""
    uv = _pairs(uv)
    h, w = y.shape
    return yuv_to_rgb(y, _upsample2(uv[..., 0], h, w),
                      _upsample2(uv[..., 1], h, w))


def nv21_to_rgb(y: torch.Tensor, vu: torch.Tensor) -> torch.Tensor:
    """NV21: interleaved chroma, V first."""
    vu = _pairs(vu)
    h, w = y.shape
    return yuv_to_rgb(y, _upsample2(vu[..., 1], h, w),
                      _upsample2(vu[..., 0], h, w))


def i422_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """I422: U / V are (H, W/2)."""
    w = y.shape[1]
    return yuv_to_rgb(y, _upsample_cols(u, w), _upsample_cols(v, w))


def _packed_422(p: torch.Tensor) -> torch.Tensor:
    if p.ndim == 2:
        return p.reshape(p.shape[0], -1, 4)
    return p


def yuyv_to_rgb(yuyv: torch.Tensor) -> torch.Tensor:
    """Packed YUYV422, (H, W*2) u8 or (H, W/2, 4)."""
    q = _packed_422(yuyv)
    y = torch.stack([q[..., 0], q[..., 2]], dim=-1).reshape(q.shape[0], -1)
    return i422_to_rgb(y, q[..., 1], q[..., 3])


def uyvy_to_rgb(uyvy: torch.Tensor) -> torch.Tensor:
    """Packed UYVY422, (H, W*2) u8 or (H, W/2, 4)."""
    q = _packed_422(uyvy)
    y = torch.stack([q[..., 1], q[..., 3]], dim=-1).reshape(q.shape[0], -1)
    return i422_to_rgb(y, q[..., 0], q[..., 2])


# ---------------------------------------------------------------- HSV, HSL

def _hue(mx, r, g, b, c):
    """Hue in [0, 180) from the largest channel, the reference's order."""
    safe_c = torch.clamp_min(c, 1e-9)
    h = torch.where(
        mx == r, 30.0 * (g - b) / safe_c,
        torch.where(mx == g, 60.0 + 30.0 * (b - r) / safe_c,
                    120.0 + 30.0 * (r - g) / safe_c))
    return torch.where(c == 0, 0.0, torch.where(h < 0, h + 180.0, h))


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) u8 RGB -> (H,W,3) u8 HSV: H in [0, 180), S, V in [0, 255]
    (reference compv_image_conv_hsv.cxx)."""
    rgbf = rgb.to(torch.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    s = torch.where(v > 0, 255.0 * c / torch.clamp_min(v, 1e-9), 0.0)
    h = _hue(v, r, g, b, c)
    return torch.stack([_round_u8(h), _round_u8(s),
                        v.clamp(0, 255).to(torch.uint8)], dim=-1)


def yuv444_to_hsv(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """YUV444 planes -> HSV, through RGB."""
    return rgb_to_hsv(yuv_to_rgb(y, u, v))


def rgb_to_hsl(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) u8 RGB -> (H,W,3) u8 HSL: H in [0, 180), S, L in [0, 255]."""
    f = rgb.to(torch.float32)
    f = f / f.new_tensor(255.0)     # a true quotient on the card too
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    lum = (mx + mn) * 0.5
    s = torch.where(c == 0, 0.0,
                    c / torch.clamp_min(1.0 - (2.0 * lum - 1.0).abs(), 1e-9))
    h = _hue(mx, r, g, b, c)
    return torch.stack([_round_u8(h), _round_u8(s * 255.0),
                        _round_u8(lum * 255.0)], dim=-1)


# ---------------------------------------------------------------- RGB565

def rgb565_to_rgb(packed: torch.Tensor, little_endian: bool = True
                  ) -> torch.Tensor:
    """(H,W) u16 RGB565 (or (H, W*2) u8 byte pairs) -> (H,W,3) u8, each
    field widened by bit replication."""
    if packed.dtype == torch.uint8:
        lo = _i32(packed[..., 0::2])
        hi = _i32(packed[..., 1::2])
        v = (hi << 8) | lo if little_endian else (lo << 8) | hi
    else:                           # the reference's astype(uint16)
        v = packed.to(torch.int64).remainder(65536).to(torch.int32)
    r5 = (v >> 11) & 0x1F
    g6 = (v >> 5) & 0x3F
    b5 = v & 0x1F
    r = ((r5 << 3) | (r5 >> 2)).to(torch.uint8)
    g = ((g6 << 2) | (g6 >> 4)).to(torch.uint8)
    b = ((b5 << 3) | (b5 >> 2)).to(torch.uint8)
    return torch.stack([r, g, b], dim=-1)


def rgb_to_rgb565(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) u8 -> (H,W) u16 RGB565. Each channel is cast to uint16
    first, as the reference casts it (a negative or wider value wraps
    modulo 2^16), in int64."""
    c = rgb.to(torch.int64) & 0xFFFF
    v = ((c[..., 0] >> 3) << 11) | ((c[..., 1] >> 2) << 5) | (c[..., 2] >> 3)
    return (v & 0xFFFF).to(torch.uint16)


# ---------------------------------------------------------------- split/merge

@at_x64_off
def split_channels(img: torch.Tensor):
    """(H,W,C) -> tuple of C (H,W) planes."""
    return tuple(img[..., i] for i in range(img.shape[-1]))


@at_x64_off
def merge_channels(*planes: torch.Tensor) -> torch.Tensor:
    return torch.stack(planes, dim=-1)
