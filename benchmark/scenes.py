"""Scenes for the traffic generators (``generators/<kind>.py``), made
from the seed.

Frozen copies, so that the inputs do not move when the program does:
  * ``object_scene``: the 720x1282 object-recognition scene of ``bench.py``
    (``_images()``, its gray image: a sin/cos ramp with a 24-px
    checkerboard panel, plus Gaussian noise sigma 2), with random
    rectangles over the ramp (see there). Its geometry is kept as
    fractions of the frame, so a larger frame keeps the layout. The noise
    is drawn on the device from the seed.
Nothing here imports the port.
"""
from __future__ import annotations

import numpy as np
import torch


def device_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    fill: float) -> torch.Tensor:
    """Bilinear samples of a (H, W) float image at float coordinates;
    ``fill`` outside the image."""
    h, w = img.shape
    x0 = x.floor()
    y0 = y.floor()
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    out = torch.zeros_like(x)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            out = out + wx * wy * torch.where(inside, v, fill)
    return out


def warp_homography(img: torch.Tensor, h_dst_to_src: torch.Tensor,
                    out_h: int, out_w: int, fill: float) -> torch.Tensor:
    """(H, W) float image seen through ``h_dst_to_src`` (3, 3): each output
    pixel samples the source at H (x, y, 1)."""
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(out_h, device=dev, dtype=torch.float64),
                            torch.arange(out_w, device=dev, dtype=torch.float64),
                            indexing="ij")
    hm = h_dst_to_src.to(device=dev, dtype=torch.float64)
    d = hm[2, 0] * xx + hm[2, 1] * yy + hm[2, 2]
    sx = ((hm[0, 0] * xx + hm[0, 1] * yy + hm[0, 2]) / d).to(torch.float32)
    sy = ((hm[1, 0] * xx + hm[1, 1] * yy + hm[1, 2]) / d).to(torch.float32)
    return sample_bilinear(img, sx, sy, fill)


def object_scene(h: int, w: int, seed: int, gen: torch.Generator,
                 device) -> torch.Tensor:
    """bench.py's scene recipe at (h, w) (720 x 1282 there), u8, with the
    corner-rich random rectangles of ``plane_texture`` over its ramp (not
    over the checkerboard panel), drawn from ``seed``. The recipe alone is
    periodic: under the warps of the stream most of its features have a
    twin, the ratio test keeps few matches, and RANSAC finds a wrong
    homography on some frames (8 inliers, 873 px off at the panel's
    corners on one of six 720p frames; 357-690 inliers within 1.3 px of
    the truth with the rectangles)."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    for _ in range((h * w) // 300):
        cy = int(rs.integers(0, h - 4))
        cx = int(rs.integers(0, w - 4))
        base[cy:cy + int(rs.integers(4, 18)),
             cx:cx + int(rs.integers(4, 18))] = rs.uniform(10, 245)
    ch = ((xx // 24).astype(np.int64) + (yy // 24).astype(np.int64)) % 2
    panel = ((xx > 300 / 1282 * w) & (xx < 1000 / 1282 * w)
             & (yy > 150 / 720 * h) & (yy < 570 / 720 * h))
    base = np.where(panel, ch * 200.0 + 20, base).astype(np.float32)
    noise = torch.randn((h, w), generator=gen, device=device) * 2.0
    return ((torch.from_numpy(base).to(device) + noise).round()
            .clamp(0, 255).to(torch.uint8))


def panel_corners(h: int, w: int) -> np.ndarray:
    """The checkerboard panel's corners (4, 2) in object pixels."""
    x0, x1 = 300 / 1282 * w, 1000 / 1282 * w
    y0, y1 = 150 / 720 * h, 570 / 720 * h
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)


def similarity_about_centre(h: int, w: int, deg: float, scale: float,
                            tx: float, ty: float) -> np.ndarray:
    """Object -> frame homography: rotate by ``deg`` and scale about the
    image centre, then shift by (tx, ty)."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    th = np.deg2rad(deg)
    c, s = np.cos(th) * scale, np.sin(th) * scale
    return np.array([[c, -s, cx + tx - c * cx + s * cy],
                     [s, c, cy + ty - s * cx - c * cy],
                     [0.0, 0.0, 1.0]])
