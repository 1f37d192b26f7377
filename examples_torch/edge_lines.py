"""Canny + Hough lines demo (reference: samples hough/canny apps), on the
port: the SHT's votes go through the hand-written accumulator (K4) on the
card.

    python examples_torch/edge_lines.py [--device cpu]
"""
import argparse

import numpy as np

from common import add_device_arg, out_path, pick_device

import torch
from compv_tpu_torch.features.canny import CannyConfig, canny
from compv_tpu_torch.features.edges import sobel_gradients
from compv_tpu_torch.features.hough import (HoughKhtConfig, HoughShtConfig,
                                            hough_kht, hough_sht)
from compv_tpu_torch.io import write_image
from compv_tpu_torch.viz import draw_lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)

    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    ang = np.deg2rad(25)
    u = (xx - 160) * np.cos(ang) + (yy - 120) * np.sin(ang)
    v = -(xx - 160) * np.sin(ang) + (yy - 120) * np.cos(ang)
    img = np.where((np.abs(u) < 80) & (np.abs(v) < 55), 220, 40).astype(np.uint8)
    timg = torch.from_numpy(img).to(dev)

    edges = canny(timg, CannyConfig(threshold_low=59, threshold_high=119))
    edges_np = edges.cpu().numpy()
    print("canny edge pixels:", int((edges_np > 0).sum()))

    lines = hough_sht(edges, HoughShtConfig(threshold=0.45, max_lines=8))
    nv = int(lines.count())
    print(f"SHT lines: {nv}")
    rho, theta, strength = (lines.rho.cpu().numpy(), lines.theta.cpu().numpy(),
                            lines.strength.cpu().numpy())
    for i in range(nv):
        print(f"  rho={float(rho[i]):7.1f} theta="
              f"{np.rad2deg(float(theta[i])):6.1f}deg "
              f"votes={float(strength[i]):.0f}")

    gx, gy = sobel_gradients(timg)
    klines = hough_kht(edges, gx, gy, HoughKhtConfig(max_lines=8,
                                                     threshold_ratio=0.03))
    print(f"KHT lines: {int(klines.count())}")

    write_image(out_path("edges.png"), edges_np)
    write_image(out_path("hough_lines.png"), draw_lines(img, lines))
    print("wrote", out_path("hough_lines.png"))
    return {"hough_sht": [lines], "hough_kht": [klines]}


if __name__ == "__main__":
    main()
