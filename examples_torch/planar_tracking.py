"""Planar tracking over a sequence (BASELINE config 3): track a moving
planar scene, chain homographies, report trajectory ATE. ORB runs the
hand-written FAST kernel (K1) on each pyramid level of each frame on the
card.

    python examples_torch/planar_tracking.py [--device cpu]
"""
import argparse

import numpy as np

from common import add_device_arg, pick_device, textured_scene

import torch
from compv_tpu_torch.slam import (
    PlanarTrackerConfig, ate_rmse, track_planar_sequence,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)

    base = textured_scene(200, 280)
    shifts = [(0, 0), (4, 2), (8, 5), (12, 7), (16, 10), (20, 12)]
    frames = [np.roll(np.roll(base, sx, axis=1), sy, axis=0)
              for sx, sy in shifts]
    res = track_planar_sequence(frames, PlanarTrackerConfig(), device=dev)
    print("tracked:", res.tracked)
    print("inliers:", res.num_inliers)
    est = np.array([[h[0, 2], h[1, 2], 0.0] for h in res.h_to_first],
                   np.float32)
    gt = np.array([[sx, sy, 0.0] for sx, sy in shifts], np.float32)
    ate = float(ate_rmse(torch.from_numpy(est).to(dev),
                         torch.from_numpy(gt).to(dev), with_scale=False))
    print(f"trajectory ATE: {ate:.3f} px")
    return {"track_planar_sequence": [res], "ate_rmse": [ate]}


if __name__ == "__main__":
    main()
