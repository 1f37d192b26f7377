"""The ``warped_stream`` generator: a camera stream of one planar object.

A mix of this kind (``traffic/<mix>.json`` with ``"kind": "warped_stream"``)
sets the frame size, the pool, the ranges of the similarity each frame is
drawn under, the fill outside the object and the sensor noise.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import scenes


def make(p: dict, seed: int, device):
    """The object and a pool of frames, each the object warped by a
    homography drawn from the seed, plus Gaussian noise. Returns (object
    (H, W) u8, frames (P, H, W) u8, homographies (P, 3, 3) object ->
    frame, float64 numpy)."""
    h, w = p["height"], p["width"]
    rng = np.random.default_rng([int(seed), 1])
    gen = scenes.device_generator(rng.integers(1 << 62), device)
    obj = scenes.object_scene(h, w, int(rng.integers(1 << 62)), gen, device)
    objf = obj.to(torch.float32)
    hs, frames = [], []
    for _ in range(p["pool"]):
        hm = scenes.similarity_about_centre(
            h, w, rng.uniform(-p["rotation_deg"], p["rotation_deg"]),
            rng.uniform(p["scale_min"], p["scale_max"]),
            rng.uniform(-p["shift_px"], p["shift_px"]),
            rng.uniform(-p["shift_px"], p["shift_px"]))
        warped = scenes.warp_homography(
            objf, torch.from_numpy(np.linalg.inv(hm)), h, w, float(p["fill"]))
        noise = torch.randn((h, w), generator=gen, device=device)
        frames.append((warped + noise * p["noise_sigma"]).round()
                      .clamp(0, 255).to(torch.uint8))
        hs.append(hm)
    return obj, torch.stack(frames), np.stack(hs)

