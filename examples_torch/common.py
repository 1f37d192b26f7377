"""Shared helpers for the port's example programs: the repository on
``sys.path``, the device a program runs on, and the synthetic scenes and
output paths of ``examples/common.py`` (no binary fixtures in the repo).

Every program runs on the card unless it is given ``--device cpu`` (or
another torch device); without ``--device`` it asks for the card and
raises ``RuntimeError`` where there is none.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def textured_scene(h=240, w=320, seed=5):
    from scipy import ndimage
    rs = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rs.uniform(0, 255, (h, w)).astype(np.float32), 1.5)
    return ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)


def out_path(name):
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def add_device_arg(parser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on, e.g. cpu (default: the first CUDA "
             "device; raises where there is none)")


def pick_device(name):
    """``torch.device(name)``, or the card when ``name`` is None."""
    import torch

    from compv_tpu_torch.device import require_cuda

    return require_cuda() if name is None else torch.device(name)
