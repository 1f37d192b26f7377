"""How often find_chessboard_corners finds the calibration boards of
chip_smoke.py's phase 15, by where the board sits and how it is tilted, in
the port and in the JAX reference on the same views.

Renders phase 10's 6x8 board of 80-px squares, warps it into 8 views of
720x1280 through K = [[1000, 0, 640], [0, 1000, 360], [0, 0, 1]] at the
poses of chip_smoke.calibration_views (a tilt about one of 8 axes in the
image plane, a roll of 0.05 x (i - 3.5) rad) for each geometry asked for,
and prints per geometry and finder the boards found, the boards found
within 5 px of the truth, and the largest corner error among those found,
as JSON lines. The views are rendered by the port; each u8 view then goes
to the port's finder and, with --reference, to ``compv_tpu``'s (JAX on the
CPU) as well, so the two are held to one input:

    python3 scripts/corner_views_probe.py --reference   # phase 15's views
                                                        # and a sweep
"""
import argparse
import importlib.util
import itertools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from compv_tpu_torch.calib.camera import checkerboard_object_points  # noqa: E402
from compv_tpu_torch.calib.checkerboard import (  # noqa: E402
    CheckerboardConfig, find_chessboard_corners)
from compv_tpu_torch.calib.homography import compute_homography_dlt  # noqa: E402
from compv_tpu_torch.calib.utils import project_points_dist  # noqa: E402
from compv_tpu_torch.image.remap import warp_perspective  # noqa: E402


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def views(dev, board, corners, z, tilt, centre):
    """8 views of 720x1280 and their true corners, the grid's centre seen
    at ``centre`` (None: the grid's corner 0 at -(cols, rows) x square / 2,
    as tests/test_checkerboard.py places it) from ``z`` units, tilted by
    ``tilt`` rad."""
    k = torch.tensor([[1000.0, 0, 640], [0, 1000.0, 360], [0, 0, 1]],
                     device=dev)
    obj = checkerboard_object_points(6, 8, 80.0, device=dev)
    if centre is None:
        tx, ty = -320.0, -240.0
    else:
        tx = (centre[0] - 640) * z / 1000 - 280.0
        ty = (centre[1] - 360) * z / 1000 - 200.0
    tvec = torch.tensor([tx, ty, z], device=dev)
    out = []
    for i in range(8):
        a = 2 * np.pi * i / 8
        rvec = torch.tensor([tilt * np.cos(a), tilt * np.sin(a),
                             0.05 * (i - 3.5)], dtype=torch.float32,
                            device=dev)
        proj = project_points_dist(obj, k, torch.zeros(4, device=dev), rvec,
                                   tvec)
        h = compute_homography_dlt(corners, proj)
        view = warp_perspective(board, torch.linalg.inv(h), 720, 1280,
                                fill=128.0)
        out.append((view.cpu().numpy(), proj.cpu().numpy()))
    return out


def port_finder(dev):
    def find(view):
        res = find_chessboard_corners(torch.from_numpy(view).to(dev),
                                      CheckerboardConfig())
        return bool(res.valid), res.corners.cpu().numpy()
    return find


def reference_finder():
    """compv_tpu's find_chessboard_corners, JAX on the CPU."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from compv_tpu.calib import checkerboard as ref

    def find(view):
        res = ref.find_chessboard_corners(jnp.asarray(view),
                                          ref.CheckerboardConfig())
        return bool(res.valid), np.asarray(res.corners)
    return find


def count(find, vs):
    found, right, worst = 0, 0, 0.0
    for view, truth in vs:
        valid, got = find(view)
        if valid:
            err = float(np.abs(got - truth).max())
            found += 1
            right += err < 5.0
            worst = max(worst, err)
    return {"found": found, "within_5px": right, "worst_err_px": worst}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reference", action="store_true",
                    help="also run compv_tpu's finder (JAX, CPU)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    finders = {"port": port_finder(dev)}
    if args.reference:
        finders["reference"] = reference_finder()
    img, pts = load_smoke().render_board(square=80, margin=80)
    board = torch.from_numpy(img).to(dev)
    corners = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    geometries = [(2600.0, 0.3, (400, 240))]        # phase 15's views
    geometries += list(itertools.product(
        (1300.0, 1600.0, 2000.0, 2600.0), (0.2, 0.3), (None, (640, 360))))
    for z, tilt, centre in geometries:
        vs = views(dev, board, corners, z, tilt, centre)
        line = {"z": z, "tilt": tilt, "centre": centre}
        for name, find in finders.items():
            line[name] = count(find, vs)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
