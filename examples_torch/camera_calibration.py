"""Camera calibration demo (reference: tests/math/calib_camera.cxx chain):
render chessboard views -> detect corners -> Zhang calibrate -> undistort,
on the port: each view's corner search runs the hand-written SHT
accumulator (K4) once on the card.

    python examples_torch/camera_calibration.py [--device cpu]
"""
import argparse

import numpy as np

from common import add_device_arg, out_path, pick_device

import torch
from compv_tpu_torch.calib.camera import calibrate_camera, checkerboard_object_points
from compv_tpu_torch.calib.checkerboard import CheckerboardConfig, find_chessboard_corners
from compv_tpu_torch.calib.homography import compute_homography_dlt
from compv_tpu_torch.calib.utils import project_points_dist, undistort_image
from compv_tpu_torch.image import warp_perspective
from compv_tpu_torch.io import write_image


def render_board(rows, cols, square, margin=60):
    h = (rows + 1) * square + 2 * margin
    w = (cols + 1) * square + 2 * margin
    yy, xx = np.mgrid[0:h, 0:w]
    ix = (xx - margin) // square
    iy = (yy - margin) // square
    board = ((ix + iy) % 2 == 0) & (ix >= 0) & (ix <= cols) & (iy >= 0) & (iy <= rows)
    img = np.where(board, 230, 30).astype(np.uint8)
    corners = np.array([[margin + c * square, margin + r * square]
                        for r in range(1, rows + 1) for c in range(1, cols + 1)],
                       float)
    return img, corners


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    rows, cols, square = 6, 8, 40.0
    k_true = np.array([[700.0, 0, 330.0], [0, 700.0, 250.0], [0, 0, 1.0]])
    obj = checkerboard_object_points(rows, cols, square, device=dev).cpu().numpy()
    base_img, base_corners = render_board(rows, cols, int(square))
    tbase = torch.from_numpy(base_img).to(dev)

    img_pts = []
    homographies, detections = [], []
    for i in range(5):
        rvec = np.array([0.22, -0.18, 0.08]) * (i - 2)
        tvec = np.array([-cols * square / 2, -rows * square / 2, 1400.0])
        proj = project_points_dist(
            f32(obj), f32(k_true), torch.zeros(4, device=dev), f32(rvec),
            f32(tvec)).cpu().numpy()
        h = compute_homography_dlt(f32(base_corners), f32(proj)).cpu().numpy()
        homographies.append(h)
        view = warp_perspective(tbase, f32(np.linalg.inv(h)), 500, 660,
                                fill=128.0)
        det = find_chessboard_corners(view, CheckerboardConfig(rows=rows,
                                                               cols=cols))
        detections.append(det)
        print(f"view {i}: detected={bool(det.valid)}")
        if bool(det.valid):
            img_pts.append(det.corners.cpu().numpy())
        if i == 2:
            write_image(out_path("calibration_view.png"), view.cpu().numpy())

    res = calibrate_camera(f32(obj), f32(np.stack(img_pts)))
    k = res.k.cpu().numpy()
    print(f"K: fx={k[0,0]:.1f} fy={k[1,1]:.1f} cx={k[0,2]:.1f} cy={k[1,2]:.1f}"
          f"  (true 700/700/330/250)")
    print(f"dist: {np.round(res.dist.cpu().numpy(), 4)}")
    print(f"reproj RMS: {float(res.rms):.3f} px (before LM {float(res.rms_initial):.3f})")

    und = undistort_image(tbase, res.k, res.dist)
    write_image(out_path("calibration_undistorted.png"), und.cpu().numpy())
    print("wrote", out_path("calibration_undistorted.png"))
    return {"compute_homography_dlt": homographies,
            "find_chessboard_corners": detections, "calibrate_camera": [res]}


if __name__ == "__main__":
    main()
