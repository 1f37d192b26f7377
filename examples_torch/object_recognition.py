"""Object recognition: the flagship detect/describe/match/homography demo
(reference: samples/object_recognition/main.cxx), on the port: ORB runs
the hand-written FAST kernel (K1) on the card.

Warps a 'template' into a scene with a known homography, recovers it with
the ORB frontend, and renders the matches + recovered outline.

    python examples_torch/object_recognition.py [--device cpu]
"""
import argparse

import numpy as np

from common import add_device_arg, out_path, pick_device, textured_scene

import torch
from compv_tpu_torch.calib.homography import HomographyConfig
from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
from compv_tpu_torch.image import warp_perspective
from compv_tpu_torch.io import write_image
from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test
from compv_tpu_torch.io.video import open_writer
from compv_tpu_torch.slam import FrontendConfig, match_pair
from compv_tpu_torch.viz import draw_matches, draw_text, to_rgb
from compv_tpu_torch.viz.draw import _line_px


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    template = textured_scene(240, 320)
    timg = torch.from_numpy(template).to(dev)
    h_true = np.array([[0.95, 0.08, 30.0], [-0.05, 1.02, 12.0],
                       [1e-5, -2e-5, 1.0]])
    scene = warp_perspective(timg, f32(np.linalg.inv(h_true)),
                             240, 320).cpu().numpy()
    simg = torch.from_numpy(scene).to(dev)

    cfg = FrontendConfig(orb=OrbConfig(max_features=512, levels=3),
                         homography=HomographyConfig(num_hypotheses=512,
                                                     threshold=9.0))
    res = match_pair(timg, simg, cfg)
    print(f"keypoints: {int(res.kp1_count)}/{int(res.kp2_count)}  "
          f"matches: {int(res.num_matches)}  inliers: {int(res.num_inliers)}")
    print("recovered H:\n", np.round(res.h.cpu().numpy(), 4))
    print("true H:\n", np.round(h_true / h_true[2, 2], 4))

    r1 = orb_detect_describe(timg, cfg.orb)
    r2 = orb_detect_describe(simg, cfg.orb)
    m = knn_match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                  r2.keypoints.valid, k=2)
    ok = ratio_test(m, cfg.ratio)
    canvas = draw_matches(template, r1.keypoints, scene, r2.keypoints, m, ok)
    write_image(out_path("object_recognition_matches.png"), canvas)
    print("wrote", out_path("object_recognition_matches.png"))

    # Annotated video: animate the warp, track the template per frame, draw
    # the recovered outline + a text HUD, and encode (mp4 when ffmpeg is
    # present, animated GIF otherwise — reference writes via its ffmpeg
    # writer, core/video/compv_core_video_writer_ffmpeg.cxx).
    h, w = template.shape[:2]
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], float)
    writer = open_writer(out_path("object_recognition.mp4"), w, h, fps=8)
    n_frames = 10
    pairs = [res]
    for t in range(n_frames):
        a = t / (n_frames - 1)
        h_t = np.eye(3) * (1 - a) + h_true * a
        frame = warp_perspective(timg, f32(np.linalg.inv(h_t)), h, w)
        res_t = match_pair(timg, frame, cfg)
        pairs.append(res_t)
        hv = res_t.h.cpu().numpy()
        pts = np.concatenate([corners, np.ones((4, 1))], 1) @ hv.T
        pts = pts[:, :2] / pts[:, 2:3]
        rgb = to_rgb(frame)
        for i in range(4):
            xa, ya = pts[i]
            xb, yb = pts[(i + 1) % 4]
            _line_px(rgb, xa, ya, xb, yb, (0, 255, 0))
        draw_text(rgb, 4, 4,
                  f"FRAME {t}  INLIERS {int(res_t.num_inliers)}",
                  color=(0, 255, 0), background=(0, 0, 0))
        writer.write(rgb)
    writer.close()
    vid = getattr(writer, "path", out_path("object_recognition.mp4"))
    print("wrote", vid)
    return {"match_pair": pairs}


if __name__ == "__main__":
    main()
