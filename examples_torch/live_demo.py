"""Live demo loop: camera -> ORB detect -> annotated live stream, on the
port: ORB runs the hand-written FAST kernel (K1) on the card.

The reference's flagship demos open an SDL/GL window and render the
processed camera feed at frame rate (drawing/compv_drawing_window_sdl.cxx,
samples in the reference tree); on a headless host the window is a
browser pointed at the MJPEG endpoint this script serves.

    python examples_torch/live_demo.py [--seconds 30] [--port 8080] [--device cpu]

then open http://127.0.0.1:8080/ (or /snapshot for a single frame).
``--port 0`` serves on a free port, which the first line names.
"""
import argparse

import numpy as np

from common import add_device_arg, pick_device

import torch
from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
from compv_tpu_torch.io.camera import SyntheticCamera
from compv_tpu_torch.viz import MjpegServer, draw_keypoints, draw_text, run_live


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--fps", type=float, default=15.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)

    cfg = OrbConfig(max_features=256, levels=3)
    state = {"n": 0, "last": None}

    def process(frame: np.ndarray) -> np.ndarray:
        res = orb_detect_describe(torch.from_numpy(frame).to(dev), cfg)
        out = draw_keypoints(frame, res.keypoints)
        state["n"] += 1
        out = draw_text(out, 4, 4,
                        f"frame {state['n']}  "
                        f"kp {int(res.keypoints.valid.sum())}")
        state["last"] = out
        return out

    cam = SyntheticCamera(width=640, height=480, fps=args.fps)
    with MjpegServer(port=args.port) as srv:
        print(f"live stream on http://127.0.0.1:{srv.port}/ "
              f"for {args.seconds:.0f}s ...", flush=True)
        stats = run_live(cam, process, srv, seconds=args.seconds)
    print(f"done: {stats['frames']} frames at {stats['fps']:.1f} fps")
    # frame n of the stream (1-based) is the camera's frame n - 1
    return {"stats": stats, "frames_drawn": state["n"], "last": state["last"]}


if __name__ == "__main__":
    main()
