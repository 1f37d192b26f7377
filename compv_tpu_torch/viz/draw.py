"""Visualization: keypoints, matches, lines, boxes — host-side rendering
(mirror of ``compv_tpu/viz/draw.py``: equal canvases on equal inputs).

Replaces the reference's GL render stack (gl/ — texture upload + GLSL
conversion + FBO surface layers, SURVEY.md §2.5) and Skia canvas
(drawing/compv_drawing_canvas_skia.cxx) with (a) pure-numpy rasterization
into RGB arrays (headless, dependency-free — good for dumping PNGs and
video from jobs) and (b) matplotlib figures for interactive/debug use. The
side-by-side match drawing mirrors CompVGLMatchingSurfaceLayer
(gl/compv_gl_surfacelayer_matching.cxx).

Images and result fields may be numpy arrays or tensors on any device. A
field on the card is copied to the host once, whole (one ``.cpu()`` per
field), and rasterized there: reading one keypoint at a time would wait
for the card thousands of times a frame.
"""
from __future__ import annotations

import numpy as np
import torch

from compv_tpu_torch.viz.text import draw_text, text_size  # noqa: F401

__all__ = ["to_rgb", "draw_keypoints", "draw_matches", "draw_lines",
           "draw_boxes", "draw_text", "text_size", "figure_keypoints",
           "figure_matches"]

GREEN = (0, 255, 0)
RED = (255, 64, 64)
YELLOW = (255, 220, 0)
CYAN = (0, 220, 255)


def _host(a) -> np.ndarray:
    """``a`` as a numpy array; a tensor is copied to the host whole."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_rgb(img) -> np.ndarray:
    a = _host(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return a.copy()


def _plot_px(canvas, ys, xs, color):
    h, w = canvas.shape[:2]
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    canvas[ys[ok], xs[ok]] = color


def _line_px(canvas, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    _plot_px(canvas, ys, xs, color)


def _circle_px(canvas, cx, cy, r, color):
    t = np.linspace(0, 2 * np.pi, max(int(2 * np.pi * r), 8), endpoint=False)
    xs = np.round(cx + r * np.cos(t)).astype(int)
    ys = np.round(cy + r * np.sin(t)).astype(int)
    _plot_px(canvas, ys, xs, color)


def draw_keypoints(img, keypoints, color=GREEN, with_orientation=True
                   ) -> np.ndarray:
    """Render a Keypoints set: circle scaled by size, orientation tick."""
    canvas = to_rgb(img)
    v = _host(keypoints.valid)
    xs = _host(keypoints.x)[v]
    ys = _host(keypoints.y)[v]
    sizes = _host(keypoints.size)[v]
    orients = _host(keypoints.orientation)[v]
    for x, y, s, o in zip(xs, ys, sizes, orients):
        r = max(s / 2.0, 2.0)
        _circle_px(canvas, x, y, r, color)
        if with_orientation:
            th = np.deg2rad(o)
            _line_px(canvas, x, y, x + r * np.cos(th), y + r * np.sin(th),
                     color)
    return canvas


def draw_matches(img1, kp1, img2, kp2, matches, mask=None, max_draw=200
                 ) -> np.ndarray:
    """Side-by-side pair with match lines (reference matching surface
    layer). ``matches`` is a Matches result; ``mask`` optionally selects
    rows (e.g. ratio-test survivors / RANSAC inliers)."""
    a = to_rgb(img1)
    b = to_rgb(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]

    v = _host(matches.valid[0])
    if mask is not None:
        v = v & _host(mask)
    idx = np.nonzero(v)[0][:max_draw]
    x1 = _host(kp1.x)[idx]
    y1 = _host(kp1.y)[idx]
    ti = _host(matches.train_idx[0])[idx]
    x2 = _host(kp2.x)[ti] + off
    y2 = _host(kp2.y)[ti]
    for xa, ya, xb, yb in zip(x1, y1, x2, y2):
        _line_px(canvas, xa, ya, xb, yb, GREEN)
        _circle_px(canvas, xa, ya, 3, YELLOW)
        _circle_px(canvas, xb, yb, 3, CYAN)
    return canvas


def draw_lines(img, lines, color=RED) -> np.ndarray:
    """Render polar Hough lines across the image."""
    canvas = to_rgb(img)
    h, w = canvas.shape[:2]
    span = float(np.hypot(h, w))
    v = _host(lines.valid)
    for rho, th in zip(_host(lines.rho)[v], _host(lines.theta)[v]):
        c, s = np.cos(th), np.sin(th)
        x0, y0 = c * rho, s * rho
        _line_px(canvas, x0 - span * s, y0 + span * c,
                 x0 + span * s, y0 - span * c, color)
    return canvas


def draw_boxes(img, x0, y0, x1, y1, valid=None, color=YELLOW,
               labels=None) -> np.ndarray:
    """Render CCL/MSER bounding boxes; optional per-box text ``labels``
    (sequence aligned with the box arrays) drawn above each box."""
    canvas = to_rgb(img)
    x0, y0, x1, y1 = map(_host, (x0, y0, x1, y1))
    if valid is None:
        valid = np.ones(len(x0), bool)
    for i in np.nonzero(_host(valid))[0]:
        _line_px(canvas, x0[i], y0[i], x1[i], y0[i], color)
        _line_px(canvas, x1[i], y0[i], x1[i], y1[i], color)
        _line_px(canvas, x1[i], y1[i], x0[i], y1[i], color)
        _line_px(canvas, x0[i], y1[i], x0[i], y0[i], color)
        if labels is not None and i < len(labels) and labels[i]:
            ty = int(y0[i]) - 9
            draw_text(canvas, int(x0[i]), max(0, ty), str(labels[i]),
                      color=color, background=(0, 0, 0))
    return canvas


def figure_keypoints(img, keypoints, title="keypoints"):
    """Matplotlib figure variant (interactive/debug)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.imshow(_host(img), cmap="gray")
    v = _host(keypoints.valid)
    ax.scatter(_host(keypoints.x)[v], _host(keypoints.y)[v],
               s=8, c="lime", marker="+")
    ax.set_title(title)
    return fig


def figure_matches(img1, kp1, img2, kp2, matches, mask=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    canvas = draw_matches(img1, kp1, img2, kp2, matches, mask)
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas)
    ax.axis("off")
    return fig
