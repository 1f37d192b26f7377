"""Port parity for visualization (``compv_tpu_torch/viz``): the bitmap font,
the drawn canvases, the MJPEG server and the live loop, against
``compv_tpu.viz`` (CPU, small sizes), and the slice as a whole.

Canvases are held bit-equal to the reference's on equal inputs: the same
results drawn (the port given them as tensors, the reference as JAX arrays)
and ``draw_text`` on the same canvas. Covers what
``tests/test_viz_stream.py`` and the text cases of
``tests/test_viz_video.py`` cover.

The whole-slice test writes 6 frames of a 96x128 I420 video, reads them
through ``RawYuvReader(reuse_buffers=True)`` (the native loader), matches
every frame against the first through the registry's ORB and
``match_pair``, draws the matches and a text line, and writes the canvases
with ``VideoWriterRaw``; the reference's chain does the same. At
``levels=1`` the two output files are equal byte for byte. At the default
8 levels, ORB's orientation differs by design at levels >= 1 (up to ~0.02
deg, tests/test_torch_orb.py), which can move a BRIEF bit, a ratio-test
decision and so a drawn line or an inlier count: there at most 1 % of the
output bytes may differ, and the match and inlier counts by at most 3 %
(tests/test_torch_frontend.py's bar).
"""
import io as pyio
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import compv_tpu
import compv_tpu_torch
from compv_tpu import viz as jviz
from compv_tpu.calib.homography import HomographyConfig as JHomographyConfig
from compv_tpu.core.types import Lines as JLines
from compv_tpu.io import video as jvideo
from compv_tpu.io.camera import SyntheticCamera as JSyntheticCamera
from compv_tpu.matchers import bruteforce as jbf
from compv_tpu.slam import frontend as jfront
from compv_tpu.viz import text as jtext
from compv_tpu_torch import viz
from compv_tpu_torch.calib.homography import HomographyConfig
from compv_tpu_torch.core.types import Lines
from compv_tpu_torch.interop import keypoints_from_numpy
from compv_tpu_torch.io import SyntheticCamera, VideoWriterRaw, open_video
from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test
from compv_tpu_torch.slam.frontend import FrontendConfig, match_pair
from compv_tpu_torch.viz import text


def _textured(h=96, w=128, seed=5):
    """examples/common.py's textured_scene: blurred uniform noise."""
    rs = np.random.default_rng(seed)
    im = ndimage.gaussian_filter(rs.uniform(0, 255, (h, w)).astype(np.float32),
                                 1.5)
    return ((im - im.min()) / (np.ptp(im) + 1e-9) * 255).astype(np.uint8)


# ------------------------------------------------------------------ text

def test_glyph_masks_equal_reference():
    chars = list(jtext._GLYPHS) + ["a", "z", "~", "é"]
    for ch in chars:
        np.testing.assert_array_equal(text._glyph_mask(ch),
                                      jtext._glyph_mask(ch), err_msg=ch)
    assert (text.FONT_W, text.FONT_H) == (jtext.FONT_W, jtext.FONT_H)


@pytest.mark.parametrize("x,y,s,scale,bg", [
    (2, 2, "FAST9 1.7X", 1, None), (4, 4, "OK", 1, (64, 64, 64)),
    (-3, -3, "CLIP ME PLEASE", 1, (9, 9, 9)), (8, 8, "EDGE", 2, None),
    (0, 10, "frame 12  kp 345 (x=1.5%)", 3, (0, 0, 0))])
def test_draw_text_equals_reference(x, y, s, scale, bg):
    base = np.random.default_rng(0).integers(0, 256, (32, 128, 3),
                                             dtype=np.uint8)
    got = text.draw_text(base.copy(), x, y, s, color=(255, 0, 9),
                         scale=scale, background=bg)
    want = jtext.draw_text(base.copy(), x, y, s, color=(255, 0, 9),
                           scale=scale, background=bg)
    np.testing.assert_array_equal(got, want)
    assert text.text_size(s, scale) == jtext.text_size(s, scale)


def test_draw_text_as_the_reference_tests():
    canvas = np.zeros((32, 128, 3), np.uint8)
    viz.draw_text(canvas, 2, 2, "FAST9 1.7X", color=(255, 0, 0))
    assert (canvas[..., 0] == 255).sum() > 40 and (canvas[..., 1] == 0).all()
    a = np.zeros((10, 8, 3), np.uint8)
    b = np.zeros((10, 8, 3), np.uint8)
    viz.draw_text(a, 0, 0, "0")
    viz.draw_text(b, 0, 0, "8")
    assert (a != b).any()
    assert viz.text_size("AB", scale=2)[0] == 2 * viz.text_size("AB")[0]


# ---------------------------------------------------------------- canvases

@pytest.fixture(scope="module")
def pair():
    """The textured scene and its roll by (2, 3), ORB on both and their
    KNN-2 matches with the ratio test, by the reference (JAX on the CPU;
    the whole-slice test's ORB configuration, so its compile is shared)."""
    from compv_tpu.features.orb import OrbConfig, orb_detect_describe
    a = _textured()
    b = np.roll(a, (2, 3), (0, 1))
    cfg = OrbConfig(max_features=200, levels=8)
    r1 = orb_detect_describe(jnp.asarray(a), cfg)
    r2 = orb_detect_describe(jnp.asarray(b), cfg)
    m = jbf.knn_match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                      r2.keypoints.valid, k=2)
    return a, b, r1.keypoints, r2.keypoints, m, jbf.ratio_test(m, 0.67)


def _port_matches(m):
    from compv_tpu_torch.core.types import Matches
    return Matches(*[torch.from_numpy(np.array(getattr(m, f)))
                     for f in Matches._fields])


def test_draw_keypoints_equals_reference(pair):
    a, _, kp1, _, _, _ = pair
    port_kp = keypoints_from_numpy(kp1)
    assert int(port_kp.count()) > 20
    for orient in (True, False):
        want = jviz.draw_keypoints(a, kp1, with_orientation=orient)
        np.testing.assert_array_equal(
            viz.draw_keypoints(torch.from_numpy(a), port_kp,
                               with_orientation=orient), want)
        assert (want != jviz.to_rgb(a)).any()


@pytest.mark.parametrize("masked", [False, True])
def test_draw_matches_equals_reference(pair, masked):
    a, b, kp1, kp2, m, ok = pair
    mask = ok if masked else None
    want = jviz.draw_matches(a, kp1, b, kp2, m, mask, max_draw=50)
    got = viz.draw_matches(
        torch.from_numpy(a), keypoints_from_numpy(kp1), b,
        keypoints_from_numpy(kp2), _port_matches(m),
        None if mask is None else torch.from_numpy(np.array(mask)),
        max_draw=50)
    assert got.shape == (96, 256, 3)
    np.testing.assert_array_equal(got, want)


def test_draw_lines_and_boxes_equal_reference():
    img = _textured()
    rho, theta = [50.0, -20.0, 90.0], [0.5, 2.0, 1.2]
    jl = JLines(rho=jnp.asarray(rho), theta=jnp.asarray(theta),
                strength=jnp.ones(3), valid=jnp.asarray([True, True, False]))
    pl = Lines(rho=torch.tensor(rho), theta=torch.tensor(theta),
               strength=torch.ones(3), valid=torch.tensor([True, True, False]))
    want = jviz.draw_lines(img, jl)
    np.testing.assert_array_equal(viz.draw_lines(img, pl), want)
    assert (want != jviz.to_rgb(img)).any()
    boxes = [np.array([10, 60]), np.array([20, 5]), np.array([40, 120]),
             np.array([50, 90])]
    labels = ["BLOB 0", "B1"]
    for valid in (None, np.array([True, False])):
        want = jviz.draw_boxes(img, *boxes, valid=valid, labels=labels)
        got = viz.draw_boxes(img, *[torch.from_numpy(x) for x in boxes],
                             valid=valid, labels=labels)
        np.testing.assert_array_equal(got, want)


def test_to_rgb_and_figures():
    f = np.linspace(-10, 300, 12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(viz.to_rgb(torch.from_numpy(f)),
                                  jviz.to_rgb(f))
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    a = _textured(32, 48)
    kp = keypoints_from_numpy({
        "x": [5.0, 9.0], "y": [4.0, 8.0], "strength": [1.0, 2.0],
        "orientation": [0.0, 90.0], "level": [0, 0], "size": [7.0, 7.0],
        "valid": [True, False]})
    fig = viz.figure_keypoints(torch.from_numpy(a), kp)
    from compv_tpu_torch.core.types import Matches
    m = Matches(train_idx=torch.tensor([[1, 0]], dtype=torch.int32),
                distance=torch.zeros(1, 2), valid=torch.ones(1, 2, dtype=torch.bool))
    fig2 = viz.figure_matches(a, kp, a, kp, m)
    assert len(fig.axes) == 1 and len(fig2.axes) == 1
    plt.close(fig)
    plt.close(fig2)


# ------------------------------------------------------------------ stream

def _read_mjpeg_parts(resp, n):
    parts, buf = [], b""
    while len(parts) < n:
        chunk = resp.fp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while True:
            start, end = buf.find(b"\xff\xd8"), buf.find(b"\xff\xd9")
            if start == -1 or end == -1 or end < start:
                break
            parts.append(buf[start:end + 2])
            buf = buf[end + 2:]
            if len(parts) >= n:
                break
    return parts


def test_mjpeg_snapshot_and_stream():
    Image = pytest.importorskip("PIL.Image")
    with viz.MjpegServer(port=0) as srv:
        frame = np.zeros((48, 64), np.uint8)
        frame[10:30, 20:40] = 255
        srv.push(frame)
        url = f"http://127.0.0.1:{srv.port}"
        jpg = urllib.request.urlopen(f"{url}/snapshot", timeout=5).read()
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
        img = np.asarray(Image.open(pyio.BytesIO(jpg)))
        assert img.shape[:2] == (48, 64)
        assert img[20, 30] > 200 and img[5, 5] < 50
        resp = urllib.request.urlopen(url + "/", timeout=30)
        parts = _read_mjpeg_parts(resp, 1)
        srv.push(np.stack([255 - frame] * 3, -1))
        parts += _read_mjpeg_parts(resp, 1)
        resp.close()
        assert len(parts) == 2 and all(p[:2] == b"\xff\xd8" for p in parts)
    assert srv.frames_pushed == 2


class _Sink:
    """A server stand-in that keeps what it is pushed."""

    def __init__(self):
        self.frames = []

    def push(self, frame):
        self.frames.append(frame)


def test_run_live_event_loop():
    pytest.importorskip("PIL")
    cam = SyntheticCamera(width=96, height=64, fps=60.0)
    seen = []

    def process(frame):
        seen.append(frame.shape)
        return 255 - frame

    with viz.MjpegServer(port=0) as srv:
        stats = viz.run_live(cam, process, srv, seconds=5.0, max_frames=5)
        assert stats["frames"] >= 5 and srv.frames_pushed >= 5
        jpg = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/snapshot", timeout=5).read()
        assert jpg[:2] == b"\xff\xd8"
    assert all(s == (64, 96) for s in seen)
    assert not cam._running.is_set() and stats["fps"] > 0


def test_run_live_stops_on_camera_exhaustion():
    """A finite camera ends run_live with no seconds / max_frames bound,
    and the frames pushed are the reference camera's, processed."""
    cam = SyntheticCamera(width=32, height=24, fps=200.0, n_frames=4)
    ref = JSyntheticCamera(width=32, height=24)
    sink = _Sink()
    t0 = time.perf_counter()
    stats = viz.run_live(cam, lambda f: 255 - f, sink)
    assert time.perf_counter() - t0 < 5.0
    assert stats["frames"] == 4 and cam.finished.is_set()
    for t, f in enumerate(sink.frames):
        np.testing.assert_array_equal(f, 255 - ref.frame_at(t))


# ------------------------------------------------------------- whole slice

def _write_i420(path, n=6, h=96, w=128):
    """n frames of I420: Y the textured scene rolled by (2t, 3t), chroma
    from default_rng(1)."""
    y0 = _textured(h, w)
    uv = np.random.default_rng(1).integers(0, 256, (2, h // 2, w // 2),
                                           dtype=np.uint8)
    writer = VideoWriterRaw(str(path))
    planes = []
    for t in range(n):
        y = np.roll(y0, (2 * t, 3 * t), (0, 1))
        planes.append(y)
        writer.write(np.concatenate([y.ravel(), uv.ravel()]))
    writer.close()
    return planes


def _port_chain(src, out, levels):
    fn, ocfg = compv_tpu_torch.create_detector("orb", max_features=200,
                                               levels=levels)
    cfg = FrontendConfig(orb=ocfg, homography=HomographyConfig(
        num_hypotheses=128))
    writer = VideoWriterRaw(str(out))
    counts, template = [], None
    for t, y in enumerate(open_video(str(src), width=128, height=96,
                                     gray=False, reuse_buffers=True)):
        img = torch.from_numpy(y).to("cpu", copy=True)   # y is recycled
        if template is None:
            template, r1 = img, fn(img, cfg.orb)
            continue
        res = match_pair(template, img, cfg)
        r2 = fn(img, cfg.orb)
        m = knn_match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                      r2.keypoints.valid, k=2)
        canvas = viz.draw_matches(template, r1.keypoints, img, r2.keypoints,
                                  m, ratio_test(m, cfg.ratio))
        viz.draw_text(canvas, 4, 4, f"FRAME {t} INLIERS "
                      f"{int(res.num_inliers)}", color=(0, 255, 0),
                      background=(0, 0, 0))
        writer.write(canvas)
        counts.append((int(res.num_matches), int(res.num_inliers)))
    writer.close()
    return counts


def _reference_chain(src, out, levels):
    fn, ocfg = compv_tpu.create_detector("orb", max_features=200,
                                         levels=levels)
    cfg = jfront.FrontendConfig(orb=ocfg, homography=JHomographyConfig(
        num_hypotheses=128))
    writer = jvideo.VideoWriterRaw(str(out))
    counts, template = [], None
    for t, y in enumerate(jvideo.open_video(str(src), width=128, height=96,
                                            gray=False, reuse_buffers=True)):
        img = jnp.array(y)                               # a copy
        if template is None:
            template, r1 = img, fn(img, cfg.orb)
            continue
        res = jfront.match_pair(template, img, cfg)
        r2 = fn(img, cfg.orb)
        m = jbf.knn_match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                          r2.keypoints.valid, k=2)
        canvas = jviz.draw_matches(np.asarray(template), r1.keypoints,
                                   np.asarray(img), r2.keypoints, m,
                                   jbf.ratio_test(m, cfg.ratio))
        jviz.draw_text(canvas, 4, 4, f"FRAME {t} INLIERS "
                       f"{int(res.num_inliers)}", color=(0, 255, 0),
                       background=(0, 0, 0))
        writer.write(canvas)
        counts.append((int(res.num_matches), int(res.num_inliers)))
    writer.close()
    return counts


@pytest.mark.parametrize("levels", [1, 8])
def test_whole_slice_recording_equals_reference(tmp_path, levels):
    src = tmp_path / "scene_128x96.yuv"
    _write_i420(src)
    got = _port_chain(src, tmp_path / "port.rgb", levels)
    want = _reference_chain(src, tmp_path / "ref.rgb", levels)
    a = np.fromfile(tmp_path / "port.rgb", np.uint8)
    b = np.fromfile(tmp_path / "ref.rgb", np.uint8)
    assert a.size == b.size == 5 * 96 * 256 * 3
    assert all(n > 20 and i >= n // 2 for n, i in got)
    if levels == 1:
        assert got == want
        np.testing.assert_array_equal(a, b)
    else:
        assert np.mean(a != b) <= 0.01
        for (n, i), (jn, ji) in zip(got, want):
            assert abs(n - jn) <= 0.03 * jn and abs(i - ji) <= 0.03 * ji
