"""Port parity for host IO (``compv_tpu_torch/io``): raw and PIL images,
EXIF, video readers and writers, and the cameras, against ``compv_tpu.io``
on the same bytes (CPU, small sizes).

Covers what ``tests/test_io_exif.py``, the I/O cases of
``tests/test_slam_io.py`` and the writer cases of ``tests/test_viz_video.py``
cover, plus:
* ``SyntheticCamera`` frames equal to the reference's;
* the V4L2 ``v4l2_buffer`` offsets against a ``ctypes.Structure`` mirror of
  the 64-bit ABI (88 bytes), and a capture through a fake V4L2 device
  (``fcntl.ioctl`` replaced, a file in place of the device) that checks
  the fields where a device reads them: the port streams frames, the
  reference's offsets (type 12, memory 76) are refused at QUERYBUF.
Everything compares exactly: these are byte paths.
"""
import ctypes
import errno
import fcntl
import importlib.util
import os
import shutil
import struct
import threading

import numpy as np
import pytest

from compv_tpu import io as jio
from compv_tpu.io import camera as jcamera
from compv_tpu.io import exif as jexif
from compv_tpu.io import video as jvideo
from compv_tpu_torch import io
from compv_tpu_torch.io import camera, exif, video

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w),
                                                dtype=np.uint8)


# -------------------------------------------------------------- image_io

def test_parse_raw_filename():
    assert io.parse_raw_filename("/x/equirectangular_1282x720_gray.yuv") \
        == (1282, 720) == jio.parse_raw_filename("equirectangular_1282x720.yuv")
    with pytest.raises(ValueError):
        io.parse_raw_filename("noshape.yuv")


def test_raw_roundtrip_gray_rgb_i420(tmp_path):
    gray = _img()
    p = str(tmp_path / "img_64x48_gray.yuv")
    io.write_raw(p, gray)
    np.testing.assert_array_equal(io.read_raw(p), gray)
    np.testing.assert_array_equal(io.read_image(p), jio.read_image(p))
    rgb = np.random.default_rng(1).integers(0, 256, (48, 64, 3),
                                            dtype=np.uint8)
    p = str(tmp_path / "img_64x48.rgb")
    io.write_raw(p, rgb)
    np.testing.assert_array_equal(io.read_raw(p), rgb)
    planes = [_img(48, 64, 2), _img(24, 32, 3), _img(24, 32, 4)]
    p = str(tmp_path / "img_64x48.yuv")
    io.write_raw(p, np.concatenate([q.ravel() for q in planes]))
    for got, want, ref in zip(io.read_raw(p), planes, jio.read_raw(p)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        io.read_raw(p, fmt="nv12")


@pytest.mark.parametrize("ext", [".png", ".bmp", ".pgm"])
def test_pil_roundtrip_equals_reference(tmp_path, ext):
    gray = _img()
    rgb = np.stack([gray, gray[::-1], 255 - gray], -1)
    for a in (gray, rgb) if ext != ".pgm" else (gray,):
        p = str(tmp_path / f"img{ext}")
        io.write_image(p, a)
        np.testing.assert_array_equal(io.read_image(p), a)
        np.testing.assert_array_equal(jio.read_image(p), a)
    io.write_image(str(tmp_path / "f.png"), gray.astype(np.float32) * 2)
    np.testing.assert_array_equal(io.read_image(str(tmp_path / "f.png")),
                                  np.clip(gray * 2.0, 0, 255).astype(np.uint8))


# ------------------------------------------------------------------ exif

@pytest.fixture(scope="module")
def tiff():
    """The reference test's synthesized TIFF (IFD0 + EXIF + GPS), loaded
    from tests/test_io_exif.py by path."""
    spec = importlib.util.spec_from_file_location(
        "compv_test_io_exif", os.path.join(_ROOT, "tests", "test_io_exif.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._build_tiff()


def _same_exif(got, want):
    assert type(got).__name__ == "ExifData"
    assert got.__dict__ == want.__dict__


def test_parse_tiff_fields(tiff):
    ex = exif.parse_tiff(tiff)
    assert ex.make == "TPUCam" and ex.model == "MXU-1"
    assert ex.orientation == 6 and ex.iso == 200
    assert ex.pixel_width == 1282 and ex.pixel_height == 720
    assert ex.exposure_time == pytest.approx(1 / 250)
    assert ex.focal_length_mm == pytest.approx(35.0)
    assert ex.gps_latitude == pytest.approx(48 + 51 / 60 + 29.79 / 3600,
                                            abs=1e-6)
    assert ex.gps_longitude == pytest.approx(2 + 17 / 60 + 40.20 / 3600,
                                             abs=1e-6)
    assert ex.gps_altitude == pytest.approx(35.0)
    _same_exif(ex, jexif.parse_tiff(tiff))
    big = b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 0) + bytes(4)
    _same_exif(exif.parse_tiff(big), jexif.parse_tiff(big))
    for cut in (0, 7, 20, len(tiff) // 2):     # truncated blobs
        _same_exif(exif.parse_tiff(tiff[:cut]), jexif.parse_tiff(tiff[:cut]))


def test_read_exif_from_jpeg_and_tiff(tmp_path, tiff):
    app1 = b"Exif\x00\x00" + tiff
    jpeg = (b"\xff\xd8"
            + b"\xff\xe0" + struct.pack(">H", 18) + b"JFIF\0" + b"\0" * 11
            + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
            + b"\xff\xda" + struct.pack(">H", 4) + b"\0\0"
            + b"\xff\xd9")
    for name, data in (("x.jpg", jpeg), ("x.tif", tiff)):
        p = tmp_path / name
        p.write_bytes(data)
        ex = io.read_exif(str(p))
        assert ex.model == "MXU-1" and ex.orientation == 6
        _same_exif(ex, jio.read_exif(str(p)))


def test_no_exif_returns_defaults(tmp_path):
    p = tmp_path / "plain.jpg"
    p.write_bytes(b"\xff\xd8\xff\xda" + struct.pack(">H", 4)
                  + b"\0\0\xff\xd9")
    ex = io.read_exif(str(p))
    assert isinstance(ex, io.ExifData) and ex.orientation == 1
    p2 = tmp_path / "not_a.jpg"
    p2.write_bytes(b"hello world")
    assert io.read_exif(str(p2)).make == ""
    _same_exif(io.read_exif(str(p2)), jio.read_exif(str(p2)))


def test_orientation_transform_equals_reference():
    img = np.arange(12).reshape(3, 4)
    for code in range(0, 10):
        assert io.orientation_to_transform(code) == \
            jio.orientation_to_transform(code)
    k, flip = io.orientation_to_transform(6)
    up = np.rot90(np.rot90(img, 1), k)
    np.testing.assert_array_equal(up[:, ::-1] if flip else up, img)


# ----------------------------------------------------------------- video

def _i420_file(tmp_path, n=4, h=6, w=8):
    rs = np.random.default_rng(5)
    frames = [rs.integers(0, 256, h * w * 3 // 2, dtype=np.uint8)
              for _ in range(n)]
    p = tmp_path / f"seq_{w}x{h}.yuv"
    w_ = io.VideoWriterRaw(str(p))
    for f in frames:
        w_.write(f)
    w_.close()
    return str(p), frames


@pytest.mark.parametrize("reuse", [False, True])
def test_raw_reader_gray_and_i420_equal_reference(tmp_path, reuse):
    p, frames = _i420_file(tmp_path)
    r = io.open_video(p, gray=False, reuse_buffers=reuse)
    assert isinstance(r, io.RawYuvReader) and len(r) == 4
    got = [f.copy() for f in r]
    want = [f.copy() for f in jvideo.RawYuvReader(p, gray=False,
                                                  reuse_buffers=reuse)]
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, f[:48].reshape(6, 8))
        np.testing.assert_array_equal(g, w)
    assert len(got) == 4
    gray = [f.copy() for f in io.RawYuvReader(p, 8, 6, reuse_buffers=reuse)]
    assert len(gray) == 6          # the file read as 8x6 gray frames
    np.testing.assert_array_equal(np.concatenate([g.ravel() for g in gray]),
                                  np.concatenate(frames))


def test_image_sequence_batch_decode(tmp_path):
    from PIL import Image
    imgs = [_img(12, 16, i) for i in range(5)]
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(tmp_path / f"f{i:03d}.png")
    (tmp_path / "notes.txt").write_text("skip me")
    r = io.open_video(str(tmp_path))
    assert isinstance(r, io.ImageSequenceReader) and len(r) == 5
    batch = r.read_batch()
    seq = list(r)
    ref = jvideo.ImageSequenceReader(str(tmp_path)).read_batch(1, 3)
    for a, b, c in zip(batch, imgs, seq):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    for a, b in zip(r.read_batch(1, 3), ref):
        np.testing.assert_array_equal(a, b)


def test_gif_writer_roundtrip(tmp_path):
    path = str(tmp_path / "clip.gif")
    frames = [np.full((16, 24, 3), 40 * i, np.uint8) for i in range(4)]
    with video.GifWriter(path, fps=10) as w:
        for f in frames:
            w.write(f)
    rd = io.open_video(path)
    assert isinstance(rd, io.GifReader) and len(rd) == 4
    got = list(rd)
    want = list(jvideo.GifReader(path))
    assert got[0].shape == (16, 24, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with video.GifWriter(str(tmp_path / "g.gif")) as w:
        w.write(np.zeros((8, 8), np.uint8))
    assert os.path.exists(tmp_path / "g.gif")


def test_open_writer_picks_as_the_reference(tmp_path):
    for name in ("out.gif", "out.yuv", "out.raw", "out.mp4"):
        w = video.open_writer(str(tmp_path / name), 24, 16, fps=5)
        jw = jvideo.open_writer(str(tmp_path / ("j" + name)), 24, 16, fps=5)
        assert type(w).__name__ == type(jw).__name__
        w.write(np.zeros((16, 24, 3), np.uint8))
        w.close()
        jw.close()
    if shutil.which("ffmpeg") is None:
        assert os.path.exists(tmp_path / "out.gif")
        with pytest.raises(RuntimeError):
            video.FfmpegWriter(str(tmp_path / "x.mp4"), 8, 8)
        with pytest.raises(RuntimeError):
            io.open_video(str(tmp_path / "x.mp4"), width=8, height=8)
    assert os.path.getsize(tmp_path / "out.yuv") == 16 * 24 * 3
    with pytest.raises(ValueError):
        io.open_video(str(tmp_path / "x.avif"))


# ---------------------------------------------------------------- camera

def test_synthetic_camera_frames_equal_reference():
    cam = io.SyntheticCamera(1280, 720, fps=30.0, n_frames=60)
    ref = jcamera.SyntheticCamera(1280, 720, fps=30.0, n_frames=60)
    for t in (0, 1, 21, 59):
        np.testing.assert_array_equal(cam.frame_at(t), ref.frame_at(t))


def _collect(cam, n, finite=True, timeout=5.0):
    """The first ``n`` frames ``cam`` delivers; a ``finite`` camera is
    waited for until its capture loop ends."""
    got, done = [], threading.Event()

    def cb(frame):
        got.append(frame.copy())
        if len(got) >= n:
            done.set()

    cam.set_callback(cb)
    cam.start()
    done.wait(timeout=timeout)
    if finite:
        cam.finished.wait(timeout=timeout)
    cam.stop()
    assert cam._thread is None and not cam._running.is_set()
    return got


def test_synthetic_camera_delivers_n_frames():
    cam = io.SyntheticCamera(64, 48, fps=200.0, n_frames=5)
    got = _collect(cam, 5)
    assert len(got) == 5 and cam.finished.is_set()
    for t, f in enumerate(got):
        np.testing.assert_array_equal(f, cam.frame_at(t))


def test_video_file_camera_replays_a_raw_file(tmp_path):
    p, frames = _i420_file(tmp_path, n=3)
    cam = camera.VideoFileCamera(p, fps=500.0, loop=False, gray=False,
                                 reuse_buffers=True)
    got = _collect(cam, 3)
    assert len(got) == 3 and cam.finished.is_set()
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f[:48].reshape(6, 8))


def test_v4l2_graceful_without_hardware():
    devs = io.list_devices()
    assert devs[:2] == ["synthetic:checkerboard", "file:<path>"]
    assert devs == jcamera.list_devices()
    if not any(d.startswith("v4l2:") for d in devs):
        cam = camera.V4l2Camera("/dev/video0")
        with pytest.raises(camera.CameraError):
            cam.start()
        assert cam._fd is None and not cam._maps


class _Timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _Timecode(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
                ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
                ("userbits", ctypes.c_uint8 * 4)]


class _M(ctypes.Union):
    _fields_ = [("offset", ctypes.c_uint32), ("userptr", ctypes.c_ulong),
                ("planes", ctypes.c_void_p), ("fd", ctypes.c_int32)]


class V4l2Buffer(ctypes.Structure):
    """struct v4l2_buffer of linux/videodev2.h."""
    _fields_ = [("index", ctypes.c_uint32), ("type", ctypes.c_uint32),
                ("bytesused", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("field", ctypes.c_uint32), ("timestamp", _Timeval),
                ("timecode", _Timecode), ("sequence", ctypes.c_uint32),
                ("memory", ctypes.c_uint32), ("m", _M),
                ("length", ctypes.c_uint32), ("reserved2", ctypes.c_uint32),
                ("request_fd", ctypes.c_int32)]


def test_v4l2_buffer_offsets_match_the_abi():
    if ctypes.sizeof(ctypes.c_void_p) != 8:
        pytest.skip("the offsets are the 64-bit ABI's")
    cam = camera.V4l2Camera
    assert ctypes.sizeof(V4l2Buffer) == cam._BUF_SIZE == 88
    for field, off in (("index", cam._BUF_INDEX), ("type", cam._BUF_TYPE),
                       ("bytesused", cam._BUF_BYTESUSED),
                       ("memory", cam._BUF_MEMORY), ("m", cam._BUF_M_OFFSET),
                       ("length", cam._BUF_LENGTH)):
        assert getattr(V4l2Buffer, field).offset == off, field
    buf = V4l2Buffer.from_buffer(cam()._buffer(3))
    assert (buf.index, buf.type, buf.memory) == (3, 1, 1)


class _FakeV4l2:
    """A V4L2 capture device behind ``fcntl.ioctl``: four mmap buffers of a
    regular file, each holding one YUYV frame, dequeued round-robin. Like a
    device, it rejects a v4l2_buffer whose type or memory field is not
    capture / mmap with EINVAL."""

    def __init__(self, path, w, h):
        self.w, self.h = w, h
        rs = np.random.default_rng(9)
        self.gray = [rs.integers(0, 256, (h, w), dtype=np.uint8)
                     for _ in range(4)]
        data = bytearray(4 * 4096)
        for i, g in enumerate(self.gray):
            yuyv = np.stack([g, np.full_like(g, 128)], -1)
            data[i * 4096: i * 4096 + g.size * 2] = yuyv.tobytes()
        with open(path, "wb") as f:
            f.write(bytes(data))
        self.queued, self.dequeued = [], 0

    def ioctl(self, fd, req, arg, *rest):
        cam = camera.V4l2Camera
        if req in (cam._VIDIOC_S_FMT, cam._VIDIOC_REQBUFS,
                   cam._VIDIOC_STREAMON, cam._VIDIOC_STREAMOFF):
            return 0
        buf = V4l2Buffer.from_buffer(arg)
        if buf.type != 1 or buf.memory != 1:
            raise OSError(errno.EINVAL, "invalid v4l2_buffer")
        if req == cam._VIDIOC_QUERYBUF:
            buf.length, buf.m.offset = 4096, buf.index * 4096
        elif req == cam._VIDIOC_QBUF:
            self.queued.append(buf.index)
        elif req == cam._VIDIOC_DQBUF:
            if not self.queued:
                raise OSError(errno.EAGAIN, "no buffer")
            buf.index = self.queued.pop(0)
            buf.bytesused = self.w * self.h * 2
            self.dequeued += 1
        return 0


def test_v4l2_capture_through_a_fake_device(tmp_path, monkeypatch):
    dev = str(tmp_path / "video0")
    drv = _FakeV4l2(dev, 8, 6)
    monkeypatch.setattr(fcntl, "ioctl", drv.ioctl)
    cam = camera.V4l2Camera(dev, width=8, height=6)
    got = _collect(cam, 6, finite=False)
    assert len(got) >= 6 and cam._fd is None and not cam._maps
    for i, f in enumerate(got[:6]):
        np.testing.assert_array_equal(f, drv.gray[i % 4])

    ref = jcamera.V4l2Camera(dev, width=8, height=6)
    with pytest.raises(OSError):          # type at 12, memory at 76
        ref.start()
    assert ref._fd is None
