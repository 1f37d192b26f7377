"""Camera capture abstraction (mirror of ``compv_tpu/io/camera.py``).

Reference: CompVCamera (camera/include/compv/camera/compv_camera.h:61-87):
devices() / start(deviceId) / stop() / OnNewFrame callback delivering a
frame, with per-OS plugin backends (DirectShow / MediaFoundation /
Android NDK, SURVEY.md §2.5).

Backends: a file/video-backed camera (replays any VideoReader at a target
fps), a synthetic pattern camera (moving checkerboard for demos/tests),
and a Linux V4L2 hardware backend (pure-Python ioctl/mmap, no
dependencies) that degrades gracefully — list_devices() only reports
/dev/video* nodes that actually open, and V4l2Camera raises a clear
CameraError otherwise. The capture loop runs on a daemon thread and
delivers numpy u8 frames through the callback exactly like the reference's
capture plugins do.

The V4L2 backend reads and writes ``struct v4l2_buffer`` at its offsets in
the 64-bit ABI (linux/videodev2.h): index 0, type 4, bytesused 8, memory
60, m.offset 64, length 72, 88 bytes in all. ``compv_tpu/io/camera.py``
uses 12, 4, 76 and 80 for type, bytesused, memory and length.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from compv_tpu_torch.io.video import VideoReader, open_video

__all__ = ["Camera", "VideoFileCamera", "SyntheticCamera", "V4l2Camera",
           "CameraError", "list_devices"]


class CameraError(RuntimeError):
    """No such device / device busy / unsupported format."""

FrameCallback = Callable[[np.ndarray], None]


def list_devices():
    """Reference CompVCamera::devices(): virtual backends plus any
    OPENABLE /dev/video* V4L2 node (probed, not just globbed — nodes that
    fail to open are omitted so headless hosts degrade gracefully)."""
    import glob
    import os
    devs = ["synthetic:checkerboard", "file:<path>"]
    for node in sorted(glob.glob("/dev/video*")):
        try:
            fd = os.open(node, os.O_RDWR | os.O_NONBLOCK)
            os.close(fd)
            devs.append(f"v4l2:{node}")
        except OSError:
            continue
    return devs


class Camera:
    """start()/stop() + OnNewFrame callback lifecycle."""

    def __init__(self):
        self._cb: Optional[FrameCallback] = None
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self.finished = threading.Event()   # set when the capture loop
                                            # exits (exhaustion or stop) —
                                            # run_live waits on it

    def set_callback(self, cb: FrameCallback) -> None:
        self._cb = cb

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running.set()
        self.finished.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self):
        try:
            self._loop()
        finally:
            self.finished.set()

    def _loop(self):
        raise NotImplementedError


class VideoFileCamera(Camera):
    def __init__(self, path: str, fps: float = 30.0, loop: bool = True, **kw):
        super().__init__()
        self.reader: VideoReader = open_video(path, **kw)
        self.fps = fps
        self.loop = loop

    def _loop(self):
        period = 1.0 / self.fps
        while self._running.is_set():
            for frame in self.reader:
                if not self._running.is_set():
                    return
                t0 = time.perf_counter()
                if self._cb is not None:
                    self._cb(frame)
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)
            if not self.loop:
                return


class SyntheticCamera(Camera):
    """Moving checkerboard + gradient scene, deterministic."""

    def __init__(self, width: int = 640, height: int = 480, fps: float = 30.0,
                 n_frames: int | None = None):
        super().__init__()
        self.w, self.h, self.fps = width, height, fps
        self.n_frames = n_frames

    def frame_at(self, t: int) -> np.ndarray:
        yy, xx = np.mgrid[0:self.h, 0:self.w]
        shift = (t * 3) % 64
        ch = (((xx + shift) // 32) + (yy // 32)) % 2
        base = 40 + 150 * ch + (xx * 30 // self.w)
        return np.clip(base, 0, 255).astype(np.uint8)

    def _loop(self):
        period = 1.0 / self.fps
        t = 0
        while self._running.is_set():
            if self.n_frames is not None and t >= self.n_frames:
                return
            if self._cb is not None:
                self._cb(self.frame_at(t))
            t += 1
            time.sleep(period)


class V4l2Camera(Camera):
    """Linux V4L2 capture (the reference's plugin_directshow /
    plugin_mfoundation / plugin_androidcamera analogue for this platform,
    SURVEY.md §2.5) — pure Python ioctl + mmap, no dependencies.

    Streams YUYV (the near-universal USB-webcam format) and delivers
    grayscale (H, W) u8 frames (the Y plane) through the standard
    OnNewFrame callback. Raises CameraError on hosts without a camera —
    the graceful-degradation contract list_devices() advertises."""

    # v4l2 ABI constants (linux/videodev2.h)
    _VIDIOC_QUERYCAP = 0x80685600
    _VIDIOC_S_FMT = 0xC0D05605
    _VIDIOC_REQBUFS = 0xC0145608
    _VIDIOC_QUERYBUF = 0xC0585609
    _VIDIOC_QBUF = 0xC058560F
    _VIDIOC_DQBUF = 0xC0585611
    _VIDIOC_STREAMON = 0x40045612
    _VIDIOC_STREAMOFF = 0x40045613
    _V4L2_PIX_FMT_YUYV = 0x56595559          # 'YUYV'
    _V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
    _V4L2_MEMORY_MMAP = 1
    _N_BUFFERS = 4
    # struct v4l2_buffer, 64-bit ABI: field offsets and size
    _BUF_SIZE = 88
    _BUF_INDEX = 0
    _BUF_TYPE = 4
    _BUF_BYTESUSED = 8
    _BUF_MEMORY = 60
    _BUF_M_OFFSET = 64
    _BUF_LENGTH = 72

    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480):
        super().__init__()
        self.device = device
        self.w, self.h = width, height
        self._fd = None
        self._maps = []

    # ---- V4L2 plumbing (import fcntl/mmap lazily: Linux-only) ----
    def _open(self):
        import fcntl
        import mmap
        import os
        import struct
        try:
            self._fd = os.open(self.device, os.O_RDWR | os.O_NONBLOCK)
        except OSError as e:
            raise CameraError(
                f"cannot open {self.device}: {e.strerror} — no camera on "
                "this host? list_devices() reports openable nodes") from e
        try:
            # S_FMT: v4l2_format for VIDEO_CAPTURE with YUYV
            fmt = bytearray(208)
            struct.pack_into("I", fmt, 0, self._V4L2_BUF_TYPE_VIDEO_CAPTURE)
            struct.pack_into("IIII", fmt, 8, self.w, self.h,
                             self._V4L2_PIX_FMT_YUYV, 1)
            fcntl.ioctl(self._fd, self._VIDIOC_S_FMT, fmt)
            got_w, got_h, got_fmt = struct.unpack_from("III", fmt, 8)
            if got_fmt != self._V4L2_PIX_FMT_YUYV:
                raise CameraError(f"{self.device} cannot stream YUYV")
            self.w, self.h = got_w, got_h
            # REQBUFS: 4 mmap buffers
            req = bytearray(20)
            struct.pack_into("III", req, 0, self._N_BUFFERS,
                             self._V4L2_BUF_TYPE_VIDEO_CAPTURE,
                             self._V4L2_MEMORY_MMAP)
            fcntl.ioctl(self._fd, self._VIDIOC_REQBUFS, req)
            count = struct.unpack_from("I", req, 0)[0]
            if count < 1:
                raise CameraError(f"{self.device}: no mmap buffers granted")
            for i in range(count):
                buf = self._buffer(i)
                fcntl.ioctl(self._fd, self._VIDIOC_QUERYBUF, buf)
                length = struct.unpack_from("I", buf, self._BUF_LENGTH)[0]
                offset = struct.unpack_from("I", buf, self._BUF_M_OFFSET)[0]
                self._maps.append(mmap.mmap(
                    self._fd, length, mmap.MAP_SHARED,
                    mmap.PROT_READ, offset=offset))
                fcntl.ioctl(self._fd, self._VIDIOC_QBUF, buf)
            on = struct.pack("I", self._V4L2_BUF_TYPE_VIDEO_CAPTURE)
            fcntl.ioctl(self._fd, self._VIDIOC_STREAMON, on)
        except (OSError, CameraError):
            self._close()
            raise

    def _buffer(self, index: int = 0) -> bytearray:
        """A v4l2_buffer for an mmap capture buffer, as QUERYBUF, QBUF and
        DQBUF take it."""
        import struct
        buf = bytearray(self._BUF_SIZE)
        struct.pack_into("I", buf, self._BUF_INDEX, index)
        struct.pack_into("I", buf, self._BUF_TYPE,
                         self._V4L2_BUF_TYPE_VIDEO_CAPTURE)
        struct.pack_into("I", buf, self._BUF_MEMORY, self._V4L2_MEMORY_MMAP)
        return buf

    def _close(self):
        import fcntl
        import os
        import struct
        if self._fd is not None:
            try:
                off = struct.pack("I", self._V4L2_BUF_TYPE_VIDEO_CAPTURE)
                fcntl.ioctl(self._fd, self._VIDIOC_STREAMOFF, off)
            except OSError:
                pass
            for m in self._maps:
                m.close()
            self._maps = []
            os.close(self._fd)
            self._fd = None

    def start(self) -> None:
        # open the device on the CALLER's thread so configuration errors
        # raise where the user can catch them (graceful degradation)
        if self._thread is not None:
            return
        self._open()
        super().start()

    def stop(self) -> None:
        super().stop()
        self._close()

    def _loop(self):
        import fcntl
        import select
        import struct
        while self._running.is_set():
            r, _, _ = select.select([self._fd], [], [], 0.5)
            if not r:
                continue
            buf = self._buffer()
            try:
                fcntl.ioctl(self._fd, self._VIDIOC_DQBUF, buf)
            except OSError:
                continue
            idx = struct.unpack_from("I", buf, self._BUF_INDEX)[0]
            used = struct.unpack_from("I", buf, self._BUF_BYTESUSED)[0]
            raw = np.frombuffer(self._maps[idx], np.uint8,
                                count=min(used, self.w * self.h * 2))
            if raw.size == self.w * self.h * 2 and self._cb is not None:
                gray = raw.reshape(self.h, self.w, 2)[:, :, 0].copy()
                self._cb(gray)
            fcntl.ioctl(self._fd, self._VIDIOC_QBUF, buf)
