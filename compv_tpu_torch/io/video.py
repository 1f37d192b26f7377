"""Video IO (host-side frame sources; mirror of ``compv_tpu/io/video.py``).

Reference: CompVVideoReaderFFmpeg (core/video/compv_core_video_reader_ffmpeg.cxx:74-124)
decodes via libavcodec. Sources that need no ffmpeg:
  * raw .yuv multi-frame files (I420/gray, frame count = size / frame_bytes)
  * directories of image files (sorted)
  * animated GIFs (PIL)
An ffmpeg-backed reader is gated behind binary availability.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Iterator

import numpy as np

from compv_tpu_torch.io.image_io import parse_raw_filename, read_image

__all__ = ["VideoReader", "open_video", "RawYuvReader", "ImageSequenceReader",
           "GifReader", "FfmpegReader", "VideoWriterRaw", "FfmpegWriter",
           "GifWriter", "open_writer"]


class VideoReader:
    """Iterator protocol: yields (H, W) gray or (H, W, 3) RGB u8 frames."""

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class RawYuvReader(VideoReader):
    """Raw frame file reader driven by the native PrefetchLoader: the C++
    IO thread reads frame t+1 while frame t computes (reference overlaps
    capture and compute the same way, samples/object_recognition)."""

    def __init__(self, path: str, width: int | None = None,
                 height: int | None = None, gray: bool = True,
                 reuse_buffers: bool = False):
        if width is None or height is None:
            width, height = parse_raw_filename(path)
        self.path = path
        self.w, self.h = width, height
        self.gray = gray
        # reuse_buffers: stage frames in the native AlignedPool and recycle
        # each buffer once the consumer advances (streaming-borrow contract,
        # like the reference's recycled capture buffers) — do not retain
        # yielded frames across iterations in this mode. A frame copied to
        # the card with a blocking .to(device) is safe: the copy from this
        # pageable buffer has finished when it returns. Pinning the pool
        # and copying with non_blocking=True would race with the recycle.
        self.reuse_buffers = reuse_buffers
        self.frame_bytes = width * height if gray else width * height * 3 // 2
        self.n = os.path.getsize(path) // self.frame_bytes

    def __len__(self):
        return self.n

    def __iter__(self):
        from compv_tpu_torch.native_rt import AlignedPool, PrefetchLoader
        pool = AlignedPool() if self.reuse_buffers else None
        loader = PrefetchLoader(self.path, 1, self.frame_bytes, pool=pool)
        try:
            for buf in loader:
                flat = buf.ravel()
                if self.gray:
                    yield flat.reshape(self.h, self.w)
                else:
                    yield flat[: self.w * self.h].reshape(self.h, self.w)
                loader.release(buf)   # consumer advanced; recycle staging
        finally:
            loader.close()
            if pool is not None:
                pool.close()


class ImageSequenceReader(VideoReader):
    def __init__(self, directory: str, pattern: str = ""):
        names = sorted(os.listdir(directory))
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".ppm")
        self.paths = [os.path.join(directory, n) for n in names
                      if n.lower().endswith(exts) and pattern in n]

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for p in self.paths:
            yield read_image(p)

    def read_batch(self, start: int = 0, count: int | None = None,
                   executor=None) -> list:
        """Decode a batch of frames in parallel on the native fork-join
        Executor (host-side batch decode feeding device pipelines)."""
        from compv_tpu_torch.native_rt import Executor
        paths = self.paths[start: None if count is None else start + count]
        out = [None] * len(paths)

        def work(b, e):
            for i in range(b, e):
                out[i] = read_image(paths[i])

        ex = executor or Executor()
        try:
            ex.parallel_for(work, 0, len(paths))
        finally:
            if executor is None:
                ex.close()
        return out


class GifReader(VideoReader):
    def __init__(self, path: str):
        from PIL import Image
        self.img = Image.open(path)
        self.n = getattr(self.img, "n_frames", 1)

    def __len__(self):
        return self.n

    def __iter__(self):
        from PIL import ImageSequence
        for frame in ImageSequence.Iterator(self.img):
            yield np.asarray(frame.convert("RGB"), np.uint8)


class FfmpegReader(VideoReader):
    """Pipe-decode via the ffmpeg binary when present (the reference's
    decode path analogue). Raises at construction if unavailable."""

    def __init__(self, path: str, width: int, height: int, gray: bool = True):
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("ffmpeg binary not found on PATH")
        self.path, self.w, self.h, self.gray = path, width, height, gray

    def __len__(self):
        return -1

    def __iter__(self):
        fmt = "gray" if self.gray else "rgb24"
        bpf = self.w * self.h * (1 if self.gray else 3)
        proc = subprocess.Popen(
            ["ffmpeg", "-i", self.path, "-f", "rawvideo", "-pix_fmt", fmt,
             "-s", f"{self.w}x{self.h}", "-"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        try:
            while True:
                buf = proc.stdout.read(bpf)
                if len(buf) < bpf:
                    break
                a = np.frombuffer(buf, np.uint8)
                yield a.reshape(self.h, self.w) if self.gray else \
                    a.reshape(self.h, self.w, 3)
        finally:
            proc.terminate()


class VideoWriterRaw:
    """Append-frames raw writer (reference has an ffmpeg writer; raw is the
    dependency-free equivalent)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")

    def write(self, frame: np.ndarray) -> None:
        self.f.write(np.ascontiguousarray(frame).tobytes())

    def close(self) -> None:
        self.f.close()


class FfmpegWriter:
    """Pipe-encode via the ffmpeg binary (the host analogue of the
    reference's libavformat writer, core/video/compv_core_video_writer_ffmpeg.cxx:
    open stream -> write_frame loop -> close/trailer). We feed raw rgb24/gray
    frames over stdin and let ffmpeg own the container/codec state machine.
    Raises at construction if the binary is unavailable (use open_writer for
    the graceful fallback)."""

    def __init__(self, path: str, width: int, height: int, fps: float = 25.0,
                 gray: bool = False, crf: int = 23):
        if shutil.which("ffmpeg") is None:
            raise RuntimeError("ffmpeg binary not found on PATH")
        if width % 2 or height % 2:
            # yuv420p subsamples chroma 2x2; odd dims make ffmpeg abort
            # mid-stream, which would only surface as a BrokenPipeError
            raise ValueError(
                f"FfmpegWriter needs even dimensions for yuv420p output, "
                f"got {width}x{height} (pad or crop the frame first)")
        self.w, self.h, self.gray = width, height, gray
        fmt = "gray" if gray else "rgb24"
        # stderr goes to an unlinked temp file (not a PIPE: a full pipe
        # buffer would deadlock against our stdin writes) so close() can
        # report the encoder's actual complaint on failure
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", fmt,
             "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
             "-an", "-pix_fmt", "yuv420p", "-crf", str(crf), path],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=self._err)

    def write(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, np.uint8)
        exp = (self.h, self.w) if self.gray else (self.h, self.w, 3)
        if frame.shape != exp:
            raise ValueError(f"frame shape {frame.shape} != {exp}")
        try:
            self.proc.stdin.write(frame.tobytes())
        except BrokenPipeError:
            raise RuntimeError(
                "ffmpeg exited mid-stream: " + self._err_tail()) from None

    def _err_tail(self, nbytes: int = 2048) -> str:
        try:
            self._err.seek(0, 2)
            size = self._err.tell()
            self._err.seek(max(0, size - nbytes))
            return self._err.read().decode("utf-8", "replace").strip()
        except Exception:
            return "<stderr unavailable>"

    def close(self) -> None:
        self.proc.stdin.close()
        rc = self.proc.wait()
        tail = self._err_tail()
        self._err.close()
        if rc != 0:
            raise RuntimeError(f"ffmpeg encode failed (rc={rc}): {tail}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GifWriter:
    """Animated-GIF writer via PIL — the dependency-free playable fallback
    when the ffmpeg binary is absent. Buffers frames host-side
    and writes on close."""

    def __init__(self, path: str, fps: float = 25.0):
        self.path = path
        self.ms = max(1, int(round(1000.0 / fps)))
        self.frames: list = []

    def write(self, frame: np.ndarray) -> None:
        from PIL import Image
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.ndim == 2:
            frame = np.stack([frame] * 3, -1)
        self.frames.append(Image.fromarray(frame))

    def close(self) -> None:
        if self.frames:
            self.frames[0].save(self.path, save_all=True,
                                append_images=self.frames[1:],
                                duration=self.ms, loop=0)
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_writer(path: str, width: int, height: int, fps: float = 25.0,
                gray: bool = False):
    """Best-available video writer factory: ffmpeg-backed mp4/containers when
    the binary exists, animated GIF otherwise (the returned writer's actual
    path is in `.path`/ffmpeg's target). Mirrors the reference's newObj
    factory gating on codec availability."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gif":
        return GifWriter(path, fps=fps)
    if ext == ".yuv" or ext == ".raw":
        return VideoWriterRaw(path)
    if shutil.which("ffmpeg") is not None:
        return FfmpegWriter(path, width, height, fps=fps, gray=gray)
    w = GifWriter(os.path.splitext(path)[0] + ".gif", fps=fps)
    return w


def open_video(path: str, **kw) -> VideoReader:
    """Factory by extension/type (reference newObj factory pattern)."""
    if os.path.isdir(path):
        return ImageSequenceReader(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".yuv":
        return RawYuvReader(path, **kw)
    if ext == ".gif":
        return GifReader(path)
    if ext in (".mp4", ".avi", ".mkv", ".mov", ".webm"):
        return FfmpegReader(path, **kw)
    raise ValueError(f"unsupported video source: {path}")
