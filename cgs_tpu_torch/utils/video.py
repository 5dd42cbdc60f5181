"""MP4 writing (copy of `cgs_tpu/utils/video.py`: `VideoSink`,
`vidwrite`; reference main.py:44-63 pipes raw RGB into an ffmpeg
subprocess). The ffmpeg binary is used when present, else
cv2.VideoWriter; cv2 is imported only when needed."""

from __future__ import annotations

import shutil
import subprocess

import numpy as np


class VideoSink:
    """Incremental MP4 writer: append frames chunk-by-chunk instead of
    materializing the whole (N, H, W, 3) array (a full-length eval
    video is multiple GB). Lazily opens on the first frame (needs the
    dimensions); ffmpeg pipe when the binary exists, cv2 otherwise."""

    def __init__(self, fn: str, framerate: int = 32):
        self.fn = fn
        self.framerate = framerate
        self._proc = None
        self._cv2 = None
        self._hw = None

    def _open(self, h: int, w: int) -> None:
        self._hw = (h - h % 2, w - w % 2)  # yuv420p needs even dims
        if shutil.which("ffmpeg"):
            hh, ww = self._hw
            cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt",
                   "rgb24", "-s", f"{ww}x{hh}", "-r",
                   str(self.framerate), "-i", "pipe:", "-pix_fmt",
                   "yuv420p", "-vcodec", "libx264", "-r",
                   str(self.framerate), self.fn]
            # keep stderr: a failed encode (missing dir, full disk, no
            # libx264) must be diagnosable, not a silent absent file
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        else:
            import cv2
            self._cv2 = cv2.VideoWriter(
                self.fn, cv2.VideoWriter_fourcc(*"mp4v"),
                self.framerate, (self._hw[1], self._hw[0]))
            if not self._cv2.isOpened():
                # cv2.VideoWriter does not raise on a bad path — its
                # write() just no-ops and the video silently never
                # lands on disk
                self._cv2 = None
                raise RuntimeError(
                    f"cv2.VideoWriter could not open {self.fn} "
                    "(missing directory or unsupported codec?)")

    def append(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = np.clip(frame, 0, 255).astype(np.uint8)
        if self._hw is None:
            self._open(*frame.shape[:2])
        if frame.shape[0] < self._hw[0] or frame.shape[1] < self._hw[1]:
            # a smaller frame would under-fill the rawvideo pipe and
            # silently desync every subsequent ffmpeg frame
            raise ValueError(
                f"frame {frame.shape[:2]} smaller than the sink's "
                f"{self._hw} (fixed by the first appended frame)")
        frame = frame[: self._hw[0], : self._hw[1]]
        if self._proc is not None:
            try:
                self._proc.stdin.write(frame.tobytes())
            except BrokenPipeError:
                raise RuntimeError(
                    "ffmpeg died mid-stream: "
                    + self._drain_stderr()) from None
        else:
            import cv2
            self._cv2.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def _drain_stderr(self) -> str:
        err = b""
        if self._proc is not None and self._proc.stderr is not None:
            try:
                err = self._proc.stderr.read() or b""
            except Exception:
                pass
        return err.decode(errors="replace")[-2000:]

    def close(self) -> None:
        if self._proc is not None:
            proc = self._proc
            self._proc = None
            proc.stdin.close()
            rc = proc.wait()
            err = b""
            if proc.stderr is not None:
                err = proc.stderr.read() or b""
                proc.stderr.close()
            if rc != 0:
                raise RuntimeError(
                    f"ffmpeg exited {rc} writing {self.fn}: "
                    f"{err.decode(errors='replace')[-2000:]}")
        if self._cv2 is not None:
            self._cv2.release()
            self._cv2 = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def vidwrite(fn: str, images, framerate: int = 32) -> None:
    """Write (N, H, W, 3) RGB frames to an MP4 file."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = np.clip(images, 0, 255).astype(np.uint8)
    with VideoSink(fn, framerate=framerate) as sink:
        for frame in images:
            sink.append(frame)
