"""Video saving on the host (copy of `stableavatar_tpu/utils/video_io.py`,
held equal by tests/test_torch_utils.py): `to_uint8`, `save_videos_grid`
(imageio mp4 / gif, or a PNG frame directory without an ffmpeg backend) and
`StreamingVideoWriter` for unbounded-length output.  PIL, imageio and
ffmpeg are imported or called only when a function needs them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[B, C, T, H, W] float in [0,1] -> [T, H, W*B, C] uint8 grid."""
    v = np.clip(video, 0.0, 1.0)
    v = (v * 255.0).round().astype(np.uint8)
    v = v.transpose(2, 3, 0, 4, 1)  # [T, H, B, W, C]
    t, h, b, w, c = v.shape
    return v.reshape(t, h, b * w, c)


def save_videos_grid(video: np.ndarray, path: str, fps: int = 25) -> str:
    """video [B, C, T, H, W] in [0, 1] -> mp4/gif on disk.

    Returns the path actually written: with no ffmpeg backend available the
    fallback writes per-frame PNGs into a directory named after the target
    (and that directory path is returned so callers report the truth)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = to_uint8(video)
    import imageio

    if path.endswith(".gif"):
        imageio.mimsave(path, list(frames), fps=fps)
        return path
    try:
        writer = imageio.get_writer(path, fps=fps, codec="libx264", quality=8)
    except Exception:
        # no ffmpeg backend: fall back to per-frame PNGs next to the target
        stem = os.path.splitext(path)[0]
        os.makedirs(stem, exist_ok=True)
        for i, fr in enumerate(frames):
            imageio.imwrite(os.path.join(stem, f"frame_{i:06d}.png"), fr)
        print(f"[stableavatar-tpu] no ffmpeg video backend - wrote "
              f"{len(frames)} PNG frames to {stem}/ instead of {path}")
        return stem
    with writer:
        for fr in frames:
            writer.append_data(fr)
    return path


class StreamingVideoWriter:
    """Incremental mp4 writer for unbounded-length generation.

    The long pipeline's latent buffers are O(duration/64) in HBM, but
    returning the decoded video as one float array makes HOST RAM the
    binding constraint (a 5-minute 512^2 clip is ~23 GB f32).  Streaming
    each decoded uint8 segment straight to disk keeps host memory
    O(segment).  Wire via `generate_long(frame_sink=writer.append)`.

    Backend ladder: (1) direct `ffmpeg` raw-RGB pipe when the binary is on
    PATH — one pass, optionally muxing `audio_path` in the same process
    (replaces the reference's separate frame-dump + mux,
    `inference.py:53-89`); (2) imageio/libx264 when only the imageio-ffmpeg
    backend exists (audio muxed separately by the caller); (3) per-frame PNG
    directory.  `close()` returns the path actually written;
    `audio_muxed` tells the caller whether audio is already embedded."""

    def __init__(self, path: str, fps: int = 25,
                 audio_path: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._path = path
        self._fps = fps
        self._audio_path = audio_path
        self._writer = None
        self._proc = None
        self._stderr_path: Optional[str] = None
        self._png_dir: Optional[str] = None
        self._dims = None  # (H, W) frozen at the first segment
        self.frames_written = 0
        self.audio_muxed = False

    def _start_ffmpeg(self, h: int, w: int) -> bool:
        import subprocess
        import tempfile

        from stableavatar_tpu_torch.utils.media import ffmpeg_available

        if not ffmpeg_available():
            return False
        cmd = ["ffmpeg", "-y",
               "-f", "rawvideo", "-pix_fmt", "rgb24",
               "-s", f"{w}x{h}", "-r", str(self._fps), "-i", "-"]
        if self._audio_path and os.path.exists(self._audio_path):
            # -shortest crops the audio to the video length (the reference's
            # save_video_ffmpeg crop+mux, inference.py:81-89)
            cmd += ["-i", self._audio_path, "-c:a", "aac", "-shortest"]
            self.audio_muxed = True
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", self._path]
        try:
            # stderr to a temp file: PIPE would deadlock unread, DEVNULL
            # would leave a mid-stream encoder failure undiagnosable
            fd, self._stderr_path = tempfile.mkstemp(suffix=".ffmpeg.log")
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=fd,
            )
            os.close(fd)
            return True
        except OSError:
            self.audio_muxed = False
            self._proc = None
            return False

    def _ffmpeg_error(self) -> str:
        tail = ""
        if self._stderr_path and os.path.exists(self._stderr_path):
            with open(self._stderr_path, errors="replace") as f:
                tail = " | ".join(f.read().strip().splitlines()[-3:])
        return (f"ffmpeg failed writing {self._path} (rc="
                f"{self._proc.poll()}): {tail or 'no stderr'}")

    def _ensure_writer(self, h: int, w: int):
        if (self._writer is not None or self._proc is not None
                or self._png_dir is not None):
            return
        if self._start_ffmpeg(h, w):
            return
        import imageio

        try:
            self._writer = imageio.get_writer(
                self._path, fps=self._fps, codec="libx264", quality=8
            )
        except Exception:
            self._png_dir = os.path.splitext(self._path)[0]
            os.makedirs(self._png_dir, exist_ok=True)

    def append(self, segment: np.ndarray) -> None:
        """segment: [B, 3, T, H, W] uint8 (or float in [0,1])."""
        if segment.dtype != np.uint8:
            segment = (np.clip(segment, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        frames = segment.transpose(2, 3, 0, 4, 1)  # [T, H, B, W, C]
        t, h, b, w, c = frames.shape
        frames = frames.reshape(t, h, b * w, c)
        if self._dims is None:
            self._dims = (h, b * w)
        elif self._dims != (h, b * w):
            # the raw pipe (and the mp4 container) can't change frame size
            # mid-stream — piping different dims would silently garble output
            raise ValueError(
                f"segment dims {(h, b * w)} differ from the first segment's "
                f"{self._dims}; a StreamingVideoWriter is fixed-geometry"
            )
        self._ensure_writer(h, b * w)
        import imageio

        for fr in frames:
            if self._proc is not None:
                try:
                    self._proc.stdin.write(np.ascontiguousarray(fr).tobytes())
                except (BrokenPipeError, OSError) as e:
                    raise RuntimeError(self._ffmpeg_error()) from e
            elif self._writer is not None:
                self._writer.append_data(fr)
            else:
                imageio.imwrite(
                    os.path.join(self._png_dir,
                                 f"frame_{self.frames_written:06d}.png"), fr)
            self.frames_written += 1

    def abort(self) -> None:
        """Best-effort cleanup after a failed generation: kill the encoder /
        close the backend without finalizing.  Safe to call any time; used
        by long-lived servers so failed requests don't leak ffmpeg
        children or open pipes."""
        if self._proc is not None:
            try:
                self._proc.stdin.close()
            except OSError:
                pass
            self._proc.kill()
            self._proc.wait()
            self._proc = None
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
        self._cleanup_stderr()

    def _cleanup_stderr(self):
        if self._stderr_path and os.path.exists(self._stderr_path):
            try:
                os.remove(self._stderr_path)
            except OSError:
                pass

    def close(self) -> str:
        if self._proc is not None:
            try:
                self._proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass  # rc check below carries the diagnosis
            rc = self._proc.wait()
            if rc != 0:
                raise RuntimeError(self._ffmpeg_error())
            self._cleanup_stderr()
            return self._path
        if self._writer is not None:
            self._writer.close()
            return self._path
        if self._png_dir is not None:
            print(f"[stableavatar-tpu] no ffmpeg video backend - wrote "
                  f"{self.frames_written} PNG frames to {self._png_dir}/")
            return self._png_dir
        return self._path


def save_image(image: np.ndarray, path: str) -> None:
    """image [C, H, W] in [0, 1]."""
    import imageio

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = (np.clip(image, 0, 1) * 255).round().astype(np.uint8).transpose(1, 2, 0)
    imageio.imwrite(path, arr)
