"""Host-side audio and image IO without heavy optional dependencies (copy of
`stableavatar_tpu/utils/media.py`, held equal by tests/test_torch_utils.py).

WAV decoding is stdlib `wave` + numpy (or the native decoder of
`native/audioio.cpp`), resampling `scipy.signal.resample_poly`; images load
with PIL; audio muxing and extraction need the `ffmpeg` binary and raise a
clear error without it.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np


def load_wav(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """Load a PCM WAV file to mono float32 in [-1, 1], resampled to
    target_sr (the reference uses `librosa.load(vocal, sr=16000)`,
    `inference.py:543`)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)

    # fast path: native C++ decode + windowed-sinc resample (native/audioio.cpp)
    from stableavatar_tpu_torch.utils import native_audio

    native = native_audio.decode_pcm(raw, width, ch)
    if native is not None:
        if sr != target_sr:
            res = native_audio.resample(native, sr, target_sr)
            if res is not None:
                return res, target_sr
            return resample(native, sr, target_sr), target_sr
        return native, target_sr

    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")

    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)

    if sr != target_sr:
        data = resample(data, sr, target_sr)
    return data.astype(np.float32), target_sr


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def save_wav(path: str, data: np.ndarray, sr: int = 16000) -> None:
    data16 = np.clip(data, -1.0, 1.0)
    data16 = (data16 * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(data16.tobytes())


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """RGB image -> [1, 3, H, W] float32 in [-1, 1] (reference image prep,
    `wan_inference_long_pipeline.py:665-674`)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size)  # (W, H)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - 0.5) * 2.0
    return arr.transpose(2, 0, 1)[None]


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def mux_audio(video_path: str, audio_path: str, out_path: str) -> None:
    """ffmpeg audio mux (`app.py:229-235`); gated on ffmpeg presence."""
    if not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg is not available in this environment; video saved without audio"
        )
    subprocess.run(
        ["ffmpeg", "-y", "-i", video_path, "-i", audio_path, "-c:v", "copy",
         "-c:a", "aac", "-shortest", out_path],
        check=True,
        capture_output=True,
    )


def extract_audio(video_path: str, out_wav: str, sr: int = 16000) -> None:
    """mp4 -> wav (reference `audio_extractor.py` via moviepy); ffmpeg-gated."""
    if not ffmpeg_available():
        raise RuntimeError("ffmpeg required for audio extraction is not available")
    subprocess.run(
        ["ffmpeg", "-y", "-i", video_path, "-vn", "-acodec", "pcm_s16le",
         "-ar", str(sr), "-ac", "1", out_wav],
        check=True,
        capture_output=True,
    )
