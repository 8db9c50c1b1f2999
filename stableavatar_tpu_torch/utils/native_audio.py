"""ctypes bindings of the native audio IO library (`native/audioio.cpp`),
copy of `stableavatar_tpu/utils/native_audio.py` (held equal by
tests/test_torch_utils.py).

Loads the repository's `native/libaudioio.so`, building it with g++ on first
use when it is missing; where that fails every function returns None (or
False) and `utils/media.py` takes its numpy path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_native_dir(), "libaudioio.so")
    if not os.path.exists(so):
        src = os.path.join(_native_dir(), "audioio.cpp")
        if not os.path.exists(src):
            return None
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", "-o", so, src],
                check=True, capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.audioio_decode_pcm.restype = ctypes.c_int64
    lib.audioio_decode_pcm.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.audioio_resampled_length.restype = ctypes.c_int64
    lib.audioio_resampled_length.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.audioio_resample.restype = ctypes.c_int64
    lib.audioio_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.audioio_normalize.restype = None
    lib.audioio_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
    ]
    _LIB = lib
    return lib


def decode_pcm(raw: bytes, sample_width: int, channels: int, is_float: bool = False) -> Optional[np.ndarray]:
    lib = load_library()
    if lib is None:
        return None
    fmt = {1: 1, 2: 2, 3: 3, 4: 5 if is_float else 4}.get(sample_width)
    if fmt is None:
        return None
    frames = len(raw) // (sample_width * channels)
    out = np.empty(frames, np.float32)
    n = lib.audioio_decode_pcm(
        raw, len(raw), fmt, channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n < 0:
        return None
    return out[:n]


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> Optional[np.ndarray]:
    lib = load_library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out_len = lib.audioio_resampled_length(len(x), sr_in, sr_out)
    out = np.empty(out_len, np.float32)
    n = lib.audioio_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr_in, sr_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n < 0:
        return None
    return out[:n]


def normalize_inplace(x: np.ndarray, eps: float = 1e-7) -> bool:
    lib = load_library()
    if lib is None:
        return False
    assert x.dtype == np.float32 and x.flags.c_contiguous
    lib.audioio_normalize(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), eps)
    return True
