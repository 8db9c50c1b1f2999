"""mp4 -> 16 kHz mono WAV (reference `audio_extractor.py`, moviepy-based),
port of `stableavatar_tpu/preprocess/audio_extractor.py`.

Host-side ffmpeg; gated with a clear error when ffmpeg is absent.
Run: python -m stableavatar_tpu_torch.preprocess.audio_extractor
--video_path in.mp4 --saved_audio_path out.wav
"""

from __future__ import annotations

import argparse

from stableavatar_tpu_torch.utils.media import extract_audio


def extract(video_path: str, out_wav: str, sr: int = 16000) -> str:
    extract_audio(video_path, out_wav, sr)
    return out_wav


def main(argv=None):
    p = argparse.ArgumentParser("audio_extractor")
    p.add_argument("--video_path", required=True)
    p.add_argument("--saved_audio_path", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    a = p.parse_args(argv)
    extract(a.video_path, a.saved_audio_path, a.sample_rate)


if __name__ == "__main__":
    main()
