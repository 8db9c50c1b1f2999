"""Vocal separation (reference `vocal_seperator.py`: MDX-Net Kim_Vocal_2 via
the `audio-separator` ONNX package), port of
`stableavatar_tpu/preprocess/vocal_separator.py`.

Three tiers, the first available wins:

1. the `audio-separator` package when installed (the reference's path);
2. **native MDX-Net**: when Kim_Vocal_2.onnx is present, the graph runs
   through the port's ONNX runner (`utils/onnx_runner.py`) on the card,
   with the standard UVR / MDX STFT recipe (n_fft 7680, hop 1024, dim_f
   3072, 256-frame segments) on the host;
3. **DSP fallback** with a loud warning: harmonic / percussive separation
   (median-filter Wiener masking) + a vocal band-pass, measurably better
   than a plain band-pass (tests/test_torch_preprocess.py asserts the SNR
   gain) though far below MDX-Net.

The STFT / iSTFT and the DSP filters are numpy / scipy on the host, as in
the JAX package.  Run: python -m stableavatar_tpu_torch.preprocess.vocal_separator
--audio_file_path in.wav --saved_vocal_path vocals.wav
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

import numpy as np

from stableavatar_tpu_torch.utils.media import load_wav, resample, save_wav

# Kim_Vocal_2 MDX parameters (UVR model registry)
MDX_N_FFT = 7680
MDX_HOP = 1024
MDX_DIM_F = 3072
MDX_DIM_T = 256
MDX_SR = 44100


def separate(audio_path: str, out_path: str, model_dir: str | None = None,
             device="cuda") -> str:
    """The vocals of `audio_path` written to `out_path` (16 kHz mono) by
    the best available tier; returns the path written.  `device` is where
    the native MDX graph runs (the card unless the caller asks for the CPU)."""
    # the reference's package first (`vocal_seperator.py:20-26`): until the
    # native runner's output is validated against it on the real Kim_Vocal_2
    # weights, audio-separator (when installed) is the trusted path
    try:
        from audio_separator.separator import Separator  # optional dep

        sep = Separator(output_dir=".", model_file_dir=model_dir or ".")
        sep.load_model(model_filename="Kim_Vocal_2.onnx")
        outs = sep.separate(audio_path)
        vocal = [o for o in outs if "Vocal" in o]
        return vocal[0] if vocal else outs[0]
    except ImportError:
        pass
    onnx_path = _find_model(model_dir)
    if onnx_path is not None:
        return separate_mdx_native(audio_path, out_path, onnx_path, device=device)
    # loud on purpose: the DSP fallback is far below MDX-Net quality — users
    # on this path get audibly different conditioning than the reference,
    # which changes generated lip motion
    msg = (
        "VOCAL SEPARATION QUALITY WARNING: no Kim_Vocal_2.onnx found and "
        "audio-separator not installed; falling back to HPSS DSP "
        "separation, which is far below MDX-Net quality (audibly different "
        "conditioning vs the reference -> different lip motion). Mount the "
        "MDX model (model_dir or STABLEAVATAR_MDX_DIR) for "
        "reference-quality separation."
    )
    print(f"[stableavatar] {msg}", file=sys.stderr, flush=True)
    warnings.warn(msg)
    return _fallback_vocal_filter(audio_path, out_path)


def _find_model(model_dir):
    dirs = [model_dir, os.environ.get("STABLEAVATAR_MDX_DIR"), "."]
    for d in filter(None, dirs):
        p = os.path.join(d, "Kim_Vocal_2.onnx")
        if os.path.exists(p):
            return p
    return None


# ---------------------------------------------------------------------------
# native MDX-Net inference (our ONNX runner)
# ---------------------------------------------------------------------------


def separate_mdx_native(
    audio_path: str, out_path: str, onnx_path: str, sr_out: int = 16000, device="cuda"
) -> str:
    """Run the MDX-Net vocals model through utils/onnx_runner.py on `device`.

    Standard UVR recipe: 44.1 kHz stereo STFT (n_fft 7680, hop 1024), the
    lowest `dim_f` frequency bins as a [1, 4, dim_f, 256] re/im tensor per
    256-frame segment, model output ISTFT'd back to the vocals stem."""
    from stableavatar_tpu_torch.utils.onnx_runner import load_onnx

    graph = load_onnx(onnx_path)
    wav, _ = load_wav(audio_path, MDX_SR)
    stereo = np.stack([wav, wav]) if wav.ndim == 1 else wav  # [2, S]

    vocals = mdx_separate_waveform(stereo, graph, device=device)
    mono = vocals.mean(axis=0)
    # back to the pipeline rate
    mono16 = resample(mono, MDX_SR, sr_out)
    save_wav(out_path, mono16.astype(np.float32), sr_out)
    return out_path


def _torch_stft(x: np.ndarray, n_fft: int, hop: int, window: np.ndarray) -> np.ndarray:
    """torch.stft(center=True, pad_mode='reflect', normalized=False) in numpy.

    scipy.signal.stft normalizes by the window sum (its magnitudes are ~3800x
    smaller at n_fft 7680), which is NOT what MDX-Net was trained on — this
    matches the torch recipe UVR uses bit-for-bit.  x: [C, S] -> [C, F, T].
    """
    pad = n_fft // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft, axis=-1)[:, ::hop][
        :, :n_frames
    ]
    return np.fft.rfft(frames * window, axis=-1).transpose(0, 2, 1)


def _torch_istft(
    Z: np.ndarray, n_fft: int, hop: int, window: np.ndarray, length: int
) -> np.ndarray:
    """torch.istft(center=True) inverse: windowed overlap-add normalized by
    the summed squared window.  Z: [C, F, T] -> [C, length]."""
    frames = np.fft.irfft(Z.transpose(0, 2, 1), n=n_fft, axis=-1) * window
    c, t, _ = frames.shape
    total = n_fft + hop * (t - 1)
    out = np.zeros((c, total))
    wsum = np.zeros(total)
    for i in range(t):
        out[:, i * hop : i * hop + n_fft] += frames[:, i]
        wsum[i * hop : i * hop + n_fft] += window * window
    out = out / np.maximum(wsum, 1e-10)
    pad = n_fft // 2
    return out[:, pad : pad + length]


def _spec_to_model_input(Z: np.ndarray) -> np.ndarray:
    """[2, dim_f, T] complex -> [1, 4, dim_f, T] float packed
    [ch0_re, ch0_im, ch1_re, ch1_im] (torch view_as_real + permute layout
    used by every Conv-TDF MDX export)."""
    reim = np.stack([Z.real, Z.imag], axis=1)  # [2, 2, F, T]
    return reim.reshape(1, 4, Z.shape[1], Z.shape[2]).astype(np.float32)


def _model_output_to_spec(y: np.ndarray) -> np.ndarray:
    """[1 or 4-first, 4, dim_f, T] -> [2, dim_f, T] complex."""
    y = y.reshape(2, 2, y.shape[-2], y.shape[-1])
    return y[:, 0] + 1j * y[:, 1]


def mdx_separate_waveform(stereo: np.ndarray, graph, device="cuda") -> np.ndarray:
    """[2, S] 44.1 kHz waveform -> [2, S] vocals via overlapped chunked MDX.

    UVR demixing recipe: waveform chunks of hop*(dim_t-1) samples processed
    with trim = n_fft//2 margins on both sides; only the center
    gen_size = chunk - 2*trim samples of each chunk's output are kept, so
    consecutive chunks overlap by 2*trim and no window boundary artifacts
    land in the stem.  The graph runs on `device`, its weights copied
    there once; the STFT, the packing and the iSTFT on the host."""
    from stableavatar_tpu_torch.utils.onnx_runner import graph_weights, run_graph

    window = np.hanning(MDX_N_FFT + 1)[:-1]  # periodic hann, torch default
    chunk = MDX_HOP * (MDX_DIM_T - 1)
    trim = MDX_N_FFT // 2
    gen = chunk - 2 * trim
    n_samples = stereo.shape[-1]
    n_chunks = max(1, -(-n_samples // gen))
    padded = np.pad(stereo, ((0, 0), (trim, trim + n_chunks * gen - n_samples)))

    out = np.zeros((2, n_chunks * gen), dtype=np.float32)
    weights = graph_weights(graph, device)
    for k in range(n_chunks):
        seg = padded[:, k * gen : k * gen + chunk]
        if seg.shape[-1] < chunk:
            seg = np.pad(seg, ((0, 0), (0, chunk - seg.shape[-1])))
        Z = _torch_stft(seg, MDX_N_FFT, MDX_HOP, window)[:, :MDX_DIM_F]
        x = _spec_to_model_input(Z)
        y = run_graph(graph, {graph.inputs[0]: x}, device, weights)
        y = next(iter(y.values())).cpu().numpy()
        spec = _model_output_to_spec(y)
        Zv = np.zeros((2, MDX_N_FFT // 2 + 1, Z.shape[-1]), dtype=np.complex128)
        Zv[:, :MDX_DIM_F] = spec
        wav = _torch_istft(Zv, MDX_N_FFT, MDX_HOP, window, chunk)
        out[:, k * gen : (k + 1) * gen] = wav[:, trim : trim + gen]
    return out[:, :n_samples].astype(np.float32)


# ---------------------------------------------------------------------------
# DSP fallback
# ---------------------------------------------------------------------------


def _fallback_vocal_filter(audio_path: str, out_path: str, sr: int = 16000) -> str:
    wav, _ = load_wav(audio_path, sr)
    clean = hpss_vocal_filter(wav, sr)
    save_wav(out_path, clean, sr)
    return out_path


def hpss_vocal_filter(wav: np.ndarray, sr: int = 16000) -> np.ndarray:
    """Harmonic/percussive separation + zero-phase vocal band-pass.

    Median filtering along time enhances sustained (harmonic/vocal) energy,
    along frequency enhances transients (drums); a Wiener soft mask keeps
    the harmonic part (Fitzgerald 2010).  The band-pass is zero-phase
    (`sosfiltfilt`): a causal `sosfilt` adds a frequency-dependent delay that
    decorrelates the output from the clean vocal; there is no spectral
    noise-floor subtraction either (it clips quiet vocal passages)."""
    from scipy.ndimage import median_filter
    from scipy.signal import butter, istft, sosfiltfilt, stft

    f, t, z = stft(wav, fs=sr, nperseg=1024)
    mag = np.abs(z)
    harm = median_filter(mag, size=(1, 17))
    perc = median_filter(mag, size=(17, 1))
    mask = (harm**2) / (harm**2 + perc**2 + 1e-10)
    z_h = z * mask
    _, voc = istft(z_h, fs=sr, nperseg=1024)
    voc = voc[: len(wav)].astype(np.float32)

    sos = butter(4, [80, min(5000, sr // 2 - 1)], btype="bandpass", fs=sr, output="sos")
    return sosfiltfilt(sos, voc).astype(np.float32)


def bandpass_vocal_filter(wav: np.ndarray, sr: int = 16000) -> np.ndarray:
    """The plain band-pass fallback, kept as the SNR comparison baseline."""
    from scipy.signal import butter, istft, sosfilt, stft

    sos = butter(4, [80, 5000], btype="bandpass", fs=sr, output="sos")
    band = sosfilt(sos, wav).astype(np.float32)
    f, t, z = stft(band, fs=sr, nperseg=1024)
    mag = np.abs(z)
    noise_floor = np.quantile(mag, 0.1, axis=1, keepdims=True)
    mag_clean = np.maximum(mag - noise_floor, 0.0)
    z_clean = mag_clean * np.exp(1j * np.angle(z))
    _, clean = istft(z_clean, fs=sr, nperseg=1024)
    return clean[: len(wav)].astype(np.float32)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("vocal_separator")
    p.add_argument("--audio_separator_model_file", default=None)
    p.add_argument("--audio_file_path", required=True)
    p.add_argument("--saved_vocal_path", required=True)
    args = p.parse_args(argv)
    out = separate(
        args.audio_file_path, args.saved_vocal_path,
        model_dir=os.path.dirname(args.audio_separator_model_file)
        if args.audio_separator_model_file else None,
        device=device,
    )
    print(f"vocals written to {out}")


if __name__ == "__main__":
    main()
