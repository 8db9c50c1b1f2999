"""The port's preprocessing tools (`stableavatar_tpu_torch/preprocess/`)
against the JAX package's: MDX separation through the torch ONNX runner at
rel 1e-5, the HPSS and band-pass filters and `lip_geometry_mask` bit for
bit, the tiers of `separate` with the loud fallback warning, the audio
extractor's ffmpeg gate and the CLIs' mains on the CPU."""

import os
import warnings

import numpy as np
import pytest

from stableavatar_tpu.preprocess import lip_mask_extractor as jlip
from stableavatar_tpu.preprocess import vocal_separator as jsep
from stableavatar_tpu.utils import onnx_runner as jrunner
from stableavatar_tpu_torch.preprocess import audio_extractor as textract
from stableavatar_tpu_torch.preprocess import lip_mask_extractor as tlip
from stableavatar_tpu_torch.preprocess import vocal_separator as tsep
from stableavatar_tpu_torch.utils import onnx_runner as trunner
from stableavatar_tpu_torch.utils.media import load_wav, save_wav
from tests import torch_onnx_graphs as graphs
from tests.test_vocal_separation import _snr, _synthetic_mix


def _mdx_bytes():
    """A small graph of MDX-Net's topology at Kim_Vocal_2's input geometry
    ([1, 4, dim_f 3072, dim_t 256]; 2 channels, TDF hidden 48)."""
    data, _ = graphs.mdx_graph(c=4, g=2, f=tsep.MDX_DIM_F, t=tsep.MDX_DIM_T, crop=0,
                               tdf_div=64, seed=6, scale=0.3)
    return data


def _stereo(seconds):
    rng = np.random.default_rng(8)
    t = np.arange(int(tsep.MDX_SR * seconds)) / tsep.MDX_SR
    voice = 0.2 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t))
    return np.stack([voice + 0.05 * rng.standard_normal(t.size),
                     0.8 * voice + 0.05 * rng.standard_normal(t.size)]).astype(np.float32)


def test_mdx_constants_equal_jax():
    for name in ("MDX_N_FFT", "MDX_HOP", "MDX_DIM_F", "MDX_DIM_T", "MDX_SR"):
        assert getattr(tsep, name) == getattr(jsep, name)
    assert (tsep.MDX_N_FFT, tsep.MDX_HOP, tsep.MDX_DIM_F, tsep.MDX_DIM_T, tsep.MDX_SR) == \
        (7680, 1024, 3072, 256, 44100)


def test_mdx_separate_waveform_matches_jax(monkeypatch):
    """Two overlapped chunks (6 s of 44.1 kHz stereo) through the STFT
    recipe and the graph: the port's runner on the CPU against the JAX
    runner at rel 1e-5.  The graph's weights go to the device once, not
    once a chunk."""
    data, stereo = _mdx_bytes(), _stereo(6.0)
    want = jsep.mdx_separate_waveform(stereo, jrunner.parse_onnx(data))
    calls = {"graph_weights": [], "run_graph": []}
    for name, fn in ((n, getattr(trunner, n)) for n in list(calls)):
        monkeypatch.setattr(trunner, name,
                            lambda *a, _n=name, _f=fn, **k: calls[_n].append(a) or _f(*a, **k))
    got = tsep.mdx_separate_waveform(stereo, trunner.parse_onnx(data), device="cpu")
    assert len(calls["graph_weights"]) == 1 and len(calls["run_graph"]) == 2
    assert all(a[3] is not None for a in calls["run_graph"])
    assert got.shape == want.shape == stereo.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_stft_helpers_equal_jax():
    x = _stereo(0.5)
    window = np.hanning(tsep.MDX_N_FFT + 1)[:-1]
    z = tsep._torch_stft(x, tsep.MDX_N_FFT, tsep.MDX_HOP, window)
    np.testing.assert_array_equal(z, jsep._torch_stft(x, tsep.MDX_N_FFT, tsep.MDX_HOP, window))
    np.testing.assert_array_equal(
        tsep._torch_istft(z, tsep.MDX_N_FFT, tsep.MDX_HOP, window, x.shape[-1]),
        jsep._torch_istft(z, tsep.MDX_N_FFT, tsep.MDX_HOP, window, x.shape[-1]))


def test_hpss_and_bandpass_equal_jax_bit_for_bit():
    vocal, perc = _synthetic_mix()
    mix = vocal + perc
    np.testing.assert_array_equal(tsep.hpss_vocal_filter(mix), jsep.hpss_vocal_filter(mix))
    np.testing.assert_array_equal(tsep.bandpass_vocal_filter(mix),
                                  jsep.bandpass_vocal_filter(mix))


def test_hpss_beats_bandpass_baseline():
    """As tests/test_vocal_separation.py:43, on the port's filters."""
    vocal, perc = _synthetic_mix()
    mix = vocal + perc
    snr_mix = _snr(mix, vocal)
    snr_band = _snr(tsep.bandpass_vocal_filter(mix), vocal)
    snr_hpss = _snr(tsep.hpss_vocal_filter(mix), vocal)
    assert snr_hpss > snr_mix + 3.0, (snr_hpss, snr_mix)
    assert snr_hpss > snr_band + 2.0, (snr_hpss, snr_band)


@pytest.fixture
def no_mdx(monkeypatch, tmp_path):
    """No Kim_Vocal_2.onnx anywhere `_find_model` looks."""
    monkeypatch.delenv("STABLEAVATAR_MDX_DIR", raising=False)
    monkeypatch.chdir(tmp_path)


def test_hpss_fallback_warns_loudly(tmp_path, capsys, no_mdx):
    wav = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32)
    src = str(tmp_path / "in.wav")
    save_wav(src, wav, 16000)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = tsep.separate(src, str(tmp_path / "out.wav"), device="cpu")
    assert out == str(tmp_path / "out.wav") and os.path.exists(out)
    assert "VOCAL SEPARATION QUALITY WARNING" in capsys.readouterr().err
    assert any("HPSS" in str(r.message) for r in rec)
    got, sr = load_wav(out, 16000)
    want = jsep.hpss_vocal_filter(load_wav(src, 16000)[0], 16000)
    assert sr == 16000 and got.shape == want.shape


def test_separate_takes_the_native_tier_with_the_model(tmp_path, no_mdx):
    """With Kim_Vocal_2.onnx in model_dir, `separate` runs the graph (no
    warning) and writes the JAX package's 16 kHz vocals."""
    model_dir = tmp_path / "mdx"
    model_dir.mkdir()
    (model_dir / "Kim_Vocal_2.onnx").write_bytes(_mdx_bytes())
    src = str(tmp_path / "in.wav")
    save_wav(src, _stereo(2.0)[0] * 0.5, 44100)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tsep.separate(src, str(tmp_path / "port.wav"), model_dir=str(model_dir),
                            device="cpu")
    want_path = jsep.separate(src, str(tmp_path / "jax.wav"), model_dir=str(model_dir))
    got, want = load_wav(out, 16000)[0], load_wav(want_path, 16000)[0]
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    # the int16 wav may round a sample the other way
    assert np.abs(got - want).max() <= 1.5 / 32767


def test_vocal_separator_main_on_the_cpu(tmp_path, no_mdx):
    src = str(tmp_path / "in.wav")
    save_wav(src, (np.random.default_rng(1).standard_normal(16000) * 0.1).astype(np.float32),
             16000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tsep.main(["--audio_file_path", src, "--saved_vocal_path",
                   str(tmp_path / "v.wav")], device="cpu")
    assert os.path.exists(tmp_path / "v.wav")


def test_audio_extractor_is_gated_without_ffmpeg(tmp_path, monkeypatch):
    """Without ffmpeg the extractor fails loudly (no silent empty wav), as
    the JAX one does."""
    from stableavatar_tpu_torch.utils import media

    monkeypatch.setattr(media.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        textract.extract("nonexistent.mp4", str(tmp_path / "o.wav"))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        textract.main(["--video_path", "nonexistent.mp4", "--saved_audio_path",
                       str(tmp_path / "o.wav")])
    assert not (tmp_path / "o.wav").exists()


def _face(h=128, w=128):
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :] = (140, 160, 200)  # BGR skin
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy, a = 64.0, 90.0, 18.0
    lips = ((yy <= cy) & (((xx - cx) / a) ** 2 + ((yy - cy) / 4.0) ** 2 <= 1)) | (
        (yy > cy) & (((xx - cx) / a) ** 2 + ((yy - cy) / 6.0) ** 2 <= 1))
    img[lips] = (90, 90, 210)
    return img


@pytest.mark.parametrize("case", ["lips", "noisy", "gray", "edge", "empty"])
def test_lip_geometry_mask_equals_jax_bit_for_bit(case):
    rng = np.random.default_rng(2)
    img, box = _face(), (44, 82, 84, 100)
    if case == "noisy":
        img = np.clip(img.astype(np.int16) + rng.integers(-30, 30, img.shape), 0, 255
                      ).astype(np.uint8)
    elif case == "gray":
        img = np.repeat(img.mean(axis=2, keepdims=True).astype(np.uint8), 3, axis=2)
    elif case == "edge":
        box = (-10, 100, 40, 140)
    elif case == "empty":
        box = (50, 50, 50, 60)
    got, want = tlip.lip_geometry_mask(img, box), jlip.lip_geometry_mask(img, box)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if case == "lips":
        assert (got > 0).any()


def test_lip_mask_extractor_equals_jax(tmp_path):
    """The extractor over a frames directory writes the JAX package's masks:
    with a stubbed mouth detector (tests/test_data_cli.py:385), and on this
    host's cv2 as it is (mediapipe absent; a headless cv2 without objdetect
    warns and writes empty masks)."""
    cv2 = pytest.importorskip("cv2")
    frames = tmp_path / "frames"
    frames.mkdir()
    img = np.full((64, 64, 3), (140, 160, 200), np.uint8)
    img[44:52, 24:40] = (90, 90, 210)
    for i in range(2):
        cv2.imwrite(str(frames / f"f{i}.png"), img)

    def run(mod, out, stub):
        orig = mod._detect_mouth_box
        if stub:
            mod._detect_mouth_box = lambda im, fc, mc: (22, 42, 42, 54)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                n = mod.extract_lip_masks(str(frames), str(out))
        finally:
            mod._detect_mouth_box = orig
        return n, [cv2.imread(str(out / f"f{i}.png"), cv2.IMREAD_GRAYSCALE) for i in range(2)]

    for stub in (True, False):
        n, got = run(tlip, tmp_path / f"port{stub}", stub)
        jn, want = run(jlip, tmp_path / f"jax{stub}", stub)
        assert n == jn == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if stub:
            assert (got[0] > 0).any() and not (got[0][:40] > 0).any()
    if not hasattr(cv2, "CascadeClassifier"):
        with pytest.warns(UserWarning, match="lacks CascadeClassifier"):
            tlip.extract_lip_masks(str(frames), str(tmp_path / "warn"))
    tlip.main(["--frames_dir", str(frames), "--out_dir", str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == ["f0.png", "f1.png"]
