"""The port's copies of the JAX package's jax-free host modules
(`utils/color_correction.py`, `media.py`, `native_audio.py`, `video_io.py`)
are held equal to them: the same code below the module docstring (with the
package name as the only difference, and the definitions in DIVERGED
left out), and the same outputs on seeded inputs."""

import ast
import importlib
import inspect
import os

import numpy as np
import pytest

MODULES = ["color_correction", "media", "native_audio", "video_io"]
# definitions where the port departs from the JAX module on purpose, held
# by their outputs instead: video_io's PNG fallback goes through PIL and
# also serves a host without imageio (test_video_io_equal,
# test_video_io_png_fallback_without_imageio)
DIVERGED = {"video_io": {"_write_png", "save_videos_grid",
                         "StreamingVideoWriter._ensure_writer", "StreamingVideoWriter.append"}}


def _pair(name):
    return (importlib.import_module(f"stableavatar_tpu.utils.{name}"),
            importlib.import_module(f"stableavatar_tpu_torch.utils.{name}"))


@pytest.mark.parametrize("name", MODULES)
def test_code_is_a_copy(name):
    jmod, tmod = _pair(name)

    skip = DIVERGED.get(name, set())

    def kept(nodes, prefix=""):
        out = []
        for node in nodes:
            qual = prefix + getattr(node, "name", "")
            if qual in skip:
                continue
            if isinstance(node, ast.ClassDef):
                node.body = kept(node.body, qual + ".")
            out.append(node)
        return out

    def body(mod, rename=False):
        src = inspect.getsource(mod)
        if rename:
            src = src.replace("stableavatar_tpu_torch", "stableavatar_tpu")
        tree = ast.parse(src)
        tree.body = kept(tree.body[1:])  # the module docstring differs
        return ast.dump(tree)

    assert body(tmod, rename=True) == body(jmod)


def test_color_correction_equal():
    jcc, tcc = _pair("color_correction")
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (5, 6, 3))
    np.testing.assert_array_equal(tcc.rgb_to_lab(rgb), jcc.rgb_to_lab(rgb))
    lab = jcc.rgb_to_lab(rgb)
    np.testing.assert_array_equal(tcc.lab_to_rgb(lab), jcc.lab_to_rgb(lab))
    chunk = rng.uniform(-1, 1, (1, 3, 4, 8, 8)).astype(np.float32)
    ref = rng.uniform(-1, 1, (1, 3, 1, 8, 8)).astype(np.float32)
    for strength in (0.0, 0.4, 1.0):
        np.testing.assert_array_equal(tcc.match_and_blend_colors(chunk, ref, strength),
                                      jcc.match_and_blend_colors(chunk, ref, strength))
    with pytest.raises(ValueError):
        tcc.match_and_blend_colors(chunk, ref, 1.5)


@pytest.mark.parametrize("sr,channels,width", [(16000, 1, 2), (44100, 2, 2), (22050, 1, 4),
                                               (8000, 2, 1)])
def test_media_wav_equal(tmp_path, sr, channels, width):
    import wave

    jm, tm = _pair("media")
    rng = np.random.default_rng(sr)
    n = sr // 3
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dtype)
    raw = rng.integers(info.min // 2, info.max // 2, (n, channels)).astype(dtype)
    path = str(tmp_path / "x.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(raw.tobytes())
    (a, sa), (b, sb) = tm.load_wav(path, 16000), jm.load_wav(path, 16000)
    assert sa == sb == 16000
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.resample(a, 16000, 24000), jm.resample(a, 16000, 24000))
    tm.save_wav(str(tmp_path / "t.wav"), a)
    jm.save_wav(str(tmp_path / "j.wav"), a)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_media_image_and_ffmpeg_equal(tmp_path):
    from PIL import Image

    jm, tm = _pair("media")
    path = str(tmp_path / "ref.png")
    Image.fromarray(np.random.default_rng(1).integers(0, 255, (40, 30, 3), np.uint8)).save(path)
    for size in (None, (16, 24)):
        np.testing.assert_array_equal(tm.load_image(path, size), jm.load_image(path, size))
    assert tm.ffmpeg_available() == jm.ffmpeg_available()
    if not tm.ffmpeg_available():
        for mod in (tm, jm):
            with pytest.raises(RuntimeError, match="ffmpeg"):
                mod.mux_audio("a.mp4", "a.wav", "b.mp4")


def test_native_audio_equal():
    jn, tn = _pair("native_audio")
    assert os.path.dirname(tn.__file__) != os.path.dirname(jn.__file__)
    assert tn._native_dir() == jn._native_dir()
    raw = np.random.default_rng(2).integers(-3000, 3000, 4000, np.int16).tobytes()
    a, b = tn.decode_pcm(raw, 2, 2), jn.decode_pcm(raw, 2, 2)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tn.resample(a, 16000, 22050), jn.resample(a, 16000, 22050))
        x, y = a.copy(), a.copy()
        assert tn.normalize_inplace(x) == jn.normalize_inplace(y)
        np.testing.assert_array_equal(x, y)


def _frames(out):
    """The frames a writer left: a PNG directory's images, or an mp4's size."""
    import imageio.v2 as imageio

    if os.path.isdir(out):
        return [imageio.imread(os.path.join(out, f)) for f in sorted(os.listdir(out))]
    return os.path.getsize(out)


def test_video_io_equal(tmp_path):
    jv, tv = _pair("video_io")
    video = np.random.default_rng(3).uniform(0, 1, (2, 3, 4, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tv.to_uint8(video), jv.to_uint8(video))
    outs = [mod.save_videos_grid(video, str(tmp_path / f"{tag}.mp4"), fps=5)
            for tag, mod in (("t", tv), ("j", jv))]
    a, b = (_frames(o) for o in outs)
    if isinstance(a, list):
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    segs = [(video[:1, :, :2] * 255).round().astype(np.uint8), video[:1, :, 2:]]
    outs = []
    for tag, mod in (("ts", tv), ("js", jv)):
        w = mod.StreamingVideoWriter(str(tmp_path / f"{tag}.mp4"), fps=5)
        for seg in segs:
            w.append(seg)
        assert w.frames_written == 4
        outs.append(w.close())
    a, b = (_frames(o) for o in outs)
    if isinstance(a, list):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("imageio_present", [True, False])
def test_video_io_png_fallback_without_imageio(tmp_path, monkeypatch, imageio_present):
    """Without an ffmpeg backend, with or without imageio (a machine with
    neither), `save_videos_grid` and `StreamingVideoWriter` write through
    PIL the PNG frame directory whose frames the JAX package's writers put
    there."""
    import sys

    from stableavatar_tpu.utils import video_io as jv
    from stableavatar_tpu_torch.utils import media as tmedia
    from stableavatar_tpu_torch.utils import video_io as tv

    video = np.random.default_rng(4).uniform(0, 1, (2, 3, 4, 8, 8)).astype(np.float32)
    want = _frames(jv.save_videos_grid(video, str(tmp_path / "jax.mp4"), fps=5))
    monkeypatch.setattr(tmedia.shutil, "which", lambda name: None)  # no ffmpeg
    if not imageio_present:
        monkeypatch.setitem(sys.modules, "imageio", None)  # import raises
    whole = tv.save_videos_grid(video, str(tmp_path / "whole.mp4"), fps=5)
    writer = tv.StreamingVideoWriter(str(tmp_path / "streamed.mp4"), fps=5)
    writer.append((video[:, :, :1] * 255).round().astype(np.uint8))
    writer.append(video[:, :, 1:])
    assert writer.frames_written == 4
    streamed = writer.close()
    if not imageio_present:
        assert whole == str(tmp_path / "whole") and streamed == str(tmp_path / "streamed")
    monkeypatch.delitem(sys.modules, "imageio")
    for out in (whole, streamed):
        if isinstance(want, list):
            got = _frames(out)
            assert os.path.isdir(out) and len(got) == len(want) == 4
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    """`device_trace(logdir)` exports a Chrome trace of the enclosed work
    (its CPU ops here); without logdir it does nothing."""
    import json

    import torch

    from stableavatar_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path / "trace")) as prof:
        torch.nn.functional.conv2d(torch.ones(1, 2, 8, 8), torch.ones(3, 2, 3, 3))
    assert prof is not None
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith("trace_") and name.endswith(".json")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    for logdir in (None, ""):
        with device_trace(logdir) as prof:
            torch.ones(2).sum()
        assert prof is None
    assert sorted(os.listdir(tmp_path)) == ["trace"]
