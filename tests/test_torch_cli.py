"""The port's inference CLI (`stableavatar_tpu_torch/cli/inference.py`):
its flag surface, fast-path mapping and byte tokenizer equal the JAX
package's; `main(argv, device="cpu")` drives the whole path at tiny size
(`STABLEAVATAR_TINY=1`, as tests/test_cli_e2e.py does for the JAX CLI);
T5 is encoded and released as `--GPU_memory_mode` says; the unported
options raise with their ROADMAP item."""

import itertools
import os

import numpy as np
import pytest
import torch

from stableavatar_tpu.cli import inference as jcli
from stableavatar_tpu.config import T5Config, tiny_debug_configs
from stableavatar_tpu_torch.cli import inference as tcli
from stableavatar_tpu_torch.pipelines.common import encode_prompts
from stableavatar_tpu_torch.utils.media import save_wav


def _surface(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
                     a.required, type(a).__name__) for a in parser._actions}


def test_parser_surface_equals_jax():
    """Every destination with its flags, default, choices, type and action."""
    assert _surface(tcli.build_parser()) == _surface(jcli.build_parser())


@pytest.mark.parametrize("fast,mode", itertools.product(
    ["off", "rope", "qk", "linears"],
    ["model_full_load", "model_cpu_offload", "model_cpu_offload_and_qfloat8",
     "sequential_cpu_offload"]))
def test_resolve_fast_path_equals_jax(fast, mode):
    argv = ["--fast_path", fast, "--GPU_memory_mode", mode]
    assert tcli.resolve_fast_path(tcli.build_parser().parse_args(argv)) == \
        jcli.resolve_fast_path(jcli.build_parser().parse_args(argv))


@pytest.mark.parametrize("text", ["", "A person is talking", "ünïcödé " * 40])
def test_byte_tokenizer_equal(text):
    args = tcli.build_parser().parse_args([])
    for cfg in (tiny_debug_configs()[2], T5Config()):
        ids, mask = tcli.build_tokenizer(args, None, cfg)(text)
        jids, jmask = jcli.build_tokenizer(args, None, cfg)(text)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        assert ids.shape == mask.shape == (cfg.text_len,)


@pytest.fixture
def synth_inputs(tmp_path):
    from PIL import Image

    ref = str(tmp_path / "ref.png")
    img = np.random.default_rng(0).uniform(0, 255, (64, 64, 3)).astype(np.uint8)
    Image.fromarray(img).save(ref)
    wav = str(tmp_path / "voice.wav")
    t = np.arange(16000) / 16000.0  # 1 s -> 25 frames -> 7 latent frames
    save_wav(wav, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    return ref, wav


TINY = ["--width", "32", "--height", "32", "--sample_steps", "2",
        "--clip_sample_n_frames", "9", "--overlap_window_length", "1"]


@pytest.mark.parametrize("extra", [
    ["--validation_prompts", "A person is talking"],
    ["--validation_prompts", "A person is talking", "--stream_output"],
    ["--sample_solver", "unipc", "--enable_teacache", "--num_skip_start_steps", "1",
     "--sample_steps", "3", "--GPU_memory_mode", "model_cpu_offload_and_qfloat8",
     "--reference_attn_numerics"],
    ["--sample_solver", "dpm++", "--fast_path", "linears", "--GPU_memory_mode",
     "model_full_load", "--color_correction_strength", "0.5", "--t5_cpu"],
], ids=["plain", "stream", "unipc-teacache-qfloat8", "dpm-linears-fullload"])
def test_main_end_to_end_tiny(synth_inputs, tmp_path, monkeypatch, extra):
    ref, wav = synth_inputs
    outdir = str(tmp_path / "out")
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    rc = tcli.main(["--validation_reference_path", ref, "--validation_driven_audio_path", wav,
                    *TINY, *extra, "--output_dir", outdir], device="cpu")
    assert rc == 0
    produced = [os.path.join(outdir, e) for e in os.listdir(outdir)]
    # an mp4 with an ffmpeg backend, a PNG frame directory without one
    assert any(p.endswith(".mp4") or (os.path.isdir(p) and len(os.listdir(p)) == 25)
               for p in produced), produced


def test_main_refuses_missing_inputs(tmp_path):
    assert tcli.main(["--validation_reference_path", str(tmp_path / "none.png"),
                      "--validation_driven_audio_path", str(tmp_path / "none.wav")],
                     device="cpu") == 2


def _args(*argv):
    return tcli.build_parser().parse_args(["--validation_prompts", "hello", *argv])


def test_load_models_places_t5_as_the_memory_mode_says(monkeypatch):
    """Offload modes encode the prompts on the device and release T5;
    model_full_load keeps bf16 T5; --t5_cpu keeps fp32 T5 on the host.  The
    three contexts agree (same seeded weights)."""
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    freed = tcli.load_models(_args(), device="cpu")
    assert freed.t5_params is None and freed.text_ctx.shape == (3, 16, 32)
    assert freed.text_ctx.dtype == torch.bfloat16 and freed.device == torch.device("cpu")
    kept = tcli.load_models(_args("--GPU_memory_mode", "model_full_load"), device="cpu")
    assert kept.text_ctx is None
    assert kept.t5_params["blocks"][0]["attn"]["q"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(encode_prompts(kept, "hello"), freed.text_ctx, rtol=0, atol=0)
    host = tcli.load_models(_args("--t5_cpu"), device="cpu")
    assert host.text_ctx is None
    assert host.t5_params["blocks"][0]["attn"]["q"]["w"].dtype == torch.float32
    ctx = encode_prompts(host, "hello")
    assert ctx.dtype == torch.float32
    torch.testing.assert_close(ctx.bfloat16(), freed.text_ctx, rtol=2e-2, atol=2e-2)
    assert freed.attn_quant == "none" and not freed.rope_split and freed.teacache is None
    fast = tcli.load_models(_args("--fast_path", "linears", "--enable_teacache"), device="cpu")
    assert fast.attn_quant == "qk" and fast.rope_split and fast.teacache.num_steps == 50
    assert "w8" in fast.dit_params["blocks"][0]["ffn"]["fc1"]


@pytest.mark.parametrize("argv,match", [
    (["--model_family", "14B"], "open item 4: 14B"),
    (["--GPU_memory_mode", "sequential_cpu_offload"], "open item 3: streamed offload"),
    (["--ulysses_degree", "2"], "open item 5: multi-GPU"),
    (["--ring_degree", "2"], "open item 5: multi-GPU"),
    (["--num_processes", "2"], "open item 5: multi-GPU"),
], ids=["14B", "sequential", "ulysses", "ring", "processes"])
def test_unported_options_raise(argv, match):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {match}"):
        tcli.load_models(_args(*argv), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(argv, device="cpu")


@pytest.mark.parametrize("kind", ["root", "transformer", "wav2vec"])
def test_checkpoints_raise(tmp_path, kind):
    """A checkpoint file found or passed is never replaced by random weights."""
    if kind == "root":
        (tmp_path / "Wan2.1_VAE.pth").write_bytes(b"")
        argv = ["--pretrained_model_name_or_path", str(tmp_path)]
    elif kind == "transformer":
        (tmp_path / "ft.pt").write_bytes(b"")
        argv = ["--transformer_path", str(tmp_path / "ft.pt")]
    else:
        (tmp_path / "model.safetensors").write_bytes(b"")
        argv = ["--pretrained_wav2vec_path", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="open item 2: checkpoint loading"):
        tcli.load_models(_args(*argv), device="cpu")
