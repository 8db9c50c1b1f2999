"""The port's inference CLI (`stableavatar_tpu_torch/cli/inference.py`):
its flag surface, fast-path mapping and byte tokenizer equal the JAX
package's; `main(argv, device="cpu")` drives the whole path at tiny size
(`STABLEAVATAR_TINY=1`, as tests/test_cli_e2e.py does for the JAX CLI);
T5 is encoded and released as `--GPU_memory_mode` says; a tiny checkpoint
root loads as the JAX CLI loads it; 14B and sequential offload run."""

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


@pytest.mark.parametrize("argv,exc,match", [
    (["--ulysses_degree", "2"], ValueError, "= 2 needs 2 processes"),
    (["--ring_degree", "2"], ValueError, "= 2 needs 2 processes"),
    (["--coordinator_address", "localhost:29400"], ValueError, "number of processes"),
], ids=["ulysses", "ring", "processes"])
def test_unported_options_raise(synth_inputs, argv, exc, match):
    """Every option of the JAX CLI is ported (checkpoints, 14B and
    sequential offload below); sequence parallelism runs in several
    processes (tests/test_torch_parallel.py): in one process its degrees,
    and a coordinator without a process count, raise before any model
    loads."""
    ref, wav = synth_inputs
    with pytest.raises(exc, match=match):
        tcli.main(["--validation_reference_path", ref, "--validation_driven_audio_path", wav,
                   *argv], device="cpu")


# ---------------------------------------------------------------------------
# checkpoints: a tiny root of the JAX CLI's files, loaded by both CLIs
# ---------------------------------------------------------------------------


def write_checkpoint_root(root):
    """The JAX CLI's checkpoint files for the tiny debug models, every leaf
    drawn at random (umT5 in bf16, CLIP in fp16, the rest fp32), a
    fine-tuned DiT override with one size-mismatched tensor, and an HF
    wav2vec2 directory (the "wav2vec2." prefix of a CTC checkpoint, no
    normalisation).  Returns (root, override path, wav2vec2 directory)."""
    import jax

    from safetensors.numpy import save_file

    from stableavatar_tpu.models.clip import init_clip_visual
    from stableavatar_tpu.models.dit import init_dit
    from stableavatar_tpu.models.t5 import init_t5
    from stableavatar_tpu.models.vae import init_vae
    from stableavatar_tpu.utils import checkpoint as jck
    from stableavatar_tpu_torch.utils.checkpoint import save_safetensors
    from tests.test_torch_checkpoint import hf_wav2vec2_state_dict
    from tests.torch_parity import (clip_state_dict, jit_init, randomize_tree, t5_state_dict,
                                    vae_state_dict)

    dit_cfg, vae_cfg, t5_cfg, clip_cfg, _ = tiny_debug_configs()

    def draw(init, cfg, seed):
        return randomize_tree(jit_init(init, cfg, jax.random.PRNGKey(seed)), seed)

    def pth(sd, name, dtype):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in sd.items()},
                   os.path.join(root, name))

    os.makedirs(root, exist_ok=True)
    pth(t5_state_dict(draw(init_t5, t5_cfg, 1), t5_cfg), tcli.T5_FILE, torch.bfloat16)
    save_file(jck.export_dit_to_torch_state_dict(draw(init_dit, dit_cfg, 2), dit_cfg),
              os.path.join(root, tcli.DIT_FILE))
    pth(vae_state_dict(draw(init_vae, vae_cfg, 3), vae_cfg), tcli.VAE_FILE, torch.float32)
    pth(clip_state_dict(draw(init_clip_visual, clip_cfg, 4), clip_cfg), tcli.CLIP_FILE,
        torch.float16)
    override = jck.export_dit_to_torch_state_dict(draw(init_dit, dit_cfg, 5), dit_cfg)
    override["head.head.weight"] = np.zeros((3, 3), np.float32)
    transformer = os.path.join(root, "transformer3d-square.pt")
    pth(override, "transformer3d-square.pt", torch.float32)
    w2v = os.path.join(root, "wav2vec2-base-960h")
    os.makedirs(w2v)
    save_safetensors({f"wav2vec2.{k}": v for k, v in hf_wav2vec2_state_dict(6).items()},
                     os.path.join(w2v, "model.safetensors"))
    with open(os.path.join(w2v, "preprocessor_config.json"), "w") as f:
        f.write('{"do_normalize": false, "sampling_rate": 16000}')
    return root, transformer, w2v


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root, transformer, w2v = write_checkpoint_root(str(tmp_path_factory.mktemp("ckpt")))
    return ["--pretrained_model_name_or_path", root, "--transformer_path", transformer,
            "--pretrained_wav2vec_path", w2v]


def test_load_models_from_checkpoints_matches_jax(checkpoints, monkeypatch):
    """The port's load_models reads the JAX CLI's files in the JAX CLI's
    order and gives, bit for bit, the bridge of the JAX load_models' trees:
    umT5, the DiT with its override merged (the mismatched tensor skipped),
    the VAE, CLIP (each cast to bf16) and wav2vec2 (fp32, its preprocessor's
    normalisation)."""
    from stableavatar_tpu_torch.utils.weights import dit_from_jax, from_jax_tree, t5_from_jax
    from tests.torch_parity import assert_trees_equal, to_numpy_tree

    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    argv = [*checkpoints, "--GPU_memory_mode", "model_full_load", "--validation_prompts", "hi"]
    got = tcli.load_models(tcli.build_parser().parse_args(argv), device="cpu")
    want = jcli.load_models(jcli.build_parser().parse_args(argv))
    assert_trees_equal(got.dit_params, dit_from_jax(to_numpy_tree(want.dit_params)))
    assert_trees_equal(got.t5_params, t5_from_jax(to_numpy_tree(want.t5_params)))
    for name in ("vae_params", "clip_params", "wav2vec_params"):
        assert_trees_equal(getattr(got, name), from_jax_tree(to_numpy_tree(getattr(want, name))))
    import dataclasses

    assert dataclasses.asdict(got.wav2vec_cfg) == dataclasses.asdict(want.wav2vec_cfg)
    assert not got.wav2vec_cfg.do_normalize
    assert got.dit_params["blocks"][0]["ffn"]["fc1"]["w"].dtype == torch.bfloat16
    assert got.wav2vec_params["blocks"][0]["ffn"]["fc1"]["w"].dtype == torch.float32


def test_load_models_fills_a_base_without_vocal_keys_from_the_override(checkpoints, tmp_path,
                                                                        monkeypatch):
    """A base DiT file without the StableAvatar parts (the vocal projector,
    each block's vocal k / v) loads under --transformer_path: those keys
    come from the fine-tuned file, so the tree equals the one loaded from a
    complete base; without an override such a base raises."""
    import shutil

    from tests.torch_parity import assert_trees_equal
    from stableavatar_tpu_torch.utils import checkpoint as tck

    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    root = checkpoints[1]
    cut = tmp_path / "base_without_vocal"
    shutil.copytree(root, cut)
    sd = tck.load_torch_state_dict(os.path.join(root, tcli.DIT_FILE))
    tck.save_safetensors({k: v for k, v in sd.items()
                          if not (k.startswith("vocal_projector.") or "_vocal." in k)},
                         str(cut / tcli.DIT_FILE))
    argv = checkpoints[2:] + ["--GPU_memory_mode", "model_full_load"]
    want = tcli.load_models(tcli.build_parser().parse_args(argv + [
        "--pretrained_model_name_or_path", root]), device="cpu")
    got = tcli.load_models(tcli.build_parser().parse_args(argv + [
        "--pretrained_model_name_or_path", str(cut)]), device="cpu")
    assert_trees_equal(got.dit_params, want.dit_params)
    with pytest.raises(KeyError, match="vocal"):
        tcli.load_models(tcli.build_parser().parse_args(
            ["--pretrained_model_name_or_path", str(cut)]), device="cpu")


def _video_of_main(argv, tmp_path, monkeypatch, name):
    """main's video (the array it hands to save_videos_grid) and rc."""
    from stableavatar_tpu_torch.utils import video_io

    videos, save = [], video_io.save_videos_grid
    monkeypatch.setattr(video_io, "save_videos_grid",
                        lambda v, path, fps=25: videos.append(v) or save(v, path, fps))
    rc = tcli.main([*argv, "--output_dir", str(tmp_path / name)], device="cpu")
    assert rc == 0 and len(videos) == 1
    return videos[0]


def test_main_with_checkpoints_and_sequential_offload(synth_inputs, checkpoints, tmp_path,
                                                      monkeypatch):
    """The CLI end to end from the checkpoint root, the override and the
    wav2vec2 directory; under sequential_cpu_offload the DiT streams from
    host memory (the fast-path preparation skipped, as in the JAX CLI) and
    the video equals the resident run's bit for bit."""
    from stableavatar_tpu_torch.models.streaming import StreamedDiT

    ref, wav = synth_inputs
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    argv = ["--validation_reference_path", ref, "--validation_driven_audio_path", wav, *TINY,
            *checkpoints, "--validation_prompts", "A person is talking"]
    resident = _video_of_main(argv, tmp_path, monkeypatch, "resident")
    models = tcli.load_models(tcli.build_parser().parse_args(
        [*argv, "--GPU_memory_mode", "sequential_cpu_offload", "--fast_path", "linears"]),
        device="cpu")
    assert models.dit_params is None and isinstance(models.streamed_dit, StreamedDiT)
    assert models.attn_quant == "none" and not models.rope_split
    assert models.streamed_dit.num_layers == 2
    streamed = _video_of_main([*argv, "--GPU_memory_mode", "sequential_cpu_offload"], tmp_path,
                              monkeypatch, "sequential")
    assert resident.shape == (1, 3, 25, 32, 32) and np.isfinite(resident).all()
    np.testing.assert_array_equal(streamed, resident)


def test_main_14b_family(synth_inputs, tmp_path, monkeypatch):
    """--model_family 14B: the DiT has 14B's two-stage audio projection (a
    tiny one here) and TeaCache takes the 14B coefficients."""
    from stableavatar_tpu_torch.models.teacache import get_teacache_coefficients

    ref, wav = synth_inputs
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    models = tcli.load_models(_args("--model_family", "14B", "--enable_teacache"), device="cpu")
    proj = models.dit_params["vocal_projector"]["proj"]
    assert set(proj) == {"fc1", "norm1", "fc2", "norm"}
    assert models.teacache.coefficients == get_teacache_coefficients("wan2.1-t2v-14b")
    video = _video_of_main(["--validation_reference_path", ref, "--validation_driven_audio_path",
                            wav, *TINY, "--model_family", "14B"], tmp_path, monkeypatch, "14b")
    assert video.shape == (1, 3, 25, 32, 32) and np.isfinite(video).all()
