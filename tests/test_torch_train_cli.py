"""The port's train CLI (`stableavatar_tpu_torch/cli/train.py`): its flags
against the JAX package's parser, the inference CLI's `load_models` under
the train namespace (T5 kept on the device, or on the host in fp32 with
--low_vram), and the tiny end-to-end runs of tests/test_cli_train_e2e.py
(STABLEAVATAR_TINY=1, device="cpu"): a clip directory on disk, encodes,
train steps, checkpoints, metrics and the validation clip."""

import json
import os

import numpy as np
import pytest
import torch

from stableavatar_tpu.cli.train import build_parser as jax_parser
from stableavatar_tpu_torch.cli import train as tcli


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("dest", sorted(_flags(jax_parser())))
def test_train_parser_matches_jax(dest):
    """Flag for flag: the option strings, default, choices, type, nargs and
    whether it is required or a switch."""
    want, got = _flags(jax_parser())[dest], _flags(tcli.build_parser()).get(dest)
    assert got is not None, dest
    for attr in ("option_strings", "default", "choices", "type", "nargs", "required", "const"):
        assert getattr(got, attr) == getattr(want, attr), (dest, attr)
    assert type(got).__name__ == type(want).__name__


def test_train_parser_has_no_other_flags():
    assert set(_flags(tcli.build_parser())) == set(_flags(jax_parser()))


@pytest.mark.parametrize("low_vram", [False, True])
def test_load_models_takes_the_train_namespace(monkeypatch, low_vram):
    """The inference CLI's load_models with the train parser's namespace
    (which lacks every inference-only flag): T5 is kept, not released after
    an encode, in bf16 on the models' device, or in fp32 on the host with
    --low_vram, and it encodes a batch's prompts."""
    from stableavatar_tpu_torch.cli.inference import load_models
    from stableavatar_tpu_torch.pipelines.common import encode_prompt_ids
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    args = tcli.build_parser().parse_args(["--low_vram"] if low_vram else [])
    args.t5_cpu = bool(args.low_vram)  # what the train CLI sets
    models = load_models(args, "cpu")
    assert models.t5_params is not None and models.text_ctx is None
    dtypes = {p.dtype for p in tree_leaves(models.t5_params)}
    assert dtypes == ({torch.float32} if low_vram else {torch.bfloat16})
    assert models.streamed_dit is None and models.attn_impl == "ulysses"
    assert models.teacache is None and not models.rope_split
    ids, mask = zip(*(models.tokenizer(p) for p in ("The protagonist is talking", "")))
    emb = encode_prompt_ids(models, np.stack(ids), np.stack(mask))
    assert emb.shape == (2, models.t5_cfg.text_len, models.t5_cfg.dim)
    assert torch.isfinite(emb.float()).all()


@pytest.fixture
def train_data(tmp_path):
    """tests/test_cli_train_e2e.py's clip (12 frames of 64 x 64, masks, a
    1 s wav), a reference image and a driving wav for the validation."""
    import cv2

    from stableavatar_tpu_torch.utils.media import save_wav

    root = tmp_path / "data"
    clip = root / "speech_clip_000"
    (clip / "images").mkdir(parents=True)
    (clip / "face_masks").mkdir()
    (clip / "lip_masks").mkdir()
    rng = np.random.default_rng(0)
    for i in range(12):
        cv2.imwrite(str(clip / "images" / f"{i:05d}.png"),
                    rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        mask = (rng.random((64, 64)) > 0.5).astype(np.uint8) * 255
        cv2.imwrite(str(clip / "face_masks" / f"{i:05d}.png"), mask)
        cv2.imwrite(str(clip / "lip_masks" / f"{i:05d}.png"), mask)
    save_wav(str(clip / "audio.wav"), (rng.standard_normal(16000) * 0.1).astype(np.float32),
             16000)
    index = root / "index.txt"
    index.write_text(str(clip) + "\n")
    cv2.imwrite(str(root / "ref.png"), rng.integers(0, 255, (48, 48, 3), dtype=np.uint8))
    save_wav(str(root / "voice.wav"), (rng.standard_normal(32000) * 0.1).astype(np.float32),
             16000)
    return str(index)


def _losses(outdir):
    metrics = [f for f in os.listdir(outdir) if f.endswith(".metrics.jsonl")]
    assert metrics, os.listdir(outdir)
    with open(os.path.join(outdir, metrics[0])) as f:
        return [json.loads(line)["train_loss"] for line in f if line.strip()]


def short_validation(monkeypatch, module):
    """The CLI's validation clip cut to 2 steps of 9 frames (it takes
    log_validation's 20 steps of 81), its prompts and inputs as built."""
    build = module.validation_config
    monkeypatch.setattr(module, "validation_config", lambda args, models: dict(
        build(args, models), num_inference_steps=2, clip_length=9))


def test_train_cli_end_to_end_tiny(train_data, tmp_path, monkeypatch):
    """The CLI's main on the CPU: 2 steps from the clip directory through
    the decode pool, a rotated checkpoint, finite losses in the metrics
    JSONL, and the validation clip of step 2 (the single-clip pipeline with
    the CLI's prompts, written as PNG frames or an mp4)."""
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    short_validation(monkeypatch, tcli)
    outdir = str(tmp_path / "run")
    data = os.path.dirname(train_data)
    rc = tcli.main([
        "--train_data_meta", train_data, "--video_sample_size", "32",
        "--video_sample_n_frames", "5", "--train_batch_size", "1", "--max_train_steps", "2",
        "--checkpointing_steps", "1", "--checkpoints_total_limit", "1",
        "--learning_rate", "1e-4", "--dataloader_num_workers", "1", "--log_every", "1",
        "--validation_steps", "2",
        "--validation_reference_path", os.path.join(data, "ref.png"),
        "--validation_driven_audio_path", os.path.join(data, "voice.wav"),
        "--output_dir", outdir], device="cpu")
    assert rc == 0
    assert sorted(d for d in os.listdir(outdir) if d.startswith("checkpoint-")) == [
        "checkpoint-2"]
    losses = _losses(outdir)
    assert len(losses) == 2 and all(np.isfinite(losses))
    valid = [d for d in os.listdir(outdir) if d.startswith("validation_step2")]
    assert valid, os.listdir(outdir)
    path = os.path.join(outdir, valid[0])
    assert os.path.isfile(path) or len(os.listdir(path)) == 9


def test_train_cli_lora_end_to_end_tiny(train_data, tmp_path, monkeypatch):
    """--lora parses and drives nothing, as in the JAX CLI: a checkpoint
    appears (tests/test_cli_train_e2e.py's check)."""
    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    outdir = str(tmp_path / "run_lora")
    tcli.main([
        "--train_data_meta", train_data, "--video_sample_size", "32",
        "--video_sample_n_frames", "5", "--train_batch_size", "1", "--max_train_steps", "1",
        "--checkpointing_steps", "1", "--lora", "--rank", "2", "--network_alpha", "4",
        "--output_dir", outdir], device="cpu")
    assert any(d.startswith("checkpoint-") for d in os.listdir(outdir))


def test_train_cli_14b_tiny(train_data, tmp_path, monkeypatch):
    """--model_family 14B under STABLEAVATAR_TINY: a tiny DiT of 14B's
    structure (the two-stage vocal projection) trains a step and its
    checkpoint holds that tree."""
    import dataclasses

    from stableavatar_tpu_torch.config import tiny_debug_configs
    from stableavatar_tpu_torch.models.dit import init_dit
    from stableavatar_tpu_torch.utils.tree import tree_paths

    monkeypatch.setenv("STABLEAVATAR_TINY", "1")
    outdir = str(tmp_path / "run_14b")
    tcli.main([
        "--train_data_meta", train_data, "--video_sample_size", "32",
        "--video_sample_n_frames", "5", "--max_train_steps", "1", "--checkpointing_steps", "1",
        "--model_family", "14B", "--log_every", "1", "--output_dir", outdir], device="cpu")
    state = torch.load(os.path.join(outdir, "checkpoint-1", "state.pt"), weights_only=True)
    cfg = tiny_debug_configs()[0]
    cfg14 = dataclasses.replace(cfg, audio_proj_hidden=2 * cfg.audio_proj_dim)
    want = {p: tuple(x.shape) for p, x in tree_paths(init_dit(torch.Generator(), cfg14, "cpu"))}
    got = {p: tuple(x.shape) for p, x in tree_paths(state["params"])}
    assert got == want
    plain = {p for p, _ in tree_paths(init_dit(torch.Generator(), cfg, "cpu"))}
    assert set(want) != plain  # the two-stage projection has leaves of its own
    assert len(_losses(outdir)) == 1


def test_scale_lr_and_train_config(monkeypatch):
    """--scale_lr multiplies by accumulation x batch x dp (the JAX CLI's
    :152-155); the TrainConfig carries the flags."""
    args = tcli.build_parser().parse_args([
        "--scale_lr", "--learning_rate", "1e-5", "--gradient_accumulation_steps", "2",
        "--train_batch_size", "3", "--dp", "4", "--no-uniform_sampling",
        "--weighting_scheme", "logit_normal", "--use_came"])
    seen = {}
    monkeypatch.setattr(tcli, "build_mesh", lambda args, device: None)
    monkeypatch.setattr(tcli, "load_models", lambda args, device: type(
        "M", (), {"dit_params": {}, "tokenizer": None})())
    monkeypatch.setattr(tcli, "build_batches", lambda args: iter(()))
    monkeypatch.setattr(tcli, "train", lambda models, batches, tc, **kw: seen.update(tc=tc, **kw))
    tcli.run(args, "cpu")
    tc = seen["tc"]
    assert tc.learning_rate == pytest.approx(1e-5 * 2 * 3 * 4)
    assert not tc.uniform_sampling and tc.weighting_scheme == "logit_normal" and tc.use_came
    assert tc.remat and tc.lr_total_steps == 10000 and tc.video_sample_n_frames == 81
    assert seen["resume_from_checkpoint"] == "latest" and seen["validation_cfg"] is None


def test_train_cli_runs_on_the_card_unless_asked(tmp_path):
    """main's device defaults to the card; without CUDA it raises instead of
    training on the CPU, and a mesh needs its processes."""
    import inspect

    assert inspect.signature(tcli.main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="needs 4 processes"):
        tcli.main(["--dp", "2", "--sp", "2", "--output_dir", str(tmp_path)], device="cpu")


def test_train_bytes_counts_each_optimizer_state():
    """`train_bytes` on a leaf that fsdp 2 and 4 split on its last axis and
    on a vector that stays whole: the bf16 weight and gradient and each
    optimizer's moments (AdamW 8 bytes a parameter, 8-bit Adam 3, CAME 4)
    are split over fsdp; so are the statistics the split does not reduce
    (8-bit Adam's fp32 row scales, CAME's row and column statistics; a
    vector's second moment is unfactored), while those over the split axis
    (the row scales and CAME's row statistics of the matrix) are whole."""
    leaves = [torch.empty((256, 512), device="meta"), torch.empty((8,), device="meta")]
    n, rows, cols = 256 * 512 + 8, 256, 512
    assert tcli.train_bytes(leaves, 2, "adamw") == 12 * n / 2
    assert tcli.train_bytes(leaves, 1, "adam8bit") == 7 * n + 4 * (rows + 1)
    assert tcli.train_bytes(leaves, 2, "adam8bit") == 7 * n / 2 + 4 * rows + 4 * 1 / 2
    assert tcli.train_bytes(leaves, 1, "came") == 8 * n + 4 * (2 * (rows + cols) + 8)
    assert tcli.train_bytes(leaves, 4, "came") == \
        8 * n / 4 + 4 * (2 * rows + 2 * cols / 4 + 8 / 4)
    with pytest.raises(ValueError, match="lion"):
        tcli.train_bytes(leaves, 1, "lion")


# GiB a card that train_bytes gives 14B at --fsdp 1 / 2 / 4 / 8
BYTES_14B = {"adamw": [211.8, 105.9, 52.9, 26.5], "adam8bit": [123.6, 61.8, 30.9, 15.4],
             "came": [141.3, 70.6, 35.3, 17.7]}


@pytest.mark.parametrize("flags,name", [([], "adamw"), (["--use_8bit_adam"], "adam8bit"),
                                        (["--use_came"], "came")])
def test_check_fits_counts_the_chosen_optimizer(flags, name):
    """The train CLI's fit check counts the optimizer the flags choose: at
    14B on H100s (79 GiB each, as an H100 80GB reports), AdamW trains from
    --fsdp 4, 8-bit Adam and CAME, whose state fsdp splits too, from 2."""
    from stableavatar_tpu_torch.config import WAN_14B
    from stableavatar_tpu_torch.models.dit import init_dit
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    args = tcli.build_parser().parse_args(flags)
    assert tcli.optimizer_name(args) == name
    leaves = tree_leaves(init_dit(torch.Generator(), WAN_14B, device="meta",
                                  dtype=torch.bfloat16))
    gib = [round(tcli.train_bytes(leaves, f, name) / 2**30, 1) for f in (1, 2, 4, 8)]
    assert gib == BYTES_14B[name]
    fits = [f for f, g in zip((1, 2, 4, 8), gib) if g <= 79]
    assert fits == {"adamw": [4, 8], "adam8bit": [2, 4, 8], "came": [2, 4, 8]}[name]
