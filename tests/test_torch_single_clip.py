"""The port's single-clip pipeline (`pipelines/single_clip.py`) and the
training loop's `log_validation` against the JAX package's on the tiny
models of tests/test_pipeline.py: Euler, DPM++, UniPC and TeaCache on the
bf16 and the fast path (mirroring tests/test_pipeline.py:167, :191 and
:564), the JAX side with XLA's excess precision off, from the subprocess
shared with tests/test_torch_pipeline.py."""

import functools
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from stableavatar_tpu.pipelines import common as jcommon
from stableavatar_tpu_torch.pipelines import common as tcommon
from stableavatar_tpu_torch.pipelines import single_clip as tsingle
from stableavatar_tpu_torch.train import loop as tloop
from stableavatar_tpu_torch.utils import video_io as tvideo
from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    JAX_RUNS,
    LATENT_TOL,
    _solver_kw,
    _teacache,
    jax_models,
    jax_runs,
    port_models,
    single_inputs,
    validation_cfg,
)
from tests.torch_parity import rel_l2

SINGLE_RUNS = [name for name, run in JAX_RUNS.items() if run.get("kind") == "single"]


def port_single_clip(jax_models, run):
    """The port's side of one single-clip run: (output, per-step latents,
    TeaCache)."""
    ref, wav, text_ctx, latents = single_inputs()
    tm = port_models(jax_models, run["fast"], _teacache(run.get("teacache")))
    steps = []
    got = tsingle.generate_single_clip(
        tm, text_ctx=torch.from_numpy(text_ctx), ref_image=ref, vocal_waveform=wav,
        clip_length=9, initial_latents=latents, output_type=run.get("output_type", "numpy"),
        step_callback=lambda i, x: steps.append(x.numpy()), **_solver_kw(run))
    return got, steps, tm.teacache


@pytest.mark.parametrize("name", SINGLE_RUNS)
def test_single_clip_matches_jax(jax_models, jax_runs, name):
    """Per-step and final latents within `test_generate_long_matches_jax`'s
    tolerance of their path (bf16 2e-3, fast 1e-2 relative L2); TeaCache
    skips the same steps; the video is (1, 3, 9, 32, 32) in [0, 1]."""
    run, want = JAX_RUNS[name], jax_runs[name]
    got, steps, tc = port_single_clip(jax_models, run)
    assert len(steps) == len(want["steps"]) == run.get("num_inference_steps", 2)
    errs = [rel_l2(a, b) for a, b in zip(steps, want["steps"])]
    final = rel_l2(got.latents.numpy(), want["latents"])
    print(f"{name}: rel_l2 per step {errs}, final {final:.3e}, max-abs "
          f"{np.abs(got.latents.numpy() - want['latents']).max():.3e}")
    assert all(e < LATENT_TOL[run["fast"]] for e in errs) and final < LATENT_TOL[run["fast"]]
    if tc is not None:
        assert tc.skipped_calls == want["skipped"] > 0
    if run.get("output_type") == "latent":
        assert got.videos is None and want["videos"] is None
    else:
        assert got.videos.shape == want["videos"].shape == (1, 3, 9, 32, 32)
        assert np.isfinite(got.videos).all() and 0 <= got.videos.min() <= got.videos.max() <= 1


def test_guidance_combine_single_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 2, 3, 3)).astype(np.float32)
    want = np.asarray(jcommon.guidance_combine_single(jax.numpy.asarray(x), 3.0, 5.0))
    got = tcommon.guidance_combine_single(torch.from_numpy(x), 3.0, 5.0).numpy()
    np.testing.assert_array_equal(got, want)
    # the long combine with the two scales swapped
    np.testing.assert_array_equal(
        got, tcommon.guidance_combine_long(torch.from_numpy(x), 5.0, 3.0).numpy())


def test_single_clip_teacache_never_skipping_equals_plain(jax_models):
    """As tests/test_pipeline.py:564: a never-skipping TeaCache gives the
    plain path's latents bit for bit; an always-skipping one skips and
    stays finite."""
    from stableavatar_tpu_torch.models.teacache import TeaCache

    ref, wav, text_ctx, latents = single_inputs()
    kw = dict(ref_image=ref, vocal_waveform=wav, text_ctx=torch.from_numpy(text_ctx),
              clip_length=9, initial_latents=latents, num_inference_steps=4,
              output_type="latent")
    tm = port_models(jax_models, False)
    plain = tsingle.generate_single_clip(tm, **kw)
    tm.teacache = TeaCache([0.0] * 5, 4, rel_l1_thresh=0.0, num_skip_start_steps=99)
    never = tsingle.generate_single_clip(tm, **kw)
    assert tm.teacache.skipped_calls == 0
    assert torch.equal(plain.latents, never.latents)
    tm.teacache = TeaCache([0.0] * 5, 4, rel_l1_thresh=1.0, num_skip_start_steps=0)
    skipping = tsingle.generate_single_clip(tm, **kw)
    assert tm.teacache.skipped_calls > 0 and torch.isfinite(skipping.latents).all()


def test_single_clip_encodes_prompt_ids_as_neg_pos_pos(jax_models):
    """Without a text context the prompt ids are encoded as [neg, pos, pos]."""
    ref, wav, text_ctx, latents = single_inputs()
    tm = port_models(jax_models, False)
    seen = []

    def fake_encode(models, ids, mask):
        seen.append((np.asarray(ids), np.asarray(mask)))
        return torch.from_numpy(text_ctx)

    ids_p, ids_n, mask = np.full(16, 3), np.full(16, 4), np.ones(16, np.int32)
    with mock.patch.object(tsingle, "encode_prompt_ids", fake_encode):
        tsingle.generate_single_clip(tm, ref_image=ref, vocal_waveform=wav,
                                     prompt_ids=(ids_p, mask), negative_prompt_ids=(ids_n, mask),
                                     clip_length=9, initial_latents=latents,
                                     num_inference_steps=1, output_type="latent")
    np.testing.assert_array_equal(seen[0][0], np.stack([ids_n, ids_p, ids_p]))


def test_log_validation_writes_the_jax_video(jax_models, jax_runs, tmp_path):
    """The training loop's log_validation runs the single clip (fast path,
    2 steps) from the JAX run's own initial noise and writes the file the
    JAX one writes: the video it saves is within 1/255 of the JAX one (the
    latents are equal; the decoders round where XLA rounds)."""
    run, want = JAX_RUNS["validation"], jax_runs["validation"]
    ref, wav, text_ctx, _ = single_inputs()
    cfg = validation_cfg(run, torch.from_numpy(text_ctx), ref, wav)
    videos, save = [], tvideo.save_videos_grid
    # the port draws its noise with torch: start from the JAX run's draw
    with mock.patch.object(tvideo, "save_videos_grid",
                           lambda v, path, fps=25: videos.append(v) or save(v, path, fps)), \
            mock.patch.object(tsingle, "generate_single_clip", functools.partial(
                tsingle.generate_single_clip, initial_latents=want["noise"])):
        path = tloop.log_validation(port_models(jax_models, True), cfg, str(tmp_path), 7)
    assert os.path.relpath(path, tmp_path) == want["written"]
    assert os.path.exists(path)
    assert videos[0].shape == want["video"].shape == (1, 3, 9, 32, 32)
    diff = np.abs(videos[0] - want["video"]).max() * 255
    print(f"log_validation video max-abs {diff:.3f} / 255")
    assert diff <= 1.0 + 1e-3


def test_log_validation_without_imageio_writes_png_frames(jax_models, tmp_path, monkeypatch):
    """A host without imageio (the card's machine): the frames
    save_videos_grid would hand its writer, as PNGs through PIL."""
    from PIL import Image

    ref, wav, text_ctx, latents = single_inputs()
    cfg = validation_cfg(dict(num_inference_steps=1), torch.from_numpy(text_ctx), ref, wav)
    monkeypatch.setitem(__import__("sys").modules, "imageio", None)  # import raises
    path = tloop.log_validation(port_models(jax_models, False), cfg, str(tmp_path), 2)
    assert os.path.basename(path) == "validation_step2" and len(os.listdir(path)) == 9
    frame = np.asarray(Image.open(os.path.join(path, "frame_000000.png")))
    assert frame.shape == (32, 32, 3) and frame.dtype == np.uint8
