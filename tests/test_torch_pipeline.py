"""The port's generate_long against the JAX package's on the tiny models of
tests/test_pipeline.py: same weights (through the bridge), same numpy
initial latents, text context, reference image and waveform.

The JAX side runs in a subprocess whose XLA has excess precision off
(`--xla_allow_excess_precision=false`, which has to reach XLA before its
CPU backend starts): XLA then rounds bf16 elementwise chains after every
op, as the port's eager ops do, instead of fusing them in fp32.  One such
subprocess per test run (`jax_reference`) serves this module and the
solver and TeaCache comparisons.
"""

import contextlib
import fcntl
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stableavatar_tpu.models.clip import init_clip_visual
from stableavatar_tpu.models.dit import init_dit
from stableavatar_tpu.models import vae as jvae
from stableavatar_tpu.models.vae import init_vae
from stableavatar_tpu.models.wav2vec import init_wav2vec2
from stableavatar_tpu.pipelines import common as jcommon
from stableavatar_tpu.pipelines import long as jlong
from stableavatar_tpu.utils.fastpath import prepare_fast_params as jprepare
from stableavatar_tpu_torch.models import vae as tvae
from stableavatar_tpu_torch.models.teacache import TeaCache, get_teacache_coefficients
from stableavatar_tpu_torch.pipelines import common as tcommon
from stableavatar_tpu_torch.pipelines import long as tlong
from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params as tprepare
from stableavatar_tpu_torch.utils.profiling import StepTimer
from stableavatar_tpu_torch.utils.weights import dit_from_jax, from_jax_tree
from tests.test_pipeline import CLIP_E2E, DIT_E2E, VAE_E2E, W2V_E2E
from tests.torch_parity import jit_init, pallas_k5, rel_l2, t, to_numpy_tree

REPO = Path(__file__).resolve().parent.parent
EXACT_XLA_FLAG = "--xla_allow_excess_precision=false"


def run_jax_exact(fn, **kwargs):
    """fn(**kwargs) -- a module-level function of a tests module whose
    arguments and result pickle -- in a fresh Python on the CPU whose XLA
    runs with EXACT_XLA_FLAG (and the suite's fp32 matmul precision)."""
    with tempfile.TemporaryDirectory() as d:
        args_path, out_path = os.path.join(d, "args.pkl"), os.path.join(d, "out.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(kwargs, f)
        code = (
            "import importlib, pickle\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "jax.config.update('jax_default_matmul_precision', 'highest')\n"
            f"fn = getattr(importlib.import_module({fn.__module__!r}), {fn.__name__!r})\n"
            f"with open({args_path!r}, 'rb') as f:\n"
            "    out = fn(**pickle.load(f))\n"
            f"with open({out_path!r}, 'wb') as f:\n"
            "    pickle.dump(out, f)\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {EXACT_XLA_FLAG}".strip())
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=900)
        assert run.returncode == 0, run.stderr[-4000:]
        with open(out_path, "rb") as f:
            return pickle.load(f)


# Every JAX run that the parity modules compare with (this one,
# tests/test_torch_solvers.py, tests/test_torch_teacache.py and
# tests/test_torch_single_clip.py), by name; `jax_reference` computes them
# all in one subprocess.  "kind" is "long" (generate_long, the default),
# "single" (generate_single_clip) or "validation" (the training loop's
# log_validation).  "latent" output skips the decode, most of a run's
# compiles.  The long TeaCache runs take 5 steps over 2 windows: the
# counter wraps every 5 calls, so steps 1 and 3 pair two skippable calls
# (counts 2, 3 and 1, 2); with 3 or 4 steps every step pairs a skippable
# call with a forced one and nothing is skipped.  A single clip is one
# window: its counter wraps every 5 steps.
JAX_RUNS = {
    "euler": dict(fast=False),
    "euler-fast": dict(fast=True),
    **{name: dict(fast=False, scheduler=name, num_inference_steps=3, output_type="latent")
       for name in ("dpm++", "unipc")},
    **{f"teacache-{name}": dict(fast=False, scheduler=name, num_inference_steps=5,
                                teacache=(5, 0.3, 1), output_type="latent")
       for name in ("euler", "unipc")},
    "single-euler": dict(kind="single", fast=False),
    "single-euler-fast": dict(kind="single", fast=True),
    **{f"single-{name}{suffix}": dict(kind="single", fast=fast, scheduler=name,
                                      num_inference_steps=3, output_type="latent")
       for name in ("dpm++", "unipc") for fast, suffix in ((False, ""), (True, "-fast"))},
    **{f"single-teacache-{name}": dict(kind="single", fast=False, scheduler=name,
                                       num_inference_steps=5, teacache=(5, 0.3, 1),
                                       output_type="latent")
       for name in ("euler", "unipc")},
    "validation": dict(kind="validation", fast=True, num_inference_steps=2),
}

_JAX_REFERENCE = {}


def jax_reference(tmp_path_factory):
    """{"models": the JAX models as numpy trees, "runs": {name: result}}
    for every run of JAX_RUNS, from ONE `run_jax_exact` subprocess per test
    run.  The xdist workers of a run share it through a pickle in the
    run's common temp directory: the first to ask computes it under a
    lock, the others wait for it and read it."""
    if not _JAX_REFERENCE:
        base = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            base = base.parent  # the run's directory, above the workers' own
        path = base / "jax_reference.pkl"
        with open(base / "jax_reference.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                out = run_jax_exact(jax_generate_long, runs=JAX_RUNS)
                tmp = path.with_suffix(".tmp")
                with open(tmp, "wb") as f:
                    pickle.dump(out, f)
                os.replace(tmp, path)
        with open(path, "rb") as f:
            _JAX_REFERENCE.update(pickle.load(f))
    return _JAX_REFERENCE


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    """The models of the JAX reference runs (numpy trees)."""
    return jax_reference(tmp_path_factory)["models"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_reference(tmp_path_factory)["runs"]


def make_jax_models():
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    dit = jit_init(init_dit, DIT_E2E, ks[0])
    # random head / vocal weights so the velocity is not zero
    dit["head"]["head"]["w"] = jax.random.normal(
        jax.random.PRNGKey(9), dit["head"]["head"]["w"].shape) * 0.05
    for i, name in ((10, "k_vocal"), (11, "v_vocal")):
        node = dit["blocks"]["cross_attn"][name]
        node["w"] = jax.random.normal(jax.random.PRNGKey(i), node["w"].shape) * 0.1
    return dict(dit=dit, vae=jit_init(init_vae, VAE_E2E, ks[1]),
                clip=jit_init(init_clip_visual, CLIP_E2E, ks[3]),
                w2v=jit_init(init_wav2vec2, W2V_E2E, ks[4]))


def _inputs():
    rng = np.random.default_rng(2)
    ref = rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    # 14 video frames at 640 samples/frame -> infer_length 4; clip_length 9
    # gives 3-frame windows with overlap 1: windows (0, 3), (1, 4)
    wav = rng.standard_normal(14 * 640).astype(np.float32) * 0.1
    text_ctx = rng.standard_normal((3, DIT_E2E.text_len, DIT_E2E.text_dim)).astype(np.float32)
    latents = rng.standard_normal((1, VAE_E2E.z_dim, 4, 8, 8)).astype(np.float32)
    return ref, wav, text_ctx, latents


def _teacache(tc, cls=TeaCache):
    """The TeaCache of a tiny run: tc = (steps, threshold, skip-start steps)."""
    if tc is None:
        return None
    return cls(get_teacache_coefficients("wan2.1-t2v-1.3b"), tc[0], rel_l1_thresh=tc[1],
               num_skip_start_steps=tc[2])


def single_inputs():
    """The single clip's inputs: clip_length 9 (3 latent frames) and 9 video
    frames of audio, cut from `_inputs`."""
    ref, wav, text_ctx, latents = _inputs()
    return ref, wav[: 9 * 640], text_ctx, latents[:, :, :3]


VALIDATION_SEED = 5


def _solver_kw(run):
    return dict(num_inference_steps=run.get("num_inference_steps", 2),
                scheduler=run.get("scheduler", "euler"), solver_order=run.get("solver_order", 2),
                solver_type=run.get("solver_type"))


def jax_generate_long(runs):
    """The JAX generate_long for each named run (a dict: fast, and
    optionally scheduler, solver_order, solver_type, num_inference_steps,
    teacache, output_type): its per-step and final latents, video and
    TeaCache skipped_calls, with the models as numpy trees.  The fast runs
    take the Pallas K5 (`pallas_k5`)."""
    import time

    from stableavatar_tpu.models.teacache import TeaCache as JTeaCache

    from stableavatar_tpu.pipelines import single_clip as jsingle

    jax_models = make_jax_models()
    ref, wav, text_ctx, latents = _inputs()
    s_ref, s_wav, s_ctx, s_latents = single_inputs()
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        fast, kind = run["fast"], run.get("kind", "long")
        teacache = _teacache(run.get("teacache"), JTeaCache)
        jdit = jprepare(jax_models["dit"], DIT_E2E, quant=True) if fast else jax_models["dit"]
        jm = jcommon.WanModels(
            dit_params=jdit, dit_cfg=DIT_E2E, vae_params=jax_models["vae"], vae_cfg=VAE_E2E,
            clip_params=jax_models["clip"], clip_cfg=CLIP_E2E,
            wav2vec_params=jax_models["w2v"], wav2vec_cfg=W2V_E2E, rope_split=fast,
            attn_quant="qk" if fast else "none", teacache=teacache)
        steps = []
        callback = lambda i, x: steps.append(np.asarray(x, np.float32))  # noqa: E731
        with pallas_k5() if fast else contextlib.nullcontext():
            if kind == "validation":
                out[name] = jax_log_validation(jm, run)
                continue
            if kind == "single":
                want = jsingle.generate_single_clip(
                    jm, text_ctx=jnp.asarray(s_ctx), ref_image=s_ref, vocal_waveform=s_wav,
                    clip_length=9, initial_latents=s_latents, step_callback=callback,
                    output_type=run.get("output_type", "numpy"), **_solver_kw(run))
            else:
                want = jlong.generate_long(
                    jm, text_ctx=jnp.asarray(text_ctx), ref_image=ref, vocal_waveform=wav,
                    clip_length=9, overlap_window_length=1, initial_latents=latents,
                    step_callback=callback, output_type=run.get("output_type", "numpy"),
                    **_solver_kw(run))
        out[name] = dict(steps=steps, latents=np.asarray(want.latents),
                         videos=None if want.videos is None else np.asarray(want.videos),
                         skipped=None if teacache is None else teacache.skipped_calls,
                         seconds=time.perf_counter() - t0)
    return dict(models=to_numpy_tree(jax_models), runs=out)


def validation_cfg(run, text_ctx, ref, wav):
    return dict(ref_image=ref, vocal_waveform=wav, text_ctx=text_ctx,
                num_inference_steps=run["num_inference_steps"], clip_length=9,
                seed=VALIDATION_SEED, fps=25)


def jax_log_validation(jm, run):
    """The JAX training loop's log_validation: the video it hands to
    save_videos_grid, what that wrote (an mp4, or a PNG frame directory
    without an ffmpeg backend) and the run's initial noise."""
    from stableavatar_tpu.train import loop as jloop
    from stableavatar_tpu.utils import video_io as jvideo

    ref, wav, text_ctx, latents = single_inputs()
    videos, written, save = [], [], jvideo.save_videos_grid

    def record(v, path, fps=25):
        videos.append(np.asarray(v))
        written.append(save(v, path, fps))
        return written[-1]

    with tempfile.TemporaryDirectory() as d, mock.patch.object(jvideo, "save_videos_grid",
                                                               record):
        jloop.log_validation(jm, validation_cfg(run, jnp.asarray(text_ctx), ref, wav), d, 7)
        written = os.path.relpath(written[0], d)
    noise = jax.random.normal(jax.random.PRNGKey(VALIDATION_SEED), latents.shape, jnp.float32)
    return dict(video=videos[0], written=written, noise=np.asarray(noise))


def port_models(jax_models, fast: bool, teacache=None):
    tdit = dit_from_jax(to_numpy_tree(jax_models["dit"]))
    return tcommon.WanModels(
        dit_params=tprepare(tdit, DIT_E2E, quant=True) if fast else tdit, dit_cfg=DIT_E2E,
        vae_params=from_jax_tree(to_numpy_tree(jax_models["vae"])), vae_cfg=VAE_E2E,
        clip_params=from_jax_tree(to_numpy_tree(jax_models["clip"])), clip_cfg=CLIP_E2E,
        wav2vec_params=from_jax_tree(to_numpy_tree(jax_models["w2v"])), wav2vec_cfg=W2V_E2E,
        rope_split=fast, attn_quant="qk" if fast else "none", teacache=teacache, device="cpu")


def port_generate_long(jax_models, run, timer=None):
    """The port's side of one `jax_generate_long` run: (output, per-step
    latents, TeaCache)."""
    ref, wav, text_ctx, latents = _inputs()
    tm = port_models(jax_models, run["fast"], _teacache(run.get("teacache")))
    steps = []
    got = tlong.generate_long(
        tm, text_ctx=torch.from_numpy(text_ctx), ref_image=ref, vocal_waveform=wav,
        clip_length=9, overlap_window_length=1, initial_latents=latents, timer=timer,
        step_callback=lambda i, x: steps.append(x.float().numpy()), **_solver_kw(run))
    return got, steps, tm.teacache


def _run_both(jax_models, jax_runs, fast: bool):
    name = "euler-fast" if fast else "euler"
    want = jax_runs[name]
    timer = StepTimer("cpu")
    got, t_steps, _ = port_generate_long(jax_models, JAX_RUNS[name], timer)
    return want, got, want["steps"], t_steps, timer


# Latent tolerance per path, above the error measured with XLA's excess
# precision off: bf16 4.6e-4 / 8.6e-4 after steps 1 / 2 (the port's bf16 ops
# round where XLA's then round; 0.0085 / 0.0092 with excess precision on).
# The fast path, with the JAX side on its Pallas K5 (`pallas_k5`), gives
# the JAX latents bit for bit since the plain K5 rounds the normalised P to
# bf16 where the TPU kernel does and the W8A8 activation scale is amax
# times the fp32 reciprocal of 127, as XLA compiles `/ 127.0` (0.0101 /
# 0.0106 before, 0.0040 / 0.0044 with the K5 repair alone); it is held to
# the part's 1e-2 target, above the int8 rounding flips that a last-bit
# difference upstream can cause.
LATENT_TOL = {False: 2e-3, True: 1e-2}


@pytest.mark.parametrize("fast", [False, True])
def test_generate_long_matches_jax(jax_models, jax_runs, fast):
    want, got, j_steps, t_steps, timer = _run_both(jax_models, jax_runs, fast)
    assert len(tlong.plan_windows(4, 3, 1)) == 2
    assert len(t_steps) == len(j_steps) == 2
    for a, b in zip(t_steps, j_steps):
        assert rel_l2(a, b) < LATENT_TOL[fast]
    assert rel_l2(got.latents.numpy(), want["latents"]) < LATENT_TOL[fast]
    assert got.videos.shape == want["videos"].shape == (1, 3, 13, 32, 32)
    assert np.isfinite(got.videos).all() and got.videos.min() >= 0 and got.videos.max() <= 1
    assert len(timer.history["denoise_step"]) == 2 and "vae_decode" in timer.history
    # The pipelines decode in bf16, and the tiny random VAE amplifies bf16
    # rounding.  The port's decoder rounds where XLA's does (SiLU op for
    # op, the conv bias after the rounded product, the mid attention as
    # `short_attention`; bit for bit on test_torch_vae.py's latents), so on
    # the fast path, whose latents are equal, the videos differ by at most
    # 1/255 (782 of 39,936 values, mean 0.02/255; 16/255 before the
    # repair); on the bf16 path (latents 1.6e-2 apart) by 37/255.  So the
    # decode stage is held to 2/255 on the same latents: the JAX
    # pipeline's final latents through both decoders (fp32).
    jv = np.concatenate([np.asarray(s) for s in jvae.decode_video_segmented(
        jax.tree.map(jnp.asarray, jax_models["vae"]), jnp.asarray(want["latents"]), VAE_E2E,
        out_uint8=True)], axis=2)
    tv = torch.cat(tvae.decode_video_segmented(
        from_jax_tree(to_numpy_tree(jax_models["vae"])), t(want["latents"]),
        VAE_E2E, out_uint8=True), dim=2).numpy()
    assert np.max(np.abs(tv.astype(np.float32) - jv.astype(np.float32))) < 2


def test_generate_long_unported_options_raise():
    tm = tcommon.WanModels(dit_params=None, dit_cfg=DIT_E2E, vae_params=None, vae_cfg=VAE_E2E,
                           device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        tlong.generate_long(tm, ref_image=np.zeros((1, 3, 32, 32)), vocal_waveform=np.zeros(9000),
                            text_ctx=np.zeros((3, 4, 8), np.float32), scheduler="heun")
    with pytest.raises(ValueError, match="text_ctx"):
        tcommon.encode_prompts(tm, "a person talking")


@pytest.mark.parametrize("args", [(21, 21, 15), (40, 21, 15), (75, 21, 10), (5, 3, 1), (27, 21, 15)])
def test_window_planners_match_jax(args):
    infer_length, fpb, ov = args
    windows = tlong.plan_windows(*args)
    assert windows == jlong.plan_windows(*args)
    for a, b in zip(tlong.plan_audio_slices(windows, infer_length, 640, infer_length * 2500),
                    jlong.plan_audio_slices(windows, infer_length, 640, infer_length * 2500)):
        np.testing.assert_array_equal(a, b)
    for scheme in ("uniform", "log"):
        np.testing.assert_array_equal(tlong.overlap_weights(ov, scheme),
                                      jlong.overlap_weights(ov, scheme))
