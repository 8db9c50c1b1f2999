"""The port's training stack against the JAX package's: losses, schedules,
the optimizer chain, batch encoding, the train step, checkpoints and the
loop.  Inputs are numpy arrays made from a seed and handed to both sides;
where the JAX side draws from a key, the test recomputes its draws and hands
them to the port."""

import dataclasses
import os
import signal
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stableavatar_tpu.config import DiTConfig
from stableavatar_tpu.models import dit as jdit
from stableavatar_tpu.train import losses as jlosses
from stableavatar_tpu.train import trainer as jtrainer
from stableavatar_tpu_torch.train import losses as tlosses
from stableavatar_tpu_torch.train import optim
from stableavatar_tpu_torch.train import trainer as ttrainer
from stableavatar_tpu_torch.utils.tree import tree_leaves
from stableavatar_tpu_torch.utils.weights import dit_from_jax, from_jax_tree, t5_from_jax
from tests.test_pipeline import CLIP_E2E, DIT_E2E, T5_E2E, VAE_E2E, W2V_E2E
from tests.torch_parity import densify_dit, jit_init, pallas_interpret, rel_l2, t, to_numpy_tree

# ---------------------------------------------------------------------------
# losses and schedules (mirrors tests/test_train.py:63-104, 280-340)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag,motion", [(0.45, 0.0), (0.7, 0.0), (0.1, 0.0), (0.45, 0.25),
                                         (0.9, 0.5)])
def test_masked_flow_loss_matches_jax(flag, motion):
    rng = np.random.default_rng(1)
    pred, target = (rng.standard_normal((2, 4, 3, 4, 4)).astype(np.float32) for _ in range(2))
    face, lip = (rng.uniform(0, 1, (2, 1, 3, 4, 4)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0.5, 2, (2, 1, 1, 1, 1)).astype(np.float32)
    want = jlosses.masked_flow_loss(*map(jnp.asarray, (pred, target, face, lip)),
                                    jnp.asarray(flag, jnp.float32), weighting=jnp.asarray(w),
                                    motion_sub_ratio=motion)
    got = tlosses.masked_flow_loss(*map(t, (pred, target, face, lip)),
                                   torch.tensor(flag, dtype=torch.float32), weighting=t(w),
                                   motion_sub_ratio=motion)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("gnorm,step", [(0.01, 200), (10.0, 200), (10.0, 0), (0.3, 50),
                                        (2.0, 1001)])
def test_anomaly_aware_max_norm_matches_jax(gnorm, step):
    for decay in (100, 1000):
        want = jlosses.anomaly_aware_max_norm(jnp.asarray(gnorm, jnp.float32), 0.05, 5.0, decay,
                                              jnp.asarray(step, jnp.int32))
        got = tlosses.anomaly_aware_max_norm(torch.tensor(gnorm), 0.05, 5.0, decay,
                                             torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("scheme", [None, "sigma_sqrt", "cosmap", "mode"])
def test_weighting_and_density_sampling_match_jax(scheme):
    sig = np.linspace(0.05, 1.0, 7, dtype=np.float32)
    np.testing.assert_allclose(tlosses.loss_weighting(scheme, t(sig)).numpy(),
                               np.asarray(jlosses.loss_weighting(scheme, jnp.asarray(sig))),
                               rtol=1e-6)
    if scheme in (None, "mode"):
        key = jax.random.PRNGKey(3)
        want = jlosses.density_timestep_indices(key, 512, scheme, 1000)
        u = t(jax.random.uniform(key, (512,)))
        got = tlosses.density_indices_from_uniform(u, scheme, 1000)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    idx = tlosses.sample_timestep_indices(gen, 1000, 1000, dp_rank=2, dp_size=4, device="cpu")
    assert int(idx.min()) >= 500 and int(idx.max()) < 750
    idx = tlosses.density_timestep_indices(gen, 4096, "logit_normal", 1000, device="cpu")
    assert 0 <= int(idx.min()) and int(idx.max()) < 1000 and float(idx.float().std()) < 288


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
def test_lr_schedules_match_jax(kind):
    kw = dict(learning_rate=1e-2, lr_scheduler=kind, lr_warmup_steps=20, lr_total_steps=200)
    want = jtrainer.lr_multiplier_schedule(jtrainer.TrainConfig(**kw))
    got = ttrainer.lr_multiplier_schedule(ttrainer.TrainConfig(**kw))
    for step in range(0, 201, 7):
        np.testing.assert_allclose(float(got(torch.tensor(step, dtype=torch.int32))),
                                   float(want(jnp.asarray(step, jnp.int32))), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(ttrainer.train_sigmas(device="cpu").numpy(),
                               np.asarray(jtrainer.train_sigmas()))


def test_trainable_mask_matches_jax():
    cfg = DiTConfig(dim=32, ffn_dim=64, num_heads=4, num_layers=2, audio_proj_dim=32,
                    vocal_num_heads=4)
    jparams = jdit.init_dit(jax.random.PRNGKey(0), cfg)
    tparams = dit_from_jax(to_numpy_tree(jparams))
    want = {path: m for path, m in _jax_paths(jtrainer.trainable_mask(jparams))}
    from stableavatar_tpu_torch.utils.tree import tree_paths

    got = ttrainer.trainable_mask(tparams)
    for (path, _), m in zip(tree_paths(tparams), got):
        parts = path.split("/")
        # the JAX tree stacks the DiT blocks on a leading axis: no index
        jpath = "/".join(parts[:1] + parts[2:]) if parts[0] == "blocks" else path
        assert m == want[jpath], path
    assert all(ttrainer.trainable_mask(tparams, train_all=True))
    assert not all(got) and any(got)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), v)
            for path, v in flat]


# ---------------------------------------------------------------------------
# the optimizer chain against optax on the same gradients
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": dict(learning_rate=1e-3),
    "adam8bit": dict(learning_rate=1e-3, use_8bit_adam=True),
    "came": dict(learning_rate=1e-3, use_came=True),
    "accumulate2": dict(learning_rate=1e-3, gradient_accumulation_steps=2),
    "cosine_warmup": dict(learning_rate=1e-3, lr_scheduler="cosine", lr_warmup_steps=2,
                          lr_total_steps=6),
    "masked": dict(learning_rate=1e-3),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    """Four steps of the port's chain against the JAX package's optax chain
    (anomaly clip included: the first steps clip, the later ones do not) on
    the same fp32 parameters and gradients, 1e-6 relative."""
    rng = np.random.default_rng(4)
    # sorted keys: JAX flattens dicts in key order, the port in insertion order
    shapes = {"a": (4, 6), "b": (6,), "c": (3, 5), "d": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    cfg = dict(OPTIMIZERS[name], max_grad_norm=0.5, abnormal_norm_clip_start=2)
    mask = {"a": True, "b": False, "c": True, "d": False} if name == "masked" else None
    jtx = jtrainer.make_optimizer(jtrainer.TrainConfig(**cfg), mask)
    ttx = ttrainer.make_optimizer(ttrainer.TrainConfig(**cfg),
                                  None if mask is None else list(mask.values()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [t(v) for v in params.values()]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32) * (0.5 if step < 2 else 0.01)
                 for k, s in shapes.items()}
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update([t(v) for v in grads.values()], tstate, tp)
        optim.apply_updates(tp, tupd)
        for k, u, p in zip(shapes, tupd, tp):
            # 1e-6 of the largest entry: CAME's chained rsqrt of means differs in
            # the last bits on entries far below the update's scale
            want_u = np.asarray(jupd[k])
            np.testing.assert_allclose(u.numpy(), want_u, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want_u).max()),
                                       err_msg=f"{name} step {step} update {k}")
            want_p = np.asarray(jp[k])
            np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want_p).max()),
                                       err_msg=f"{name} step {step} param {k}")


def test_bf16_adamw_state_follows_optax_dtypes():
    """With bf16 parameters the anomaly clip's fp32 scale makes the updates
    and Adam's moments fp32 after the first step, in optax and the port."""
    p = [torch.ones((3, 4), dtype=torch.bfloat16)]
    tx = ttrainer.make_optimizer(ttrainer.TrainConfig())
    state = tx.init(p)
    assert state[1][0]["mu"][0].dtype == torch.bfloat16
    upd, state = tx.update([torch.full((3, 4), 0.01, dtype=torch.bfloat16)], state, p)
    assert upd[0].dtype == torch.float32 and state[1][0]["mu"][0].dtype == torch.float32
    optim.apply_updates(p, upd)
    assert p[0].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the train step against the JAX step with the JAX step's own draws
# ---------------------------------------------------------------------------

STEP_CFG = DiTConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=2, audio_proj_dim=64,
                     vocal_num_heads=4, text_len=16, clip_tokens=5, clip_dim=32, text_dim=32,
                     audio_in_dim=16)


def _step_batch():
    rng = np.random.default_rng(0)
    b, f, h, w = 1, 3, 8, 8
    return {
        "latents": rng.standard_normal((b, 16, f, h, w)).astype(np.float32),
        "inpaint_latents": rng.standard_normal((b, 20, f, h, w)).astype(np.float32),
        "prompt_embeds": rng.standard_normal((b, 16, 32)).astype(np.float32),
        "clip_fea": rng.standard_normal((b, 5, 32)).astype(np.float32),
        "vocal_embeddings": rng.standard_normal((b, 20, 16)).astype(np.float32),
        "face_masks": rng.uniform(0, 1, (b, 1, f, h, w)).astype(np.float32),
        "lip_masks": rng.uniform(0, 1, (b, 1, f, h, w)).astype(np.float32),
    }


def _jax_step_grads(params, batch, key, clip_level, f32_flash):
    """The JAX train step (jitted) with a transform that hands its gradients
    to the host and changes nothing; fp32 flash runs the step's bf16 cast as
    fp32 and every attention call through Pallas K1/K4 in interpret mode."""
    captured = {}

    def update(grads, state, params=None):
        jax.debug.callback(lambda g: captured.update(g=g), grads)
        return jax.tree.map(jnp.zeros_like, grads), state

    tx = optax.GradientTransformation(lambda p: (), update)
    step = jax.jit(lambda p, b, k: jtrainer.train_step(
        p, (), b, k, 0, clip_level, dit_cfg=STEP_CFG, train_cfg=jtrainer.TrainConfig(
            remat=False, video_sample_n_frames=9), tx=tx,
        sigmas_table=jtrainer.train_sigmas())[2])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if f32_flash:
        f32 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                       if not k.startswith("__")})
        f32.bfloat16 = jnp.float32
        with pallas_interpret(), mock.patch.object(jtrainer, "jnp", f32), mock.patch(
                "stableavatar_tpu.ops.attention._use_pallas", lambda q, k: True):
            metrics = step(params, jbatch, key)
    else:
        metrics = step(params, jbatch, key)
    jax.effects_barrier()
    return metrics, captured["g"]


# Measured (CPU): fp32 flash route loss 5e-7 / gradients 4e-7 rel; the real
# bf16 step (XLA attention against the port's short-query path) loss 1.0e-4
# / gradients 6.1e-3 rel-L2: XLA fuses bf16 elementwise chains with excess
# precision under jit, the port rounds after every op (ROADMAP queue 3).
STEP_TOL = {"f32_flash": (1e-4, 1e-4), "bf16": (3e-4, 1.5e-2)}


@pytest.mark.parametrize("mode,clip_level", [("f32_flash", False), ("f32_flash", True),
                                             ("bf16", False)])
def test_train_step_matches_jax(mode, clip_level):
    f32_flash = mode == "f32_flash"
    jparams = densify_dit(jdit.init_dit(jax.random.PRNGKey(0), STEP_CFG))
    batch = _step_batch()
    key = jax.random.PRNGKey(5)
    metrics, jgrads = _jax_step_grads(jparams, batch, key, clip_level, f32_flash)
    # the JAX step's draws, recomputed from its key
    k_noise, k_t, k_mask = jax.random.split(key, 3)
    draws = {"noise": t(jax.random.normal(k_noise, batch["latents"].shape, jnp.float32)),
             "idx": t(jlosses.sample_timestep_indices(k_t, 1, 1000)).long(),
             "mask_flag": t(jax.random.uniform(k_mask, ()))}
    captured = {}

    def update(grads, state, params=None):
        captured["g"] = [g.clone() for g in grads]
        return [torch.zeros_like(g) for g in grads], state

    tparams = dit_from_jax(to_numpy_tree(jparams))
    with mock.patch("stableavatar_tpu_torch.ops.attention._use_flash", lambda q: f32_flash), \
            mock.patch.object(ttrainer, "DIT_DTYPE",
                              torch.float32 if f32_flash else torch.bfloat16):
        _, _, tm = ttrainer.train_step(
            tparams, {}, {k: t(v) for k, v in batch.items()}, None, clip_level,
            dit_cfg=STEP_CFG, train_cfg=ttrainer.TrainConfig(video_sample_n_frames=9),
            tx=optim.GradientTransformation(lambda p: {}, update),
            sigmas_table=ttrainer.train_sigmas(device="cpu"), draws=draws)
    loss_tol, grad_tol = STEP_TOL[mode]
    assert abs(float(tm["loss"]) - float(metrics["loss"])) <= loss_tol * abs(float(metrics["loss"]))
    want = np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in tree_leaves(dit_from_jax(to_numpy_tree(jgrads)))])
    got = np.concatenate([g.float().numpy().ravel() for g in captured["g"]])
    assert rel_l2(got, want) < grad_tol
    np.testing.assert_allclose(float(tm["grad_norm"]), float(metrics["grad_norm"]),
                               rtol=grad_tol)


def test_train_step_updates_parameters_in_place():
    params = dit_from_jax(to_numpy_tree(densify_dit(jdit.init_dit(jax.random.PRNGKey(0),
                                                                  STEP_CFG))))
    tc = ttrainer.TrainConfig(video_sample_n_frames=9, learning_rate=1e-3)
    tx = ttrainer.make_optimizer(tc)
    leaves = tree_leaves(params)
    state = tx.init(leaves)
    before = [p.clone() for p in leaves]
    gen = torch.Generator().manual_seed(0)
    _, state, m = ttrainer.train_step(params, state, {k: t(v) for k, v in _step_batch().items()},
                                      gen, dit_cfg=STEP_CFG, train_cfg=tc, tx=tx,
                                      sigmas_table=ttrainer.train_sigmas(device="cpu"))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert all(not p.requires_grad for p in leaves)
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves))


# ---------------------------------------------------------------------------
# encode_batch, checkpoints, the loop (tiny stack of tests/test_train_loop.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_models():
    from stableavatar_tpu.models.clip import init_clip_visual
    from stableavatar_tpu.models.vae import init_vae
    from stableavatar_tpu.models.wav2vec import init_wav2vec2

    ks = jax.random.split(jax.random.PRNGKey(7), 5)
    return dict(dit=jit_init(jdit.init_dit, DIT_E2E, ks[0]),
                vae=jit_init(init_vae, VAE_E2E, ks[1]),
                clip=jit_init(init_clip_visual, CLIP_E2E, ks[3]),
                w2v=jit_init(init_wav2vec2, W2V_E2E, ks[4]))


def _port_models(jm):
    from stableavatar_tpu_torch.pipelines.common import WanModels

    return WanModels(
        dit_params=dit_from_jax(to_numpy_tree(jm["dit"])), dit_cfg=DIT_E2E,
        vae_params=from_jax_tree(to_numpy_tree(jm["vae"])), vae_cfg=VAE_E2E,
        clip_params=from_jax_tree(to_numpy_tree(jm["clip"])), clip_cfg=CLIP_E2E,
        wav2vec_params=from_jax_tree(to_numpy_tree(jm["w2v"])), wav2vec_cfg=W2V_E2E,
        device="cpu")


def _raw_batches(n, b=1, frames=9, size=32, all_ones_row=False):
    rng = np.random.default_rng(0)
    for _ in range(n):
        pixels = rng.uniform(-1, 1, (b, 3, frames, size, size)).astype(np.float32)
        masks = np.zeros((b, frames, 1, size, size), np.float32)
        masks[:, 1:] = 1.0
        if all_ones_row:
            masks[0] = 1.0
        yield {
            "pixel_values": pixels,
            "masked_pixel_values": pixels * (1 - masks.transpose(0, 2, 1, 3, 4)),
            "pixel_value_masks": masks,
            "reference_image": pixels[:, :, 0:1],
            "tgt_face_masks": rng.uniform(0, 1, (b, 1, frames, size, size)).astype(np.float32),
            "tgt_lip_masks": np.ones((b, 1, frames, size, size), np.float32),
            "vocal_input_values": rng.standard_normal((b, frames * 640)).astype(np.float32) * 0.1,
            "prompt_embeds": rng.standard_normal((b, DIT_E2E.text_len, DIT_E2E.text_dim)
                                                 ).astype(np.float32),
        }


def _byte_tokenizer(text):
    """ids and mask of T5_E2E's context: the prompt's bytes folded into the
    tiny vocabulary, zero-padded (the same numpy arrays for both sides)."""
    raw = np.frombuffer(text.encode(), np.uint8)[:T5_E2E.text_len].astype(np.int32)
    ids = np.zeros(T5_E2E.text_len, np.int32)
    ids[:raw.size] = raw % (T5_E2E.vocab - 1) + 1
    return ids, (ids > 0).astype(np.int32)


@pytest.mark.parametrize("seed,tokenized", [pytest.param(0, False, id="0"),
                                            pytest.param(3, False, id="3"),
                                            pytest.param(0, True, id="0-tokenizer")])
def test_encode_batch_matches_jax(jax_models, seed, tokenized):
    """Same batch, same host draws (a copy of the rng), the JAX VAE noise
    handed to the port: every output agrees (fp32 encoders).  With a
    tokenizer both sides encode the batch's `text_prompt` through the tiny
    umT5 instead of taking `prompt_embeds`."""
    from stableavatar_tpu.models.t5 import init_t5
    from stableavatar_tpu.pipelines.common import WanModels as JaxModels
    from stableavatar_tpu.train.loop import encode_batch as jencode
    from stableavatar_tpu_torch.train.loop import encode_batch as tencode

    t5 = {}
    if tokenized:
        t5 = dict(t5_params=jit_init(init_t5, T5_E2E, jax.random.PRNGKey(11)), t5_cfg=T5_E2E,
                  tokenizer=_byte_tokenizer)
    jm = JaxModels(dit_params=jax_models["dit"], dit_cfg=DIT_E2E, vae_params=jax_models["vae"],
                   vae_cfg=VAE_E2E, clip_params=jax_models["clip"], clip_cfg=CLIP_E2E,
                   wav2vec_params=jax_models["w2v"], wav2vec_cfg=W2V_E2E, **t5)
    batch = next(_raw_batches(1, b=2, all_ones_row=True))
    if tokenized:
        batch["text_prompt"] = ["A person is talking.", "a close-up of a singer"]
        del batch["prompt_embeds"]
    want = jencode(jm, batch, np.random.default_rng(seed), t2v_zero_prob=0.5,
                   audio_dropout_prob=0.5)
    # the JAX VAE noise: keys from the rng's first draw, drawn channels-last
    k_lat, k_msk = jax.random.split(
        jax.random.PRNGKey(int(np.random.default_rng(seed).integers(2 ** 31))), 2)
    shape = want["latents"].shape
    cl = (shape[0], shape[2], shape[3], shape[4], shape[1])
    noise = tuple(t(jnp.transpose(jax.random.normal(k, cl), (0, 4, 1, 2, 3)))
                  for k in (k_lat, k_msk))
    tm = _port_models(jax_models)
    if tokenized:
        tm = dataclasses.replace(tm, t5_params=t5_from_jax(to_numpy_tree(t5["t5_params"])),
                                 t5_cfg=T5_E2E, tokenizer=_byte_tokenizer)
    got = tencode(tm, batch, np.random.default_rng(seed),
                  t2v_zero_prob=0.5, audio_dropout_prob=0.5, vae_noise=noise)
    assert got.pop("is_clip_level_modeling") == want.pop("is_clip_level_modeling")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_resize_matches_jax_image_resize():
    from stableavatar_tpu_torch.train.loop import resize_linear

    x = np.random.default_rng(2).uniform(0, 1, (2, 4, 9, 33, 20)).astype(np.float32)
    for shape in ((2, 4, 3, 8, 5), (2, 4, 9, 11, 40), (2, 1, 3, 33, 7)):
        src = x[:, : shape[1]]
        want = jax.image.resize(jnp.asarray(src), shape, method="linear")
        np.testing.assert_allclose(resize_linear(t(src), shape).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_checkpoint_manager_rotation_tmp_and_resume(tmp_path):
    from stableavatar_tpu_torch.train.loop import CheckpointManager

    cm = CheckpointManager(str(tmp_path), total_limit=2)
    params = {"w": torch.arange(4.0), "blocks": [{"b": torch.ones(2)}]}
    opt = [{"count": torch.zeros((), dtype=torch.int32), "mu": [torch.zeros(4)]}]
    for step in (10, 20, 30):
        cm.save(step, {"w": params["w"] + step, "blocks": params["blocks"]}, opt)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-20", "checkpoint-30"]
    # an unfinished write is never resumed from, and is left for the next run
    os.makedirs(tmp_path / "checkpoint-40.tmp-1")
    assert cm.latest().endswith("checkpoint-30")
    restored = cm.restore(device="cpu")
    assert restored["step"] == 30
    assert torch.equal(restored["params"]["w"], torch.arange(4.0) + 30)
    assert torch.equal(restored["params"]["blocks"][0]["b"], torch.ones(2))
    assert restored["opt_state"][0]["count"].dtype == torch.int32
    # asynchronous saves: host copy first, write on a thread, joined by wait()
    w = torch.zeros(3)
    cm.save(50, {"w": w}, opt, wait=False)
    w += 7  # the step updates the parameters in place while the save runs
    cm.save(60, {"w": w}, opt, wait=False)
    cm.wait()
    assert sorted(d for d in os.listdir(tmp_path) if "tmp" not in d) == [
        "checkpoint-50", "checkpoint-60"]
    assert torch.equal(torch.load(tmp_path / "checkpoint-50" / "state.pt")["params"]["w"],
                       torch.zeros(3))
    assert cm.restore(device="cpu")["step"] == 60


def test_train_loop_end_to_end_and_resume(jax_models, tmp_path):
    """train() on the tiny stack: 3 steps with rotation and metrics; then a
    SIGTERM during step 2 of a new run saves checkpoint-2, and a resumed run
    continues at step 3."""
    from stableavatar_tpu_torch.train.loop import log_validation, train

    tc = ttrainer.TrainConfig(video_sample_n_frames=9, learning_rate=1e-4)
    out_dir = str(tmp_path / "run")
    models = _port_models(jax_models)
    seen = []
    params, opt_state, history = train(
        models, _raw_batches(4), tc, output_dir=out_dir, max_train_steps=3,
        checkpointing_steps=2, checkpoints_total_limit=1, resume_from_checkpoint=None,
        log_every=1, step_callback=lambda s, p, m: seen.append((s, m["is_clip_level_modeling"])))
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert [s for s, _ in seen] == [1, 2, 3]
    assert [d for d in os.listdir(out_dir) if d.startswith("checkpoint-")] == ["checkpoint-2"]
    assert any(f.endswith(".metrics.jsonl") for f in os.listdir(out_dir))
    assert models.dit_params is params

    run2 = str(tmp_path / "preempt")

    def batches_with_preemption(n, kill_at):
        for i, b in enumerate(_raw_batches(n)):
            if i == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    train(_port_models(jax_models), batches_with_preemption(5, kill_at=1), tc,
          output_dir=run2, max_train_steps=5, checkpointing_steps=100, log_every=1,
          resume_from_checkpoint=None)
    assert [d for d in os.listdir(run2) if d.startswith("checkpoint-")] == ["checkpoint-2"]
    _, _, history = train(_port_models(jax_models), _raw_batches(5), tc, output_dir=run2,
                          max_train_steps=4, checkpointing_steps=100, log_every=1,
                          resume_from_checkpoint="latest")
    assert [h["step"] for h in history] == [3, 4]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, open item 1"):
        log_validation(models, {}, out_dir, 1)
