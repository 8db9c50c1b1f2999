"""DiT parity: the port's dit_forward against the JAX package's on the tiny
config of tests/test_fastpath.py, weights through the bridge."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from stableavatar_tpu.config import DiTConfig
from stableavatar_tpu.models import dit as jdit
from stableavatar_tpu.utils import fastpath as jfast
from stableavatar_tpu_torch.models import dit as tdit
from stableavatar_tpu_torch.utils import fastpath as tfast
from stableavatar_tpu_torch.utils.tree import tree_leaves
from stableavatar_tpu_torch.utils.weights import dit_from_jax
from tests.torch_parity import (densify_dit, int8_activation_flips, pallas_interpret, rel_l2, t,
                                to_numpy_tree)

CFG = DiTConfig(dim=64, ffn_dim=128, num_heads=4, num_layers=2,
                audio_proj_dim=64, vocal_num_heads=4)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    b, f, lh, lw, la = 2, 5, 4, 4, 40
    return (
        rng.standard_normal((b, 16, f, lh, lw)).astype(np.float32),
        np.full((b,), 500.0, np.float32),
        rng.standard_normal((b, CFG.text_len, CFG.text_dim)).astype(np.float32),
        rng.standard_normal((b, CFG.clip_tokens, CFG.clip_dim)).astype(np.float32),
        rng.standard_normal((b, 20, f, lh, lw)).astype(np.float32),
        rng.standard_normal((b, la, CFG.audio_in_dim)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_params():
    return densify_dit(jdit.init_dit(jax.random.PRNGKey(0), CFG))


@pytest.mark.parametrize("honor", [True, False])
def test_dit_forward_f32_matches_jax(jax_params, honor):
    inputs = _inputs(7)
    want = np.asarray(jdit.dit_forward(
        jax_params, CFG, *map(jax.numpy.asarray, inputs), video_sample_n_frames=17,
        honor_vocal_k_lens=honor))
    params = dit_from_jax(to_numpy_tree(jax_params))
    with torch.no_grad():
        got = tdit.dit_forward(params, CFG, *map(t, inputs), video_sample_n_frames=17,
                               honor_vocal_k_lens=honor).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_prepare_fast_params_matches_jax(jax_params):
    """The port's prepare_fast_params on bridged weights equals the bridge of
    the JAX-prepared tree: same permutation, bit-identical int8 weights."""
    want = dit_from_jax(to_numpy_tree(jfast.prepare_fast_params(jax_params, CFG, quant=True)))
    got = tfast.prepare_fast_params(dit_from_jax(to_numpy_tree(jax_params)), CFG, quant=True)
    for gb, wb in zip(got["blocks"], want["blocks"]):
        sa_g, sa_w = gb["self_attn"], wb["self_attn"]
        for name in ("q", "k", "v", "o"):
            assert torch.equal(sa_g[name]["w8"]["q"], sa_w[name]["w8"]["q"])
            assert torch.equal(sa_g[name]["w8"]["s"], sa_w[name]["w8"]["s"])
        for name in ("norm_q", "norm_k"):
            assert torch.equal(sa_g[name]["w"], sa_w[name]["w"])
        assert torch.equal(gb["ffn"]["fc2"]["w8"]["q"], wb["ffn"]["fc2"]["w8"]["q"])


@pytest.mark.parametrize("honor", [True, False])
def test_dit_fast_path_matches_jax(jax_params, honor):
    """rope_split + W8A8 linears + attn_quant="qk" (+ fused cross-attention),
    each side on its CPU dispatch (XLA / the port's short-query path)."""
    inputs = _inputs(8)
    fast_j = jfast.prepare_fast_params(jax_params, CFG, quant=True)
    kw = dict(video_sample_n_frames=17, rope_split=True, attn_quant="qk",
              honor_vocal_k_lens=honor)
    want = np.asarray(jdit.dit_forward(fast_j, CFG, *map(jax.numpy.asarray, inputs), **kw))
    fast_t = tfast.prepare_fast_params(dit_from_jax(to_numpy_tree(jax_params)), CFG, quant=True)
    with torch.no_grad():
        got = tdit.dit_forward(fast_t, CFG, *map(t, inputs), **kw).numpy()
    assert rel_l2(got, want) < 1e-3


@pytest.mark.parametrize("honor", [True, False])
def test_dit_fast_path_int8_linears_pair_up(jax_params, honor):
    """The fast path's W8A8 linears on both sides: the same calls on the same
    weights in the same order (paired by weight and input shape), with
    equal int8 activations up to rounding flips.  The flips are what
    `test_dit_fast_path_matches_jax` measures: where XLA's and torch's fp32
    matmuls sum in other orders, a few context activations land on the
    other side of a rounding boundary and the flips grow block by block
    (ROADMAP queue 3 has the counts)."""
    inputs = _inputs(8)
    kw = dict(video_sample_n_frames=17, rope_split=True, attn_quant="qk",
              honor_vocal_k_lens=honor)
    fast_j = jfast.prepare_fast_params(jax_params, CFG, quant=True)
    fast_t = tfast.prepare_fast_params(dit_from_jax(to_numpy_tree(jax_params)), CFG, quant=True)

    def port():
        with torch.no_grad():
            return tdit.dit_forward(fast_t, CFG, *map(t, inputs), **kw).numpy()

    (want, got), flips = int8_activation_flips(
        lambda: np.asarray(jdit.dit_forward(fast_j, CFG, *map(jax.numpy.asarray, inputs), **kw)),
        port)
    # per block: self q k v o, cross q k v o k_img v_img k_vocal v_vocal, fc1 fc2
    assert len(flips) == 14 * CFG.num_layers
    assert got.shape == want.shape and np.isfinite(got).all()
    # flips are rounding boundaries crossed, not a different computation:
    # under a tenth of any call's activations (5.6% at most on the CPU that
    # measured them)
    assert all(f <= n // 10 for _, f, n, _ in flips), flips


@pytest.mark.parametrize("attn_quant", ["none", "qk"])
def test_dit_flash_route_matches_jax(jax_params, attn_quant):
    """Every attention call of the forward through the flash path on both
    sides: Pallas K1/K2 in interpret mode against the port's plain K1/K2
    (rope_split weights, float linears so the int8 operands match exactly)."""
    inputs = _inputs(8)
    kw = dict(video_sample_n_frames=17, rope_split=True, attn_quant=attn_quant)
    fast_j = jfast.prepare_fast_params(jax_params, CFG, quant=False)
    with pallas_interpret(), mock.patch(
            "stableavatar_tpu.ops.attention._use_pallas", lambda q, k: True):
        want = np.asarray(jdit.dit_forward(fast_j, CFG, *map(jax.numpy.asarray, inputs), **kw))
    fast_t = tfast.prepare_fast_params(dit_from_jax(to_numpy_tree(jax_params)), CFG, quant=False)
    with torch.no_grad(), mock.patch(
            "stableavatar_tpu_torch.ops.attention._use_flash", lambda q: True):
        got = tdit.dit_forward(fast_t, CFG, *map(t, inputs), **kw).numpy()
    assert rel_l2(got, want) < 1e-5


def test_dit_forward_clip_level_matches_jax(jax_params):
    """Clip-level modeling: all windows' vocal tokens in one global
    cross-attention pass (the training path's 30% branch)."""
    inputs = _inputs(9)
    want = np.asarray(jdit.dit_forward(
        jax_params, CFG, *map(jax.numpy.asarray, inputs), video_sample_n_frames=17,
        is_clip_level_modeling=True))
    params = dit_from_jax(to_numpy_tree(jax_params))
    with torch.no_grad():
        got = tdit.dit_forward(params, CFG, *map(t, inputs), video_sample_n_frames=17,
                               is_clip_level_modeling=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["short", "flash"])
def test_remat_gradients_equal_plain(jax_params, route):
    """remat=True (each block under torch.utils.checkpoint, recomputed in
    the backward) gives exactly the gradients of remat=False, on the
    short-query path and through the flash autograd Function."""
    inputs = [t(a) for a in _inputs(10)]
    grads = []
    for remat in (False, True):
        params = dit_from_jax(to_numpy_tree(jax_params))
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with mock.patch("stableavatar_tpu_torch.ops.attention._use_flash",
                        lambda q: route == "flash"):
            out = tdit.dit_forward(params, CFG, *inputs, video_sample_n_frames=17,
                                   is_clip_level_modeling=True, remat=remat)
            grads.append(torch.autograd.grad(out.square().mean(), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert any(float(g.abs().max()) > 0 for g in grads[0])
