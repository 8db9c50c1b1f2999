"""The port's ops, quantisation and schedule against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stableavatar_tpu.ops import embeddings as jemb
from stableavatar_tpu.ops import norms as jnorms
from stableavatar_tpu.ops import rope as jrope
from stableavatar_tpu.schedulers import flow_match as jfm
from stableavatar_tpu.utils import quantization as jquant
from stableavatar_tpu_torch.ops import embeddings as temb
from stableavatar_tpu_torch.ops import norms as tnorms
from stableavatar_tpu_torch.ops import rope as trope
from stableavatar_tpu_torch.schedulers import flow_match as tfm
from stableavatar_tpu_torch.utils import quantization as tquant
from stableavatar_tpu_torch.models import vocal_projector as tvp
from stableavatar_tpu.models import vocal_projector as jvp
from tests.torch_parity import rel_l2, t

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_rms_norm(weighted):
    x, w = _x((2, 7, 48)), _x((48,), 1) if weighted else None
    want = jnorms.rms_norm(jnp.asarray(x), None if w is None else jnp.asarray(w), eps=1e-6)
    got = tnorms.rms_norm(t(x), None if w is None else t(w), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm(affine):
    x = _x((2, 7, 48)) * 3 + 1
    w, b = (_x((48,), 1), _x((48,), 2)) if affine else (None, None)
    want = jnorms.layer_norm(jnp.asarray(x), *(None if a is None else jnp.asarray(a) for a in (w, b)))
    got = tnorms.layer_norm(t(x), *(None if a is None else t(a) for a in (w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_bf16_casts_back():
    x = _x((4, 32))
    got = tnorms.layer_norm(t(x, torch.bfloat16))
    want = jnorms.layer_norm(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


def test_sinusoidal_embedding():
    pos = np.array([0.0, 1.0, 37.5, 999.0], np.float32)
    want = jemb.sinusoidal_embedding_1d(256, jnp.asarray(pos))
    got = temb.sinusoidal_embedding_1d(256, t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("riflex", [None, (2, 66, None), (3, 66, 4.886)])
def test_rope_freqs_and_apply(riflex):
    kw = {} if riflex is None else dict(riflex_k=riflex[0], riflex_L_test=riflex[1],
                                        riflex_scale=riflex[2])
    grid, d = (4, 3, 2), 24
    jf = jrope.rope_freqs_3d(grid, d, **kw)
    tf = trope.rope_freqs_3d(grid, d, **kw)
    np.testing.assert_allclose(tf.cos.numpy(), np.asarray(jf.cos), **TOL)
    np.testing.assert_allclose(tf.sin.numpy(), np.asarray(jf.sin), **TOL)
    x = _x((2, 24, 3, d))
    np.testing.assert_allclose(trope.rope_apply(t(x), tf).numpy(),
                               np.asarray(jrope.rope_apply(jnp.asarray(x), jf)), **TOL)
    packed = trope.pack_split(tf)
    np.testing.assert_allclose(packed.numpy(), np.asarray(jrope.pack_split(jf)), **TOL)
    np.testing.assert_allclose(trope.rope_apply_split(t(x), packed).numpy(),
                               np.asarray(jrope.rope_apply_split(jnp.asarray(x), jrope.pack_split(jf))),
                               **TOL)
    np.testing.assert_array_equal(trope.split_pair_permutation(d, 3),
                                  jrope.split_pair_permutation(d, 3))


@pytest.mark.parametrize("steps,shift", [(50, 5.0), (2, 5.0), (25, 3.0)])
def test_flow_match_sigmas(steps, shift):
    js = jfm.flow_match_timesteps(steps, shift=shift)
    ts = tfm.flow_match_timesteps(steps, shift=shift)
    np.testing.assert_allclose(ts.sigmas, np.asarray(js.sigmas), **TOL)
    np.testing.assert_allclose(ts.timesteps, np.asarray(js.timesteps), **TOL)
    assert ts.num_steps == js.num_steps


def test_int8_linear_matches_jax():
    """W8A8: the port's [d_out, d_in] weights are the JAX [d_in, d_out]
    transposed; the int8 operands are bit-identical, so the products agree
    to fp32 rounding."""
    w, x, b = _x((48, 40), 3), _x((5, 7, 48), 4), _x((40,), 5)
    jw8 = jquant.quantize_weight_for_compute(jnp.asarray(w))
    tw8 = tquant.quantize_weight_for_compute(t(w.T))
    np.testing.assert_array_equal(tw8["q"].numpy(), np.asarray(jw8["q"]).T)
    np.testing.assert_array_equal(tw8["s"].numpy(), np.asarray(jw8["s"]))
    want = np.asarray(jquant.int8_linear(jnp.asarray(x), jw8, jnp.asarray(b)))
    got = tquant.int8_linear(t(x), tw8, t(b)).numpy()
    assert rel_l2(got, want) < 1e-3


def test_storage_quant_roundtrip_matches_jax():
    w = _x((48, 40), 6)
    jq = jquant.quantize_weight(jnp.asarray(w))
    tq = tquant.quantize_weight(t(w.T))
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]).T)
    np.testing.assert_allclose(tquant.dequantize_weight(tq, torch.float32).numpy(),
                               np.asarray(jquant.dequantize_weight(jq, jnp.float32)).T, **TOL)


@pytest.mark.parametrize("form", ["w", "store", "w8"])
def test_apply_linear_dispatch(form):
    w, x, b = _x((32, 24), 7), _x((3, 32), 8), _x((24,), 9)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = {"w": t(w.T), "b": t(b)}
    if form == "store":
        jp["w"], tp["w"] = jquant.quantize_weight(jp["w"]), tquant.quantize_weight(tp["w"])
    elif form == "w8":
        jp = {"w8": jquant.quantize_weight_for_compute(jp.pop("w")), "b": jp["b"]}
        tp = {"w8": tquant.quantize_weight_for_compute(tp.pop("w")), "b": tp["b"]}
    want = np.asarray(jvp.apply_linear(jp, jnp.asarray(x)))
    got = tvp.apply_linear(tp, t(x)).numpy()
    assert rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("audio_len,frames", [(161, 81), (40, 17), (100, 45), (7, 9)])
def test_window_plan_matches_jax(audio_len, frames):
    assert tvp.split_audio_sequence(audio_len, frames) == jvp.split_audio_sequence(audio_len, frames)
    for a, b in zip(tvp.window_plan(audio_len, frames), jvp.window_plan(audio_len, frames)):
        np.testing.assert_array_equal(a, b)
