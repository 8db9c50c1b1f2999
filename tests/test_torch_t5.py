"""The port's umT5 encoder (`models/t5.py`, `ops/norms.py:t5_rms_norm`) and
prompt encoding (`pipelines/common.py:encode_prompts`) against the JAX
package's, weights through the bridge (`utils/weights.py:t5_from_jax`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stableavatar_tpu.cli.inference import build_tokenizer as jbuild_tokenizer
from stableavatar_tpu.config import T5Config, tiny_debug_configs
from stableavatar_tpu.models import t5 as jt5
from stableavatar_tpu.models.dit import cast_params
from stableavatar_tpu.ops.norms import t5_rms_norm as jt5_rms_norm
from stableavatar_tpu.pipelines import common as jcommon
from stableavatar_tpu_torch.cli.inference import build_parser, build_tokenizer
from stableavatar_tpu_torch.models import t5 as tt5
from stableavatar_tpu_torch.ops.norms import t5_rms_norm
from stableavatar_tpu_torch.pipelines import common as tcommon
from stableavatar_tpu_torch.utils.weights import t5_from_jax
from tests.torch_parity import t, to_numpy_tree

# the JAX package's T5 test config (tests/test_encoders.py:205)
CFG = T5Config(vocab=50, dim=24, dim_attn=24, dim_ffn=48, num_heads=4, num_layers=2,
               text_len=10, shared_pos=False)
IDS = np.array([[3, 7, 11, 2, 1, 0, 0, 0, 0, 0], [5, 9, 1, 0, 0, 0, 0, 0, 0, 0]], np.int32)
MASK = (np.arange(10)[None] < np.array([[5], [3]])).astype(np.int32)


@pytest.mark.parametrize("lq,lk,nb,md", [(10, 10, 32, 128), (512, 512, 32, 128),
                                         (7, 300, 16, 64), (300, 7, 32, 20)])
def test_relative_position_buckets_equal(lq, lk, nb, md):
    np.testing.assert_array_equal(tt5.relative_position_buckets(lq, lk, nb, md),
                                  jt5.relative_position_buckets(lq, lk, nb, md))


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_t5_rms_norm_matches_jax(dtype, jdtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    w = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    want = np.asarray(jt5_rms_norm(jnp.asarray(x, jdtype), jnp.asarray(w, jdtype)), np.float32)
    got = t5_rms_norm(t(x, dtype), t(w, dtype))
    assert got.dtype == dtype
    # bf16 bit for bit; fp32 to an ulp (rsqrt implementations differ)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6 if dtype == torch.float32
                               else 0, atol=0)


@pytest.mark.parametrize("shared_pos", [False, True])
def test_t5_encode_f32_matches_jax(shared_pos):
    """fp32 at the JAX package's T5 tolerance (tests/test_encoders.py:245)."""
    cfg = dataclasses.replace(CFG, shared_pos=shared_pos)
    params = jt5.init_t5(jax.random.PRNGKey(1), cfg)
    want = np.asarray(jt5.t5_encode(params, cfg, jnp.asarray(IDS), jnp.asarray(MASK)))
    tp = t5_from_jax(to_numpy_tree(params))
    with torch.no_grad():
        got = tt5.t5_encode(tp, cfg, t(IDS), t(MASK)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_t5_encode_bf16_matches_jax():
    """bf16 weights and activations: the port rounds where JAX's eager ops
    round, so it equals the JAX encoder run op by op bit for bit (under jit
    XLA fuses the bf16 chains: 6.4e-3 rel-L2 from either, my CPU run)."""
    params = cast_params(jt5.init_t5(jax.random.PRNGKey(2), CFG), jnp.bfloat16)
    want = np.asarray(jt5.t5_encode(params, CFG, jnp.asarray(IDS), jnp.asarray(MASK)),
                      np.float32)
    tp = t5_from_jax(to_numpy_tree(params))
    assert tp["blocks"][0]["attn"]["q"]["w"].dtype == torch.bfloat16
    with torch.no_grad():
        got = tt5.t5_encode(tp, CFG, t(IDS), t(MASK))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bridge_matches_port_init_structure():
    from tests.test_torch_package import _shapes

    shapes = jax.eval_shape(lambda k: jt5.init_t5(k, CFG), jax.random.PRNGKey(0))
    bridged = t5_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = tt5.init_t5(torch.Generator().manual_seed(0), CFG, device="cpu")
    assert _shapes(bridged) == _shapes(port)
    assert port["blocks"][0]["attn"]["q"]["w"].shape == (CFG.dim_attn, CFG.dim)


def test_encode_prompts_matches_jax():
    """The [neg, neg, pos] CFG stack with the padding zeroed, fp32."""
    cfg = tiny_debug_configs()[2]
    params = jt5.init_t5(jax.random.PRNGKey(3), cfg)
    args = build_parser().parse_args([])
    jm = jcommon.WanModels(dit_params=None, dit_cfg=None, vae_params=None, t5_params=params,
                           t5_cfg=cfg, tokenizer=jbuild_tokenizer(args, None, cfg))
    want = np.asarray(jcommon.encode_prompts(jm, "A person is talking", "blurry"))
    tm = tcommon.WanModels(dit_params=None, dit_cfg=None, vae_params=None,
                           t5_params=t5_from_jax(to_numpy_tree(params)), t5_cfg=cfg,
                           tokenizer=build_tokenizer(args, None, cfg), device="cpu")
    got = tcommon.encode_prompts(tm, "A person is talking", "blurry").numpy()
    assert got.shape == (3, cfg.text_len, cfg.dim)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got[0], got[1])
    _, mask = tm.tokenizer("blurry")
    assert not got[0][mask == 0].any()
