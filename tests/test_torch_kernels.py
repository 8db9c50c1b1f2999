"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (`_flash_fwd_plain`,
`_flash_int8_plain`, `_flash_bwd_plain`, `_dual_plain`); the JAX kernels run
in Pallas interpret mode.  Shapes follow tests/test_ops.py:197 and :240,
tests/test_fastpath.py:121 (k_lens [300, 384], blocks of 128) and the
padding cases of tests/test_cross_attention.py.  The CUDA kernels themselves are checked
against the same plain versions on the card (`chip_smoke.py` and
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stableavatar_tpu.ops import cross_attention as jca
from stableavatar_tpu.ops import flash_attention as jfa
from stableavatar_tpu.ops.rope import pack_split as jpack, rope_freqs_3d as jfreqs
from stableavatar_tpu_torch.ops import cross_attention as tca
from stableavatar_tpu_torch.ops import flash_attention as tfa
from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d
from tests.torch_parity import pallas_interpret, rel_l2, t


def _qkv(seed, b=2, lq=256, lk=384, n=2, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, n, d)).astype(np.float32),
            rng.standard_normal((b, lk, n, d)).astype(np.float32),
            rng.standard_normal((b, lk, n, d)).astype(np.float32))


K_LENS = np.array([300, 384], np.int32)


def test_k1_plain_matches_pallas():
    q, k, v = _qkv(6)
    with pallas_interpret():
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   k_lens=jnp.asarray(K_LENS), block_q=128, block_k=128)
    got = tfa.flash_attention(t(q), t(k), t(v), k_lens=t(K_LENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant,rope", [("qk", False), ("qk", True), ("qkv", False),
                                        ("qkpv", False)])
def test_k2_plain_matches_pallas(quant, rope):
    """Same int8 operands on both sides (the prep is bit-identical), so the
    only difference is fp32 summation order."""
    q, k, v = _qkv(3, lq=384)
    jrope = trope = None
    if rope:
        freqs = jfreqs((6, 8, 8), 64)
        jrope = jpack(freqs)
        trope = pack_split(rope_freqs_3d((6, 8, 8), 64))
    with pallas_interpret():
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   k_lens=jnp.asarray(K_LENS), quant=quant, rope=jrope,
                                   block_q=128, block_k=128, static_max=False)
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), trope, 64 ** -0.5)
    v_in, sv = t(v), None
    if quant != "qk":
        v_in, sv = tfa.quantize_v(v_in)
    got = tfa._flash_int8_plain(q8, k8, v_in, sqk, t(K_LENS), quant=quant, sv=sv,
                                block_k=128, out_dtype=torch.float32).numpy()
    want = np.asarray(want)
    assert rel_l2(got, want) < 1e-3
    assert np.max(np.abs(got - want)) < 1e-2


def test_k2_prep_matches_jax():
    """Rope + slab quantisation are bit-identical to the JAX prep."""
    q, k, _ = _qkv(4, lq=384)
    freqs = jfreqs((6, 8, 8), 64)
    jq8, jsq = jfa._quant_slab(jnp.asarray(q))
    q8, sq = tfa._quant_slab(t(q))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq))
    from stableavatar_tpu.ops.rope import rope_apply_split as jrs

    want = np.asarray(jrs(jnp.asarray(k), jpack(freqs)))
    from stableavatar_tpu_torch.ops.rope import rope_apply_split

    got = rope_apply_split(t(k), pack_split(rope_freqs_3d((6, 8, 8), 64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_flash_wrapper_routes_cpu_to_plain():
    q, k, v = _qkv(5, lq=64, lk=64)
    got = tfa.flash_attention(t(q), t(k), t(v), quant="qk")
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), None, 64 ** -0.5)
    want = tfa._flash_int8_plain(q8, k8, t(v), sqk)
    assert torch.equal(got, want)
    qg = t(q).requires_grad_()
    tfa.flash_attention(qg, t(k), t(v)).sum().backward()
    assert qg.grad is not None
    assert set(tfa.launch_counts) == {"flash_fwd_bf16", "flash_fwd_bf16_lse", "flash_fwd_int8_qk",
                                      "flash_bwd_dkdv", "flash_bwd_dq"}
    assert not any(tfa.launch_counts.values())


def test_k1_lse_matches_pallas_with_stats():
    """K1's natural-log LSE [B, Lq, N] against the Pallas kernel's, fp32."""
    q, k, v = _qkv(9)
    with pallas_interpret():
        want_out, want_lse = jfa.flash_attention_with_stats(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), k_lens=jnp.asarray(K_LENS),
            block_q=128, block_k=128)
    out, lse = tfa.flash_attention_with_stats(t(q), t(k), t(v), k_lens=t(K_LENS))
    assert lse.shape == (2, 256, 2) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("lq,lk,k_lens,d", [
    (256, 256, [200], 64),   # self-attention with ragged keys (tests/test_ops.py:240)
    (256, 256, [200], 128),
    (512, 77, None, 64),     # cross-attention: text-like and image-like contexts
    (512, 33, None, 128),
])
def test_k4_plain_matches_pallas_vjp(lq, lk, k_lens, d):
    """The port's backward (K4's plain version, reached through the
    autograd Function) against `jax.vjp` of the Pallas flash attention,
    whose backward kernels run in interpret mode."""
    rng = np.random.default_rng(7)
    b, n = 1, 2
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, lq, n, d), (b, lk, n, d), (b, lk, n, d)))
    g = rng.standard_normal((b, lq, n, d)).astype(np.float32)
    kl = None if k_lens is None else np.array(k_lens, np.int32)
    with pallas_interpret():
        out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
            q, k, v, k_lens=None if kl is None else jnp.asarray(kl), block_q=128, block_k=128),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    got_out = tfa.flash_attention(qt, kt, vt, k_lens=None if kl is None else t(kl))
    got_out.backward(t(g))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=2e-4, atol=2e-4)
    for name, a, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3, err_msg=name)


def test_flash_function_gradcheck():
    """The autograd Function (plain forward with LSE, plain K4) in float64
    against finite differences, ragged keys included."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((2, 9, 2, 4), (2, 7, 2, 4), (2, 7, 2, 4)))
    kl = torch.tensor([5, 7], dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda q, k, v: tfa.flash_attention(q, k, v, k_lens=kl),
                                    (q, k, v))


def test_int8_flash_refuses_grad():
    q, k, v = _qkv(5, lq=64, lk=64)
    with pytest.raises(ValueError, match="not differentiable"):
        tfa.flash_attention(t(q).requires_grad_(), t(k), t(v), quant="qk")
    with pytest.raises(NotImplementedError, match="LSE"):
        tfa.flash_attention_with_stats(t(q), t(k), t(v), quant="qk")


def _mk(b=2, lq=256, l1=96, l2=33, n=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(b, lq, n, d), (b, l1, n, d), (b, l1, n, d), (b, l2, n, d), (b, l2, n, d)]]


@pytest.mark.parametrize("case", ["both_padded", "ragged_q", "lane_aligned"])
def test_k5_plain_matches_pallas_f32(case):
    kw = {"both_padded": dict(), "ragged_q": dict(lq=200),
          "lane_aligned": dict(l1=128, l2=128, seed=3)}[case]
    arrs = _mk(**kw)
    want = jca.dual_context_attention(*map(jnp.asarray, arrs), block_q=128, interpret=True)
    got = tca.dual_context_attention(*map(t, arrs))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_k5_plain_matches_pallas_bf16():
    arrs = _mk(seed=7)
    want = jca.dual_context_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                                      block_q=128, interpret=True)
    got = tca.dual_context_attention(*(t(a, torch.bfloat16) for a in arrs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)

