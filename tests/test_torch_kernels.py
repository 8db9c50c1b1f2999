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


# the wgmma kernel's tile edges (128 query rows, 128-key tiles): Lq 200, Lk
# 130 and 257, k_lens ending inside a tile and 0, D 64 and 128
EDGE_CASES = [(200, 130, 64, (77, 0)), (200, 257, 128, (0, 200)), (200, 257, 64, (131, 257))]


def _edge(quant, case):
    lq, lk, d, kl = case
    return f"{quant}-edge-lq{lq}-lk{lk}-d{d}-klens{kl[0]}_{kl[1]}"


def _edge_inputs(seed, case):
    """(q, k, v, k_lens) of an edge case; None: the shapes of tests/
    test_fastpath.py:121 with K_LENS"""
    if case is None:
        return (*_qkv(seed, lq=384), K_LENS)
    lq, lk, d, kl = case
    return (*_qkv(seed, lq=lq, lk=lk, d=d), np.array(kl, np.int32))


def _check_rows(got, want, k_lens, rel=1e-3, atol=1e-2):
    """got against want on the batches with a valid key; a batch with none
    is zero rows in the port (the JAX online kernels average V over their
    zero-padded key blocks there)."""
    live = k_lens > 0
    assert not np.any(got[~live])
    assert rel_l2(got[live], want[live]) < rel
    assert np.max(np.abs(got[live] - want[live])) < atol


@pytest.mark.parametrize("quant,rope,edge", [
    pytest.param("qk", False, None, id="qk-False"), pytest.param("qk", True, None, id="qk-True"),
    pytest.param("qkv", False, None, id="qkv-False"),
    pytest.param("qkpv", False, None, id="qkpv-False"),
    *(pytest.param(quant, False, e, id=_edge(quant, e))
      for quant in ("qk", "qkv", "qkpv") for e in EDGE_CASES)])
def test_k2_plain_matches_pallas(quant, rope, edge):
    """Same int8 operands on both sides (the prep is bit-identical), so the
    only difference is fp32 summation order; also at the wgmma kernel's tile
    edges, for every V path ("qkpv" on the JAX block of 128 on both
    sides)."""
    q, k, v, k_lens = _edge_inputs(3, edge)
    d = q.shape[-1]
    jrope = trope = None
    if rope:
        freqs = jfreqs((6, 8, 8), 64)
        jrope = jpack(freqs)
        trope = pack_split(rope_freqs_3d((6, 8, 8), 64))
    with pallas_interpret():
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   k_lens=jnp.asarray(k_lens), quant=quant, rope=jrope,
                                   block_q=128, block_k=128, static_max=False)
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), trope, d ** -0.5)
    v_in, sv = t(v), None
    if quant != "qk":
        v_in, sv = tfa.quantize_v(v_in)
    got = tfa._flash_int8_plain(q8, k8, v_in, sqk, t(k_lens), quant=quant, sv=sv,
                                block_k=128, out_dtype=torch.float32).numpy()
    _check_rows(got, np.asarray(want), k_lens)


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
    assert set(tfa.launch_counts) == {
        "flash_fwd_bf16", "flash_fwd_bf16_lse", "flash_fwd_int8_qk", "flash_fwd_int8_qkv",
        "flash_fwd_int8_qkpv", "flash_fwd_int8_qk_lse", "flash_fwd_int8_qkv_lse",
        "flash_fwd_int8_qkpv_lse", "flash_fwd_int8_static_qk", "flash_fwd_int8_static_qkv",
        "flash_bwd", "rope_rotate", "rope_finalize_bwd"}
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


ROPE_GRID = (4, 8, 8)  # 256 positions, tests/test_fastpath.py:57-112


@pytest.mark.parametrize("bn,lq,lk,want", [(12, 21504, 21504, 1), (12, 21504, 512, 11),
                                            (12, 21504, 257, 15), (2, 2048, 77, 32),
                                            (4, 3000, 3000, 6)])
def test_k4_query_splits(bn, lq, lk, want):
    """The fused K4 splits its query tiles only where the key blocks alone
    give fewer than two blocks per SM (132 on the H100): the self-attention
    shape runs unsplit, the cross-attention shapes (48 / 36 key blocks) about
    four blocks per SM, never more splits than query tiles."""
    assert tfa.bwd_splits(bn, lq, lk, 132) == want


@pytest.mark.parametrize("stats", [False, True])
def test_k1_rope_plain_matches_pallas(stats):
    """K1-rope: `flash_attention(rope=)` and `flash_attention_with_stats(
    rope=)` (plain K1 on the rotated q and k, fp32) against the Pallas
    kernel's in-kernel rotation, tests/test_fastpath.py:57-76's sizes."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 256, 2, 64)).astype(np.float32) for _ in range(3))
    jrope, trope = jpack(jfreqs(ROPE_GRID, 64)), pack_split(rope_freqs_3d(ROPE_GRID, 64))
    fn = "flash_attention_with_stats" if stats else "flash_attention"
    with pallas_interpret():
        want = getattr(jfa, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope=jrope,
                                block_q=128, block_k=128)
    got = getattr(tfa, fn)(t(q), t(k), t(v), rope=trope)
    for g, w in zip(got, want) if stats else [(got, want)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k_lens,d", [(None, 64), ([200], 128)])
def test_k4_rope_plain_matches_pallas_vjp(k_lens, d):
    """K4's rope branch: the port's backward with `rope=` (q and k rotated,
    dQ and dK inverse-rotated) against `jax.vjp` of the Pallas kernels'
    in-kernel rope (`_rot` / `_rot_inv`), tests/test_fastpath.py:79-112's
    sizes, gradients at 2e-3."""
    rng = np.random.default_rng(2)
    q, k, v, g = (rng.standard_normal((1, 256, 2, d)).astype(np.float32) for _ in range(4))
    jrope, trope = jpack(jfreqs(ROPE_GRID, d)), pack_split(rope_freqs_3d(ROPE_GRID, d))
    kl = None if k_lens is None else np.array(k_lens, np.int32)
    with pallas_interpret():
        out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
            q, k, v, k_lens=None if kl is None else jnp.asarray(kl), rope=jrope, block_q=128,
            block_k=128), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    got_out = tfa.flash_attention(qt, kt, vt, k_lens=None if kl is None else t(kl), rope=trope)
    got_out.backward(t(g))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=2e-4, atol=2e-4)
    for name, a, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3, err_msg=name)


def test_rope_inverse_matches_jax_and_is_the_transpose():
    """`rope_apply_split_inv` equals the JAX package's `_rot_inv` and is the
    VJP of `rope_apply_split`."""
    rng = np.random.default_rng(4)
    x, g = (rng.standard_normal((1, 256, 2, 64)).astype(np.float32) for _ in range(2))
    trope = pack_split(rope_freqs_3d(ROPE_GRID, 64))
    jrope = np.asarray(jpack(jfreqs(ROPE_GRID, 64)))
    from stableavatar_tpu_torch.ops.rope import rope_apply_split, rope_apply_split_inv

    got = rope_apply_split_inv(t(g), trope)
    want = np.stack([np.asarray(jfa._rot_inv(jnp.asarray(g[0, :, h]), jnp.asarray(jrope)))
                     for h in range(2)], axis=1)[None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xt = t(x).requires_grad_()
    rope_apply_split(xt, trope).backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


# (D, Lq, Lk): q and k as long as the 256-position table, and shorter than
# it (each tensor takes the table's first L rows)
ROPE_ROWS = [(64, 256, 256), (128, 256, 256), (64, 200, 131), (128, 131, 200)]


def _bf16_values(x):
    """numpy fp32 -> the same values rounded to bf16, still fp32 (exact on
    both sides)."""
    return t(x).bfloat16().float().numpy()


@pytest.mark.parametrize("d,lq,lk", ROPE_ROWS)
def test_rope_rotate_plain_matches_jax_bits(d, lq, lk):
    """The plain `rope_rotate` (K1-rope's and K4-rope's rotation pass, the
    reference of `sa_rope_rotate`) equals the JAX package's
    `rope_apply_split(x, table[:L]).astype(bf16)` bit for bit: one fp32
    rotation, one rounding, q by rows [0, Lq) and k by [0, Lk)."""
    from stableavatar_tpu.ops.rope import rope_apply_split as jrs

    rng = np.random.default_rng(21)
    q = _bf16_values(rng.standard_normal((2, lq, 3, d)).astype(np.float32) * 4)
    k = _bf16_values(rng.standard_normal((2, lk, 3, d)).astype(np.float32) * 4)
    jrope, trope = jpack(jfreqs(ROPE_GRID, d)), pack_split(rope_freqs_3d(ROPE_GRID, d))
    qr, kr = tfa.rope_rotate(t(q, torch.bfloat16), t(k, torch.bfloat16), trope)
    assert qr.dtype == kr.dtype == torch.bfloat16
    for got, x, l in ((qr, q, lq), (kr, k, lk)):
        want = jrs(jnp.asarray(x, jnp.bfloat16), jrope[:l]).astype(jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("d,lq,lk", ROPE_ROWS[1:3])
def test_rope_finalize_plain_matches_jax_rot_inv(d, lq, lk):
    """The plain `rope_finalize_bwd` (the reference of
    `sa_rope_finalize_bwd`) equals the TPU bodies' last step bit for bit:
    `_rot_inv(dq_or_dk, table rows).astype(bf16)` on the fp32 sums, and dV
    rounded as it is."""
    rng = np.random.default_rng(22)
    dq = rng.standard_normal((1, lq, 2, d)).astype(np.float32)
    dk, dv = (rng.standard_normal((1, lk, 2, d)).astype(np.float32) for _ in range(2))
    jrope, trope = jpack(jfreqs(ROPE_GRID, d)), pack_split(rope_freqs_3d(ROPE_GRID, d))
    got = tfa._rope_finalize_plain(t(dq), t(dk), t(dv), trope, torch.bfloat16)
    for g, x in zip(got[:2], (dq, dk)):
        l = x.shape[1]
        want = np.stack([np.asarray(jfa._rot_inv(jnp.asarray(x[0, :, h]), jrope[:l])
                                    .astype(jnp.bfloat16), np.float32) for h in range(2)],
                        axis=1)[None]
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), want)
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  np.asarray(jnp.asarray(dv).astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("sms,splits", [(1, 1), (132, 4)])
def test_rope_kernel_entry_points_route(monkeypatch, sms, splits):
    """The CUDA wrappers' route with `rope=` (launches recorded here, not
    run): K1-rope is `sa_rope_rotate` then `sa_flash_fwd_bf16` on the
    rotated copies; K4-rope is `sa_flash_bwd` writing fp32 dK / dV partials
    (also with one split, where dK / dV are never rounded in the kernel),
    then `sa_rope_finalize_bwd` on dQ's fp32 buffer and the partials (their
    sum in a fixed order where the queries are split)."""
    import types

    from stableavatar_tpu_torch.ops import cuda_lib

    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tfa, "launch_counts", dict.fromkeys(tfa.launch_counts, 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=sms))
    b, l, n, d = 1, 256, 2, 64
    q, k, v, g = (t(x, torch.bfloat16) for x in (*_qkv(23, b=b, lq=l, lk=l, n=n, d=d),
                                                 _qkv(24, b=b, lq=l, lk=l, n=n, d=d)[0]))
    trope = pack_split(rope_freqs_3d(ROPE_GRID, d))
    for with_lse in (False, True):
        tfa._flash_fwd_cuda(q, k, v, None, d ** -0.5, with_lse=with_lse, rope=trope)
        (rot, rot_args), (fwd, fwd_args) = calls[-2:]
        assert (rot, fwd) == ("sa_rope_rotate", "sa_flash_fwd_bf16")
        assert rot_args[:3] == (q.data_ptr(), k.data_ptr(), trope.data_ptr())
        assert rot_args[5:] == (b, l, l, n, d)
        assert fwd_args[:2] == rot_args[3:5]  # K1 reads the rotated copies
        assert (fwd_args[5] is not None) == with_lse
    assert tfa.launch_counts == {**dict.fromkeys(tfa.launch_counts, 0), "rope_rotate": 2,
                                 "flash_fwd_bf16": 1, "flash_fwd_bf16_lse": 1}
    assert tfa.bwd_splits(b * n, l, l, sms) == splits
    out, lse = v.clone(), torch.zeros((b, n, l))
    dq, dk, dv = tfa._flash_bwd_cuda(q, k, v, None, out, lse, g, d ** -0.5, rope=trope)
    (bwd, bwd_args), (fin, fin_args) = calls[-2:]
    assert (bwd, fin) == ("sa_flash_bwd", "sa_rope_finalize_bwd")
    # dq_acc, dk, dv (bf16: none), dk_part, dv_part, ..., splits
    assert bwd_args[8:10] == (None, None) and None not in bwd_args[7:8] + bwd_args[10:12]
    assert bwd_args[12:18] == (b, l, l, n, d, splits)
    assert fin_args[0] == bwd_args[7] and fin_args[3] == trope.data_ptr()
    assert (fin_args[1:3] == bwd_args[10:12]) == (splits == 1)
    assert fin_args[4:7] == tuple(x.data_ptr() for x in (dq, dk, dv))
    assert all(x.dtype == torch.bfloat16 and x.shape == q.shape for x in (dq, dk, dv))
    assert tfa.launch_counts["flash_bwd"] == tfa.launch_counts["rope_finalize_bwd"] == 1
    src = (cuda_lib.CSRC / "rope.cu").read_text()
    assert "rope_rotate_kernel<" in _entry_body(src, "sa_rope_rotate")
    assert "rope_finalize_bwd_kernel<" in _entry_body(src, "sa_rope_finalize_bwd")


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
    with pytest.raises(ValueError, match="not differentiable"):
        tfa.flash_attention_with_stats(t(q), t(k).requires_grad_(), t(v), quant="qk")
    with pytest.raises(ValueError, match="unknown quant"):
        tfa.flash_attention_with_stats(t(q), t(k), t(v), quant="int4")


# ragged keys over two of flash_attention_with_stats' 1024-key blocks
STATS_K_LENS = np.array([1100, 1300], np.int32)


@pytest.mark.parametrize("quant,edge", [
    pytest.param("qk", None, id="qk"), pytest.param("qkv", None, id="qkv"),
    pytest.param("qkpv", None, id="qkpv"),
    *(pytest.param(quant, e, id=_edge(quant, e))
      for quant in ("qk", "qkv", "qkpv") for e in EDGE_CASES)])
def test_k2_lse_plain_matches_pallas_with_stats(quant, edge):
    """K2-LSE: the port's `flash_attention_with_stats(quant=...)` (plain
    version on CPU tensors) against the JAX function with its Pallas int8
    kernel in interpret mode, at the JAX defaults (block 1024, so "qkpv"
    quantises P on two key blocks) with ragged keys, and at the wgmma
    kernel's tile edges, for every V path ("qkpv" on the JAX function's
    block, min(1024, round_up(Lk, 128))); the K2 test's tolerance on the
    output, 1e-3 on the LSE (an empty row's, -1e30 ln 2 + log of its sum,
    rounds alike in fp32 on both sides)."""
    if edge is None:
        q, k, v = _qkv(21, lq=256, lk=1300)
        k_lens = STATS_K_LENS
    else:
        q, k, v, k_lens = _edge_inputs(21, edge)
    b, lq, n, _ = q.shape
    with pallas_interpret():
        want, want_lse = jfa.flash_attention_with_stats(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), k_lens=jnp.asarray(k_lens),
            quant=quant, static_max=False)
    got, lse = tfa.flash_attention_with_stats(t(q), t(k), t(v), k_lens=t(k_lens),
                                              quant=quant, static_max=False)
    assert got.dtype == torch.float32 and lse.shape == (b, lq, n) and lse.dtype == torch.float32
    _check_rows(got.numpy(), np.asarray(want), k_lens)
    assert np.max(np.abs(lse.numpy() - np.asarray(want_lse))) <= 1e-3


def test_k2v_qkpv_quantises_on_the_jax_block():
    """The qkpv fault of the kernel's first port and its repair: P is
    quantised per row against its maximum over the JAX package's key block.
    At Lk = 512 with the JAX block of 256, the plain qkpv on that block
    matches Pallas interpret at 256, and the tile-wise form (the 64-key
    tile the card used to quantise on) does not."""
    q, k, v = _qkv(22, b=1, lq=256, lk=512)
    with pallas_interpret():
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), quant="qkpv", block_q=128,
            block_k=256))
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), None, 64 ** -0.5)
    v8, sv = tfa.quantize_v(t(v))

    def plain(block_k):
        return tfa._flash_int8_plain(q8, k8, v8, sqk, quant="qkpv", sv=sv, block_k=block_k,
                                     out_dtype=torch.float32).numpy()

    assert rel_l2(plain(256), want) < 1e-5
    assert rel_l2(plain(64), want) > 1e-3
    # the wrappers pick the JAX blocks: 512 in flash_attention, 512 here too
    # in flash_attention_with_stats (min(1024, 512))
    assert tfa.jax_key_block(512, tfa.INT8_BLOCK_K) == tfa.jax_key_block(512, 1024) == 512
    assert tfa.jax_key_block(21504, tfa.INT8_BLOCK_K) == 1536
    assert tfa.jax_key_block(5376, tfa.STATS_BLOCK_K) == 1024
    assert torch.equal(tfa.flash_attention(t(q), t(k), t(v), quant="qkpv"),
                       tfa._flash_int8_plain(q8, k8, v8, sqk, quant="qkpv", sv=sv, block_k=512,
                                             out_dtype=torch.float32))


def _mk(b=2, lq=256, l1=96, l2=33, n=2, d=64, seed=0, k2_scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in [(b, lq, n, d), (b, l1, n, d), (b, l1, n, d), (b, l2, n, d), (b, l2, n, d)]]
    arrs[3] *= np.float32(k2_scale)
    return arrs


# the Hopper kernel's tile edges (128 query rows, 128-key tiles, a
# segment's last tile masked): the image context's 257 keys (a 1-key last
# tile) at D 128, a 1-key segment, the DiT's 512 + 257 keys at a ragged Lq,
# B * N = 9 with last tiles of 2 and 65 keys, and image logits 30x the text
# ones (a max shared by the segments would underflow the text's P)
K5_CASES = {"both_padded": dict(), "ragged_q": dict(lq=200),
            "lane_aligned": dict(l1=128, l2=128, seed=3),
            "l2_257_d128": dict(l1=160, l2=257, d=128, seed=4), "l2_1": dict(l2=1, seed=5),
            "dit_contexts_lq200": dict(lq=200, l1=512, l2=257, seed=6),
            "bn9": dict(b=3, n=3, lq=136, l1=130, l2=65, seed=8),
            "segment_scales_30x": dict(k2_scale=30.0, seed=9)}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_plain_matches_pallas_f32(case):
    arrs = _mk(**K5_CASES[case])
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



@pytest.mark.parametrize("quant,edge", [
    pytest.param("qk", None, id="qk"), pytest.param("qkv", None, id="qkv"),
    *(pytest.param(quant, e, id=_edge(quant, e)) for quant in ("qk", "qkv") for e in EDGE_CASES)])
def test_k3_plain_matches_pallas(quant, edge):
    """Plain K3 against the Pallas static-bound kernel in interpret mode at
    block 128 (tests/test_fastpath.py:143): the same int8 operands and the
    same bound per 128-row query block, so the outputs differ by fp32
    summation order only; the LSE (bound-independent) to 1e-4 as there.  At
    the tile edges a batch with no valid key is zero rows on both sides."""
    q, k, v, k_lens = _edge_inputs(5, edge if edge else (256, 384, 64, tuple(K_LENS)))
    kw = dict(k_lens=jnp.asarray(k_lens), quant=quant, block_q=128, block_k=128,
              static_max=True)
    with pallas_interpret():
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        _, want_lse = jfa.flash_attention_with_stats(jnp.asarray(q), jnp.asarray(k),
                                                     jnp.asarray(v), **kw)
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), None, q.shape[-1] ** -0.5)
    v_in, sv = t(v), None
    if quant == "qkv":
        v_in, sv = tfa.quantize_v(v_in)
    got, lse = tfa._flash_int8_static_plain(q8, k8, v_in, sqk, t(k_lens), quant=quant, sv=sv,
                                            block_q=128, out_dtype=torch.float32, with_lse=True)
    want = np.asarray(want)
    assert rel_l2(got.numpy(), want) < 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.transpose(1, 2).numpy(), np.asarray(want_lse),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant", ["qk", "qkv"])
def test_k3_plain_matches_online_and_its_own_block(quant):
    """The static bound changes only underflow: at the kernel's block of 64
    the plain K3 equals the online plain K2 / K2v to fp32 rounding, and so
    does its LSE equal the online LSE (mirrors tests/test_fastpath.py:143)."""
    q, k, v = _qkv(8, lq=200)
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), None, 64 ** -0.5)
    v_in, sv = t(v), None
    if quant == "qkv":
        v_in, sv = tfa.quantize_v(v_in)
    got, lse = tfa._flash_int8_static_plain(q8, k8, v_in, sqk, t(K_LENS), quant=quant, sv=sv,
                                            out_dtype=torch.float32, with_lse=True)
    want = tfa._flash_int8_plain(q8, k8, v_in, sqk, t(K_LENS), quant=quant, sv=sv,
                                 block_k=128, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    mstat = tfa.static_bound(q8, k8, sqk)
    assert mstat.shape == (4, 4)  # B*N slabs x ceil(200 / 64) query blocks
    # the bound holds: every logit is at most its block's M
    s = torch.einsum("bqnd,bknd->bnqk", q8.float(), k8.float()) * sqk.reshape(2, 2, 1, 1)
    m_rows = mstat.reshape(2, 2, 4).repeat_interleave(64, dim=2)[:, :, :200]
    assert bool((s.amax(-1) <= m_rows * (1 + 1e-6)).all())
    # LSE against the online softmax's: log of the same row sums
    online = torch.logsumexp(torch.where(
        torch.arange(384)[None, None, None, :] < t(K_LENS).long()[:, None, None, None],
        s * LN2_T, -torch.inf), -1)
    np.testing.assert_allclose(lse.numpy(), online.numpy(), rtol=1e-4, atol=1e-4)


LN2_T = 0.6931471805599453


def test_int8_wrapper_routes_variants_on_cpu(monkeypatch):
    """flash_attention picks the plain K2v / K3 on CPU tensors: quant selects
    the V path, static_max (or STATIC_MAX) the static softmax, which "qkpv"
    ignores; the output keeps the unquantised V's dtype."""
    q, k, v = (t(x) for x in _qkv(12, lq=128, lk=128))
    q8, k8, sqk = tfa.prepare_int8(q, k, None, 64 ** -0.5)
    v8, sv = tfa.quantize_v(v)
    cases = [
        (dict(quant="qkv"), tfa._flash_int8_plain(q8, k8, v8, sqk, quant="qkv", sv=sv,
                                                  out_dtype=torch.float32)),
        (dict(quant="qkpv", static_max=True),
         tfa._flash_int8_plain(q8, k8, v8, sqk, quant="qkpv", sv=sv, out_dtype=torch.float32)),
        (dict(quant="qk", static_max=True), tfa._flash_int8_static_plain(q8, k8, v, sqk)),
        (dict(quant="qkv", static_max=True),
         tfa._flash_int8_static_plain(q8, k8, v8, sqk, quant="qkv", sv=sv,
                                      out_dtype=torch.float32)),
    ]
    for kw, want in cases:
        got = tfa.flash_attention(q, k, v, **kw)
        assert got.dtype == torch.float32 and torch.equal(got, want), kw
    monkeypatch.setattr(tfa, "STATIC_MAX", True)
    assert torch.equal(tfa.flash_attention(q, k, v, quant="qk"), cases[2][1])
    assert not any(tfa.launch_counts.values())


def _entry_body(src, name):
    """The body of the C entry point `name` in a CUDA source."""
    start = src.index(f'extern "C" int {name}(')
    return src[start:src.index("\n}\n", start)]


def test_int8_kernel_entry_points_route_by_variant(monkeypatch):
    """`_flash_int8_cuda` (the CUDA path, its launch recorded here) sends
    every int8 variant to its entry point, and each entry point launches the
    wgmma / TMA kernel (`launch_fwd_d` in csrc/flash_attention.cu) with its
    V path: bf16 V for K2, K2-LSE qk and K3-qk, widened V8 for qkv and
    K3-qkv, s8 P.V for qkpv; the mma.sync int8-V template is gone."""
    from stableavatar_tpu_torch.ops import cuda_lib

    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tfa, "launch_counts", dict.fromkeys(tfa.launch_counts, 0))
    q, k, v = (t(x) for x in _qkv(14, lq=200, lk=130))
    q8, k8, sqk = tfa.prepare_int8(q, k, None, 64 ** -0.5)
    v16, (v8, sv) = v.bfloat16(), tfa.quantize_v(v)
    mstat = tfa.static_bound(q8, k8, sqk)
    cases = [(dict(v=v16), False, "sa_flash_fwd_int8_qk", "flash_fwd_int8_qk"),
             (dict(v=v16), True, "sa_flash_fwd_int8_qk", "flash_fwd_int8_qk_lse"),
             (dict(v=v16, mstat=mstat), False, "sa_flash_fwd_int8_static_qk",
              "flash_fwd_int8_static_qk"),
             (dict(v=v16, mstat=mstat), True, "sa_flash_fwd_int8_static_qk",
              "flash_fwd_int8_static_qk"),
             (dict(v=v8, quant="qkv", sv=sv), True, "sa_flash_fwd_int8_qkv",
              "flash_fwd_int8_qkv_lse"),
             (dict(v=v8, quant="qkpv", sv=sv), False, "sa_flash_fwd_int8_qkpv",
              "flash_fwd_int8_qkpv"),
             (dict(v=v8, quant="qkv", sv=sv, mstat=mstat), False,
              "sa_flash_fwd_int8_static_qkv", "flash_fwd_int8_static_qkv")]
    for kw, with_lse, entry, count in cases:
        before = dict(tfa.launch_counts)
        vin = kw.pop("v")
        tfa._flash_int8_cuda(q8, k8, vin, sqk, None, with_lse=with_lse, **kw)
        name, args = calls[-1]
        assert name == entry
        # the LSE pointer (before B, Lq, Lk, N, D and qkpv's block) is passed
        # exactly when it is asked for
        lse_ptr = args[-7] if kw.get("quant") == "qkpv" else args[-6]
        assert (lse_ptr is not None) == with_lse
        assert {c: tfa.launch_counts[c] - before[c] for c in before
                if tfa.launch_counts[c] != before[c]} == {count: 1}
    src = (cuda_lib.CSRC / "flash_attention.cu").read_text()
    for entry, v_path in (("sa_flash_fwd_bf16", "kVBf16"), ("sa_flash_fwd_int8_qk", "kVBf16"),
                          ("sa_flash_fwd_int8_static_qk", "kVBf16"),
                          ("sa_flash_fwd_int8_qkv", "kVInt8"),
                          ("sa_flash_fwd_int8_static_qkv", "kVInt8"),
                          ("sa_flash_fwd_int8_qkpv", "kVPv8")):
        body = _entry_body(src, entry)
        assert "launch_fwd_d<" in body and f"sa::ffwd::{v_path}>" in body, entry
    assert "flash_fwd_int8v_kernel" not in src and "launch_int8v" not in src


def test_k2v_qkpv_plain_masks_whole_tiles():
    """A ragged batch whose last key tiles are fully masked: the plain qkpv
    at the kernel's tile of 64 gives what the same attention gives over the
    valid keys alone (a masked tile has m_tile = -1e30 and p_rel = 1, which
    its zero factor must remove)."""
    q, k, v = _qkv(13, b=1, lq=64, lk=320, n=2, d=64)
    q8, k8, sqk = tfa.prepare_int8(t(q), t(k), None, 64 ** -0.5)
    v8, sv = tfa.quantize_v(t(v))
    got = tfa._flash_int8_plain(q8, k8, v8, sqk, torch.tensor([150], dtype=torch.int32),
                                quant="qkpv", sv=sv, block_k=64, out_dtype=torch.float32)
    want = tfa._flash_int8_plain(q8, k8[:, :150], v8[:, :150], sqk, quant="qkpv", sv=sv,
                                 block_k=64, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
