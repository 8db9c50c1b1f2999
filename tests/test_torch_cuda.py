"""The port's CUDA kernels and their wrappers on the card.

Every test here is marked `cuda` and skips without a CUDA device.  This file
imports no JAX, so it runs on a machine with an H100 and no JAX, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Each kernel
is held against its plain PyTorch version in the same module at rel-L2 1e-2,
the bound `chip_smoke.py` uses: bf16 outputs, summed in another order, with P
rounded to bf16 at other places.  K1's and K3's LSE (fp32, from fp32 row
statistics) are held to max-abs 1e-3, and so is K2-LSE's (the int8 kernels'
LSE output).  K2v-qkpv is held against its plain version on the same key
block (its result depends on the block): the JAX package's, or the one
given.  K1-rope and K4-rope are held to the same bounds, their gradients to
rel-L2 1e-2; the rotation and finalize passes (`csrc/rope.cu`) must equal
their plain versions exactly, and so must K1-rope the rotation in PyTorch
followed by K1, and K4-rope's dV the fused K4's on the rotated inputs; the
probes' int8 GEMM outputs (`ops/probes.py`) must equal their plain version
exactly, and the bf16 GEMM and the dots probes stay within rel-L2 1e-2.
The FFN's tanh-GELU pass and its backward (`csrc/elementwise.cu`,
`ops/activations.py`) must equal the op-for-op composition run by PyTorch on
the same card, and autograd through it, bit for bit, NaN positions included:
over every bf16 value, in fp32, at the FFN shapes, under checkpointing, and
the DiT with the pass against the DiT with the composition; a CUDA tensor
the pass does not take raises.
"""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

import chip_smoke
from stableavatar_tpu_torch.models.vocal_projector import apply_linear
from stableavatar_tpu_torch.ops import activations as act
from stableavatar_tpu_torch.ops import cross_attention as ca
from stableavatar_tpu_torch.ops import flash_attention as fa
from stableavatar_tpu_torch.ops import probes
from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d
from stableavatar_tpu_torch.utils.quantization import (int8_linear, quantize_weight,
                                                       quantize_weight_for_compute)

pytestmark = pytest.mark.cuda

REL_TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _rel(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))


# K1's tiles are 128 query rows and 128 keys: the DiT self-attention of
# one sample, the cross-attention key lengths 512 and 257 (257 pads to three
# tiles) with Lq no multiple of 128, and k_lens ending inside a tile (300)
# and on a tile edge (640)
K1_CASES = [(2, 3000, 3000, 2, 128, [2500, 3000]), (1, 2100, 2100, 3, 64, None),
            (1, 21504, 21504, 12, 128, None), (1, 2100, 512, 4, 128, None),
            (1, 2100, 257, 4, 128, None), (2, 1000, 1000, 2, 128, [300, 640])]


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", K1_CASES)
def test_flash_kernels_match_plain(gen, b, lq, lk, n, d, k_lens):
    q = _randn(gen, b, lq, n, d)
    k, v = _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    before = dict(fa.launch_counts)
    out = fa.flash_attention(q, k, v, k_lens=kl)
    assert _rel(out, fa._flash_fwd_plain(q, k, v, kl)) < REL_TOL
    out = fa.flash_attention(q, k, v, k_lens=kl, quant="qk")
    q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
    assert _rel(out, fa._flash_int8_plain(q8, k8, v, sqk, kl)) < REL_TOL
    assert fa.launch_counts["flash_fwd_bf16"] == before["flash_fwd_bf16"] + 1
    assert fa.launch_counts["flash_fwd_int8_qk"] == before["flash_fwd_int8_qk"] + 1


K4_CASES = [(2, 3000, 3000, 2, 128, [2500, 3000]), (1, 2100, 2100, 3, 64, None),
            (1, 2048, 77, 2, 128, None), (2, 700, 257, 2, 64, [200, 257]),
            (1, 21504, 512, 12, 128, None), (1, 21504, 257, 12, 128, None),
            (1, 21504, 21504, 12, 128, None), (1, 2100, 512, 4, 128, None),
            (1, 2100, 257, 4, 128, None), (2, 1000, 1000, 2, 128, [300, 640])]


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", K4_CASES)
def test_k1_lse_and_k4_match_plain(gen, b, lq, lk, n, d, k_lens):
    q = _randn(gen, b, lq, n, d)
    k, v = _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    g = _randn(gen, b, lq, n, d)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    before = dict(fa.launch_counts)
    out, lse = fa._flash_fwd_cuda(q, k, v, kl, scale, with_lse=True)
    want_out, want_lse = fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True)
    assert _rel(out, want_out) < REL_TOL
    assert lse.shape == (b, n, lq) and lse.dtype == torch.float32
    assert float((lse - want_lse).abs().max()) < 1e-3
    got = fa._flash_bwd_cuda(q, k, v, kl, out, lse, g, scale)
    want = fa._flash_bwd_plain(q, k, v, kl, out, lse, g, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        assert _rel(a, w) < REL_TOL, (name, _rel(a, w))
    if k_lens is not None:  # keys past k_lens get no gradient
        assert float(got[1][0, k_lens[0]:].abs().max()) == 0.0
        assert float(got[2][0, k_lens[0]:].abs().max()) == 0.0
    assert fa.launch_counts["flash_fwd_bf16_lse"] == before["flash_fwd_bf16_lse"] + 1
    assert fa.launch_counts["flash_bwd"] == before["flash_bwd"] + 1


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", [K4_CASES[0], K4_CASES[3], K4_CASES[4]])
def test_k4_run_to_run(gen, b, lq, lk, n, d, k_lens):
    """Two launches of the fused K4 on the same inputs: dK and dV are equal
    (each block sums its keys' gradients in registers, and split partials
    are summed in a fixed order); dQ is summed across key blocks by bulk
    fp32 reductions in an order that changes, so two runs may differ by
    the fp32 rounding of that sum (about 1e-5 of max |dQ| over 168 key
    blocks) and then by one bf16 ulp of dQ (at most 2^-7 of |dQ|)."""
    q = _randn(gen, b, lq, n, d)
    k, v = _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    g = _randn(gen, b, lq, n, d)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    out, lse = fa._flash_fwd_cuda(q, k, v, kl, d ** -0.5, with_lse=True)
    first = fa._flash_bwd_cuda(q, k, v, kl, out, lse, g, d ** -0.5)
    second = fa._flash_bwd_cuda(q, k, v, kl, out, lse, g, d ** -0.5)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    a, c = first[0].float(), second[0].float()
    bound = torch.maximum(a.abs(), c.abs()) * 2 ** -7 + 1e-5 * float(a.abs().max())
    assert bool(((a - c).abs() <= bound).all()), float((a - c).abs().max())


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", [K1_CASES[0], K1_CASES[3], K1_CASES[4],
                                                 K1_CASES[5]])
def test_k1_lse_run_to_run(gen, b, lq, lk, n, d, k_lens):
    """K1 sums in registers and writes every output once, without atomics:
    two launches on the same inputs agree bit for bit, out and LSE."""
    q = _randn(gen, b, lq, n, d)
    k, v = _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    first = fa._flash_fwd_cuda(q, k, v, kl, d ** -0.5, with_lse=True)
    second = fa._flash_fwd_cuda(q, k, v, kl, d ** -0.5, with_lse=True)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


# the int8-QK wgmma kernel (K2, K2-LSE qk, K3-qk): the DiT self-attention
# of the CFG batch and of one sample, the 4-rank ring slice, and ragged
# cases at its tile edges (128 query rows, 128-key tiles) with k_lens ending
# inside a tile and 0, D 64 and 128
INT8_QK_CASES = [(3, 21504, 21504, 12, 128, None), (1, 21504, 21504, 12, 128, None),
                 (3, 5376, 5376, 12, 128, None), (2, 200, 130, 2, 64, [77, 0]),
                 (2, 200, 257, 2, 128, [0, 200]), (2, 3000, 2900, 2, 64, [2500, 2900]),
                 (1, 1000, 1000, 3, 128, [640])]


def _int8_operands(gen, b, lq, lk, n, d):
    q, k, v = _randn(gen, b, lq, n, d), _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
    return q8, k8, v, sqk


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", INT8_QK_CASES)
@pytest.mark.parametrize("static", [False, True])
def test_int8_qk_kernels_match_plain(gen, b, lq, lk, n, d, k_lens, static):
    """K2 and K2-LSE qk (online), or K3-qk (static bound, with its LSE),
    against their plain versions: out within rel-L2 1e-2 and max-abs 6e-2,
    the LSE within 1e-3; the output does not depend on the LSE write."""
    q8, k8, v, sqk = _int8_operands(gen, b, lq, lk, n, d)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    mstat = fa.static_bound(q8, k8, sqk) if static else None
    plain = fa._flash_int8_static_plain if static else fa._flash_int8_plain
    want, want_lse = plain(q8, k8, v, sqk, kl, with_lse=True)
    out, lse = fa._flash_int8_cuda(q8, k8, v, sqk, kl, mstat=mstat, with_lse=True)
    assert out.dtype == torch.bfloat16 and lse.shape == (b, n, lq)
    assert _rel(out, want) < REL_TOL, _rel(out, want)
    assert float((out.float() - want.float()).abs().max()) < 6e-2
    assert float((lse - want_lse).abs().max()) < 1e-3
    if k_lens is not None and 0 in k_lens:  # no valid key: zero rows
        assert not out[k_lens.index(0)].any()
    assert torch.equal(fa._flash_int8_cuda(q8, k8, v, sqk, kl, mstat=mstat), out)


# the int8-V instances of the same kernel (widened V8 for "qkv" and K3-qkv,
# s8 P.V for "qkpv"): the ring slice and the tile-edge cases of
# INT8_QK_CASES, Lq and Lk apart
INT8V_CASES = [INT8_QK_CASES[2], *INT8_QK_CASES[3:]]


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", INT8V_CASES)
@pytest.mark.parametrize("variant", ["qkv", "qkpv", "static_qkv"])
def test_int8v_kernels_match_plain_at_tile_edges(gen, b, lq, lk, n, d, k_lens, variant):
    """K2v-qkv, K2v-qkpv (on `flash_attention`'s JAX key block) and K3-qkv,
    each with its LSE, against their plain versions at the wgmma kernel's
    tile edges: out within rel-L2 1e-2 and max-abs 6e-2, the LSE within
    1e-3, a batch with no valid key zero rows; the output does not depend on
    the LSE write."""
    q8, k8, v, sqk = _int8_operands(gen, b, lq, lk, n, d)
    v8, sv = fa.quantize_v(v)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    static = variant.startswith("static_")
    quant = variant.removeprefix("static_")
    mstat = fa.static_bound(q8, k8, sqk) if static else None
    block = fa.jax_key_block(lk, fa.INT8_BLOCK_K)
    if static:
        want, want_lse = fa._flash_int8_static_plain(q8, k8, v8, sqk, kl, quant=quant, sv=sv,
                                                     out_dtype=torch.bfloat16, with_lse=True)
    else:
        want, want_lse = fa._flash_int8_plain(q8, k8, v8, sqk, kl, quant=quant, sv=sv,
                                              block_k=block, out_dtype=torch.bfloat16,
                                              with_lse=True)
    out, lse = fa._flash_int8_cuda(q8, k8, v8, sqk, kl, quant=quant, sv=sv, mstat=mstat,
                                   with_lse=True, pv_block=block)
    assert out.dtype == torch.bfloat16 and lse.shape == (b, n, lq)
    assert _rel(out, want) < REL_TOL, _rel(out, want)
    assert float((out.float() - want.float()).abs().max()) < 6e-2
    assert float((lse - want_lse).abs().max()) < 1e-3
    if k_lens is not None and 0 in k_lens:  # no valid key: zero rows
        assert not out[k_lens.index(0)].any()
    assert torch.equal(fa._flash_int8_cuda(q8, k8, v8, sqk, kl, quant=quant, sv=sv, mstat=mstat,
                                           pv_block=block), out)


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", [INT8_QK_CASES[1], INT8_QK_CASES[3],
                                                INT8_QK_CASES[5]])
@pytest.mark.parametrize("quant", ["qk", "qkv", "qkpv"])
def test_k2_lse_run_to_run(gen, b, lq, lk, n, d, k_lens, quant):
    """K2-LSE writes every output once, without atomics: two launches on
    the same inputs agree bit for bit, out and LSE, for every V path."""
    q8, k8, v, sqk = _int8_operands(gen, b, lq, lk, n, d)
    sv = None
    if quant != "qk":
        v, sv = fa.quantize_v(v)
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    first = fa._flash_int8_cuda(q8, k8, v, sqk, kl, quant=quant, sv=sv, with_lse=True)
    second = fa._flash_int8_cuda(q8, k8, v, sqk, kl, quant=quant, sv=sv, with_lse=True)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_backward_through_attention(gen):
    """A long-query attention() call under autograd takes K1 with LSE and
    K4; the gradients match the same call on the CPU (plain versions)."""
    b, l, n, d = 1, 2048, 2, 128
    q, k, v = (_randn(gen, b, l, n, d).requires_grad_() for _ in range(3))
    g = _randn(gen, b, l, n, d)
    before = dict(fa.launch_counts)
    out = attention(q, k, v)
    out.backward(g)
    assert fa.launch_counts["flash_fwd_bf16_lse"] == before["flash_fwd_bf16_lse"] + 1
    assert fa.launch_counts["flash_fwd_bf16"] == before["flash_fwd_bf16"]
    assert fa.launch_counts["flash_bwd"] == before["flash_bwd"] + 1
    qc, kc, vc = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    oc = fa.flash_attention(qc, kc, vc)
    oc.backward(g.cpu())
    assert _rel(out.detach().cpu(), oc.detach()) < REL_TOL
    for a, w in ((q, qc), (k, kc), (v, vc)):
        assert _rel(a.grad.cpu(), w.grad) < REL_TOL
    with torch.no_grad():  # inference launches stay K1 without LSE
        attention(q, k, v)
    assert fa.launch_counts["flash_fwd_bf16"] == before["flash_fwd_bf16"] + 1
    with pytest.raises(ValueError, match="not differentiable"):
        fa.flash_attention(q, k, v, quant="qk")


# K5's tile edges (chip_smoke.K5_EDGES: B, Lq, L1, L2, N, scale of k2), each
# with its max-abs bound.  The kernel and its plain version differ by the
# order of their fp32 sums: one bf16 ulp of the output, 3.9e-3 where outputs
# stay below 1 (the first case).  A 1-key segment or a peaked softmax puts
# single V rows (|v| up to 5) in the output, whose ulp is 1.6e-2 to 3.1e-2
# (1.56e-2 measured on the H100): the other cases take chip_smoke.py's
# ABS_TOL
K5_CASES = [(*edge, 1e-2 if i == 0 else chip_smoke.ABS_TOL)
            for i, edge in enumerate(chip_smoke.K5_EDGES)]


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("b,l,l1,l2,n,k2_scale,abs_tol", K5_CASES)
def test_dual_context_kernel_matches_plain(gen, b, l, l1, l2, n, k2_scale, abs_tol, d):
    q = _randn(gen, b, l, n, d)
    k1, v1 = _randn(gen, b, l1, n, d), _randn(gen, b, l1, n, d)
    k2, v2 = (_randn(gen, b, l2, n, d) * k2_scale).bfloat16(), _randn(gen, b, l2, n, d)
    before = ca.launch_counts["dual_context"]
    out = ca.dual_context_attention(q, k1, v1, k2, v2)
    assert ca.launch_counts["dual_context"] == before + 1
    want = ca._dual_plain(q, k1, v1, k2, v2, d ** -0.5)
    # K5 rounds P where the plain version does (K5_CASES: the bounds)
    max_abs = float((out.float() - want.float()).abs().max())
    print(f"K5 against _dual_plain: max_abs {max_abs:.3e}")
    assert _rel(out, want) < REL_TOL and max_abs < abs_tol


def test_attention_dispatch_on_cuda(gen):
    """Long queries take the flash kernel; short ones the short-query path
    (no launch)."""
    long_q = _randn(gen, 1, 2048, 2, 128)
    short_q = _randn(gen, 1, 1024, 2, 128)
    k, v = _randn(gen, 1, 300, 2, 128), _randn(gen, 1, 300, 2, 128)
    kl = torch.tensor([250], dtype=torch.int32, device="cuda")
    before = fa.launch_counts["flash_fwd_bf16"]
    out = attention(long_q, k, v, k_lens=kl)
    assert fa.launch_counts["flash_fwd_bf16"] == before + 1
    assert _rel(out, fa._flash_fwd_plain(long_q, k, v, kl)) < REL_TOL
    out = attention(short_q, k, v, k_lens=kl)
    assert fa.launch_counts["flash_fwd_bf16"] == before + 1
    assert _rel(out, fa._flash_fwd_plain(short_q, k, v, kl)) < REL_TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 1, 2048, 2, 128)
    with pytest.raises(ValueError, match="unknown quant"):
        fa.flash_attention_with_stats(q, q, q, quant="int4")
    q8, k8, sqk = fa.prepare_int8(q, q, None, 128 ** -0.5)
    v8, sv = fa.quantize_v(q)
    with pytest.raises(ValueError, match="pv_block"):
        fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant="qkpv", sv=sv, pv_block=100)
    with pytest.raises(ValueError, match="no int8 kernel"):
        fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant="qkpv", sv=sv,
                            mstat=fa.static_bound(q8, k8, sqk))
    with pytest.raises(ValueError, match="mstat: expected shape"):
        fa._flash_int8_cuda(q8, k8, q, sqk, None,
                            mstat=fa.static_bound(q8, k8, sqk)[:, :1].contiguous())
    with pytest.raises(TypeError):
        fa._flash_int8_cuda(q8, k8, q, sqk, None, quant="qkv", sv=sv)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, ::2], q, q)
    odd = _randn(gen, 1, 64, 2, 96)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="head dim"):
        ca.dual_context_attention(odd, odd, odd, odd, odd)


@pytest.mark.parametrize("rows", [5, 40])
def test_int8_linear_on_cuda_matches_cpu(gen, rows):
    """torch._int_mm needs more than 16 rows on CUDA: short inputs are padded
    with zero rows.  The int32 products are exact, so the card and the CPU
    agree up to the bf16 rounding of the epilogue."""
    w = torch.randn((48, 64), generator=gen, device="cuda")
    x = _randn(gen, rows, 64)
    b = torch.randn((48,), generator=gen, device="cuda")
    w8 = quantize_weight_for_compute(w)
    got = int8_linear(x, w8, b)
    want = int8_linear(x.cpu(), {k: t.cpu() for k, t in w8.items()}, b.cpu())
    assert got.shape == (rows, 48) and got.dtype == torch.bfloat16
    assert _rel(got.cpu(), want) < REL_TOL


@pytest.mark.parametrize("b,l,n,d,k_lens", [(2, 3000, 2, 128, [2500, 3000]),
                                            (1, 2100, 3, 64, None),
                                            (2, 2100, 2, 128, [1280, 700])])
@pytest.mark.parametrize("variant", ["qkv", "qkpv", "static_qk", "static_qkv"])
def test_int8_variant_kernels_match_plain(gen, b, l, n, d, k_lens, variant):
    """K2v and K3 against their plain versions; the ragged cases have whole
    key tiles past k_lens (skipped by the kernels), and [1280, 700] ends
    one batch on a tile edge."""
    q, k, v = (_randn(gen, b, l, n, d) for _ in range(3))
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    static = variant.startswith("static_")
    quant = variant.removeprefix("static_")
    q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
    v_in, sv = (v, None) if quant == "qk" else fa.quantize_v(v)
    before = fa.launch_counts[f"flash_fwd_int8_{variant}"]
    got = fa.flash_attention(q, k, v, k_lens=kl, quant=quant, static_max=static)
    assert got.dtype == torch.bfloat16
    assert fa.launch_counts[f"flash_fwd_int8_{variant}"] == before + 1
    if static:
        want, want_lse = fa._flash_int8_static_plain(q8, k8, v_in, sqk, kl, quant=quant, sv=sv,
                                                     out_dtype=torch.bfloat16, with_lse=True)
        out, lse = fa._flash_int8_cuda(q8, k8, v_in, sqk, kl, quant=quant, sv=sv,
                                       mstat=fa.static_bound(q8, k8, sqk), with_lse=True)
        assert torch.equal(out, got)
        assert lse.shape == (b, n, l) and float((lse - want_lse).abs().max()) < 1e-3
    else:
        want = fa._flash_int8_plain(q8, k8, v_in, sqk, kl, quant=quant, sv=sv,
                                    block_k=fa.jax_key_block(l, fa.INT8_BLOCK_K),
                                    out_dtype=torch.bfloat16)
    assert _rel(got, want) < REL_TOL, _rel(got, want)
    assert float((got.float() - want.float()).abs().max()) < 6e-2


@pytest.mark.parametrize("b,l,n,d,k_lens", [(2, 3000, 2, 128, [2500, 3000]),
                                            (1, 2100, 3, 64, None),
                                            (2, 2100, 2, 128, [1280, 700])])
@pytest.mark.parametrize("quant", ["qk", "qkv", "qkpv"])
def test_k2_lse_matches_plain(gen, b, l, n, d, k_lens, quant):
    """K2-LSE through `flash_attention_with_stats` (its key block of 1024 for
    "qkpv") against the plain version, output and LSE; the ragged cases skip
    whole key tiles, and 700 of 2100 skips whole 1024-key blocks."""
    q, k, v = (_randn(gen, b, l, n, d) for _ in range(3))
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
    v_in, sv = (v, None) if quant == "qk" else fa.quantize_v(v)
    name = f"flash_fwd_int8_{quant}_lse"
    before = dict(fa.launch_counts)
    got, lse = fa.flash_attention_with_stats(q, k, v, k_lens=kl, quant=quant, static_max=False)
    assert fa.launch_counts[name] == before[name] + 1
    assert fa.launch_counts[f"flash_fwd_int8_{quant}"] == before[f"flash_fwd_int8_{quant}"]
    want, want_lse = fa._flash_int8_plain(q8, k8, v_in, sqk, kl, quant=quant, sv=sv,
                                          block_k=fa.jax_key_block(l, fa.STATS_BLOCK_K),
                                          out_dtype=torch.bfloat16, with_lse=True)
    assert got.dtype == torch.bfloat16 and lse.shape == (b, l, n)
    assert _rel(got, want) < REL_TOL, _rel(got, want)
    assert float((lse - want_lse.transpose(1, 2)).abs().max()) < 1e-3
    # the output equals the kernel's without the LSE write
    out = fa._flash_int8_cuda(q8, k8, v_in, sqk, kl, quant=quant, sv=sv,
                              pv_block=fa.jax_key_block(l, fa.STATS_BLOCK_K))
    assert torch.equal(out, got)


@pytest.mark.parametrize("pv_block", [1536, 1024, 256, 64, 192])
def test_k2v_qkpv_kernel_on_any_block(gen, pv_block):
    """The qkpv kernel quantises P on the block it is given (a first sweep
    per block takes the row max) and agrees with the plain version on the
    same block; ragged keys end inside a block, and blocks of 64 and 192
    keys split the kernel's 128-key tiles."""
    b, l, n, d = 2, 4000, 2, 128
    q, k, v = (_randn(gen, b, l, n, d) for _ in range(3))
    kl = torch.tensor([3333, 4000], dtype=torch.int32, device="cuda")
    q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
    v8, sv = fa.quantize_v(v)
    got = fa._flash_int8_cuda(q8, k8, v8, sqk, kl, quant="qkpv", sv=sv, pv_block=pv_block)
    want = fa._flash_int8_plain(q8, k8, v8, sqk, kl, quant="qkpv", sv=sv, block_k=pv_block,
                                out_dtype=torch.bfloat16)
    assert _rel(got, want) < REL_TOL, _rel(got, want)
    assert float((got.float() - want.float()).abs().max()) < 6e-2


def _rope(l, d):
    """A packed split-pair table of at least l positions (an F x 32 x 32
    grid, F >= 3: at least 3072)."""
    table = pack_split(rope_freqs_3d((max(3, -(-l // 1024)), 32, 32), d, device="cuda"))
    assert table.shape[0] >= l
    return table


# D 64 and 128; L odd, q and k of other lengths, both shorter than the table
ROPE_PASS_CASES = [(2, 2049, 777, 3, 64), (1, 1001, 3001, 2, 128)]


@pytest.mark.parametrize("b,lq,lk,n,d", ROPE_PASS_CASES)
def test_rope_rotate_kernel_matches_plain_exactly(gen, b, lq, lk, n, d):
    """`sa_rope_rotate` equals `rope_apply_split(x, table[:L]).to(bf16)`
    bit for bit (no fused multiply-add, one rounding to nearest even), q by
    the table's rows [0, Lq) and k by [0, Lk), in one launch."""
    q, k = _randn(gen, b, lq, n, d) * 8, _randn(gen, b, lk, n, d) * 8
    rope = _rope(max(lq, lk), d)
    before = fa.launch_counts["rope_rotate"]
    qr, kr = fa.rope_rotate(q, k, rope)
    assert fa.launch_counts["rope_rotate"] == before + 1
    assert torch.equal(qr, fa._rope_rows(q, rope)) and torch.equal(kr, fa._rope_rows(k, rope))


@pytest.mark.parametrize("b,lq,lk,n,d", ROPE_PASS_CASES)
def test_rope_finalize_kernel_matches_plain_exactly(gen, b, lq, lk, n, d):
    """`sa_rope_finalize_bwd` equals the plain finalize bit for bit: fp32
    dQ and dK inverse-rotated (`rope_apply_split_inv`) and rounded once, dV
    rounded as it is."""
    dq = torch.randn((b, lq, n, d), generator=gen, device="cuda") * 3
    dk, dv = (torch.randn((b, lk, n, d), generator=gen, device="cuda") * 3 for _ in range(2))
    rope = _rope(max(lq, lk), d)
    before = fa.launch_counts["rope_finalize_bwd"]
    got = fa._rope_finalize_cuda(dq, dk, dv, rope)
    assert fa.launch_counts["rope_finalize_bwd"] == before + 1
    for a, w in zip(got, fa._rope_finalize_plain(dq, dk, dv, rope, torch.bfloat16)):
        assert torch.equal(a, w)


# K4-rope's partials: split queries (the first two) and one split with
# ragged keys (512 key blocks: batch 0's blocks past 5000 write zero partials)
@pytest.mark.parametrize("b,l,n,d,k_lens", [(2, 3000, 2, 128, [2500, 3000]),
                                            (1, 2100, 3, 64, None),
                                            (2, 8192, 4, 64, [5000, 8192])])
def test_k1_rope_and_k4_rope_match_plain(gen, b, l, n, d, k_lens):
    """`flash_attention(rope=)` forward, with stats and under autograd:
    K1-rope (with and without its LSE) equals the rotation in PyTorch
    followed by K1 exactly and its plain version within the bounds;
    K4-rope's dV equals the fused K4's on the rotated inputs exactly, and
    its dQ / dK stay within the bounds of the plain backward (on the same
    rotated q and k, dQ and dK inverse-rotated in fp32)."""
    q, k, v, g = (_randn(gen, b, l, n, d) for _ in range(4))
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    rope = _rope(l, d)
    scale = d ** -0.5
    before = dict(fa.launch_counts)
    out = fa.flash_attention(q, k, v, k_lens=kl, rope=rope)
    out_stats, lse = fa.flash_attention_with_stats(q, k, v, k_lens=kl, rope=rope)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out_grad = fa.flash_attention(qg, kg, vg, k_lens=kl, rope=rope)
    out_grad.backward(g)
    counts = {name: fa.launch_counts[name] - before[name] for name in before}
    assert {name: c for name, c in counts.items() if c} == {
        "rope_rotate": 3, "flash_fwd_bf16": 1, "flash_fwd_bf16_lse": 2, "flash_bwd": 1,
        "rope_finalize_bwd": 1}

    qr, kr = fa._rope_rows(q, rope), fa._rope_rows(k, rope)
    assert torch.equal(out, fa._flash_fwd_cuda(qr, kr, v, kl, scale))
    k1_out, k1_lse = fa._flash_fwd_cuda(qr, kr, v, kl, scale, with_lse=True)
    assert torch.equal(out_stats, k1_out) and torch.equal(lse, k1_lse.transpose(1, 2))
    assert torch.equal(out_grad.detach(), k1_out)
    want_out, want_lse = fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True, rope=rope)
    assert _rel(out, want_out) < REL_TOL and _rel(out_stats, want_out) < REL_TOL
    assert float((lse - want_lse.transpose(1, 2)).abs().max()) < 1e-3
    assert torch.equal(vg.grad, fa._flash_bwd_cuda(qr, kr, v, kl, k1_out, k1_lse, g, scale)[2])
    want = fa._flash_bwd_plain(qr, kr, v, kl, want_out, want_lse, g, scale, rope=rope)
    for a, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert _rel(a, w) < REL_TOL, _rel(a, w)


def test_attention_rotates_before_k1(gen):
    """`attention(rope=)` on the bf16 path keeps the JAX package's
    dispatch: the rotation in PyTorch, then K1 (no `rope_rotate` launch)."""
    b, l, n, d = 1, 2048, 2, 128
    q, k, v = (_randn(gen, b, l, n, d) for _ in range(3))
    rope = _rope(l, d)[:l]
    before = dict(fa.launch_counts)
    out = attention(q, k, v, rope=rope)
    assert fa.launch_counts["flash_fwd_bf16"] == before["flash_fwd_bf16"] + 1
    assert fa.launch_counts["rope_rotate"] == before["rope_rotate"]
    assert _rel(out, fa._flash_fwd_plain(q, k, v, rope=rope)) < REL_TOL


# ragged M and N, K % 128 == 64, and the DiT's linears (21504 tokens: 1536 ->
# 8960 and 8960 -> 1536)
@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (300, 192, 80), (130, 1536, 144),
                                   (21504, 1536, 8960), (21504, 8960, 1536)])
@pytest.mark.parametrize("epilogue", probes.EPILOGUES)
def test_mm_probe_matches_plain(gen, m, k, n, epilogue):
    """The GEMM probe on ragged M and N and at the DiT's linear shapes: int8
    epilogues exactly (sums up to 8960 * 127^2, beyond fp32's 2^24), bf16
    within rel-L2 1e-2."""
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    if epilogue == "bf16":
        a, b = a.bfloat16(), b.bfloat16()
    else:
        a = (a * 60).clamp(-127, 127).to(torch.int8)
        b = (b * 60).clamp(-127, 127).to(torch.int8)
    name = f"mm_probe_{epilogue}"
    before = probes.launch_counts[name]
    got = probes.mm_probe(a, b, epilogue)
    assert probes.launch_counts[name] == before + 1
    want = probes._mm_plain(a, b, epilogue)
    assert got.dtype == want.dtype and got.shape == (m, n)
    if epilogue == "bf16":
        assert _rel(got, want) < REL_TOL
    else:
        assert torch.equal(got, want)
        if m * k * n <= 1e8:  # the CPU's int32 product: small shapes only
            assert torch.equal(got.cpu(), probes.mm_probe(a.cpu(), b.cpu(), epilogue))


# S3 on the wgmma template's tile edges (128 query rows, 128-key tiles):
# ragged L 200, 700, 1000 and 3000, D 64 and 128
@pytest.mark.parametrize("bh,l,d", [(3, 1000, 128), (2, 700, 64), (2, 200, 128), (2, 200, 64),
                                    (1, 3000, 128), (1, 3000, 64)])
@pytest.mark.parametrize("int8", [False, True])
def test_dots_probe_matches_plain(gen, bh, l, d, int8):
    q, k, v = (torch.randn((bh, l, d), generator=gen, device="cuda") for _ in range(3))
    if int8:
        q, k = ((x * 10).to(torch.int8) for x in (q, k))
    else:
        q, k = q.bfloat16(), k.bfloat16()
    v = v.bfloat16()
    name = f"dots_probe_{'int8' if int8 else 'bf16'}"
    before = probes.launch_counts[name]
    got = probes.dots_probe(q, k, v, int8=int8)
    assert probes.launch_counts[name] == before + 1
    assert _rel(got, probes._dots_plain(q, k, v, int8)) < REL_TOL


def test_new_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 1, 2048, 2, 128)
    rope = _rope(2048, 128)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, rope=rope.double())
    with pytest.raises(ValueError, match="rope"):
        fa.flash_attention(q, q, q, rope=rope[:1000])
    with pytest.raises(ValueError, match="rope"):
        fa.flash_attention(q, q, q, rope=rope.cpu())
    a8 = torch.zeros((128, 96), dtype=torch.int8, device="cuda")
    b8 = torch.zeros((96, 128), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="K % 64"):
        probes.mm_probe(a8, b8, "int8")
    wide = torch.zeros((128, 256), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        probes.mm_probe(wide[:, :128], wide[:, :128], "int8")
    with pytest.raises(TypeError):
        probes.mm_probe(a8.bfloat16(), b8.bfloat16(), "requant")
    odd = torch.zeros((2, 128, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        probes.dots_probe(odd, odd, odd)
    with pytest.raises(ValueError, match="device"):
        probes.dots_probe(odd, odd, odd.cpu())


@pytest.mark.parametrize("attn_quant", ["none", "qk"])
def test_streamed_dit_equals_in_memory_on_cuda(gen, attn_quant):
    """The host-streamed DiT on the card: pinned host blocks, the side-stream
    copies into two slots; three calls in a row equal `dit_forward` bit for
    bit (2,304 tokens, so the blocks take K1, or K2 and K5)."""
    from stableavatar_tpu_torch.config import DiTConfig
    from stableavatar_tpu_torch.models.dit import dit_forward, init_dit
    from stableavatar_tpu_torch.models.streaming import StreamedDiT
    from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=5, audio_proj_dim=256,
                    vocal_num_heads=2)
    params = init_dit(gen, cfg, "cuda", torch.bfloat16)
    fast = attn_quant != "none"
    if fast:
        params = prepare_fast_params(params, cfg, quant=True)
    x = _randn(gen, 3, 16, 9, 32, 32).bfloat16()
    y = _randn(gen, 3, 20, 9, 32, 32).bfloat16()
    args = (x, torch.full((3,), 500.0, device="cuda"), _randn(gen, 3, cfg.text_len, cfg.text_dim),
            _randn(gen, 3, cfg.clip_tokens, cfg.clip_dim), y, _randn(gen, 1, 66, cfg.audio_in_dim))
    kw = dict(video_sample_n_frames=33, vocal_cfg_tile=True)
    with torch.no_grad():
        want = dit_forward(params, cfg, *args, rope_split=fast, attn_quant=attn_quant, **kw)
        sdit = StreamedDiT(params, cfg, rope_split=fast, attn_quant=attn_quant, device="cuda")
        got = [sdit(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert sdit.host_blocks[0].flat.is_pinned()
    assert all(torch.equal(g, want) for g in got)


_INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _require_bits(got, want):
    """Equal bit for bit, NaN positions equal (a NaN's payload aside)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(_INT[got.dtype])[~nan], want.view(_INT[want.dtype])[~nan])


def _launches(fn, fwd, bwd=0):
    """fn() with exactly `fwd` forward and `bwd` backward GELU launches."""
    before = dict(act.launch_counts)
    out = fn()
    assert act.launch_counts == {"gelu_tanh": before["gelu_tanh"] + fwd,
                                 "gelu_tanh_bwd": before["gelu_tanh_bwd"] + bwd}
    return out


def _autograd_plain(x, g):
    xg = x.clone().requires_grad_()
    return torch.autograd.grad(act._gelu_tanh_plain(xg), xg, g)[0]


def _every_bf16():
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device="cuda").to(torch.int16)
    return bits.view(torch.bfloat16)


def test_gelu_tanh_exact_over_every_bf16(gen):
    """Every bf16 bit pattern as x, forward and in place; and its gradient
    against 64 output gradients each (0, +-1, large, subnormal, random)."""
    x = _every_bf16().reshape(-1, 8)
    want = act._gelu_tanh_plain(x)
    y = x.clone()
    _require_bits(_launches(lambda: act.gelu_tanh(y), 1), want)
    _require_bits(y, want)  # in place
    g = torch.tensor([0.0, -0.0, 1.0, -1.0, 3e38, -3e38, 1e-39, -1e-39], device="cuda")
    g = torch.cat([g, torch.randn((56,), generator=gen, device="cuda") * 4]).bfloat16()
    xs, gs = x.reshape(-1, 1).expand(-1, 64).contiguous(), g.expand(2 ** 16, -1).contiguous()
    _require_bits(_launches(lambda: act._gelu_tanh_bwd_cuda(xs, gs), 0, 1),
                  _autograd_plain(xs, gs))


def test_gelu_tanh_exact_in_fp32(gen):
    """fp32: every bf16 value and 2^22 random ones at four scales, forward
    and against autograd through the composition."""
    x = torch.cat([_every_bf16().float()] + [
        torch.randn((2 ** 20,), generator=gen, device="cuda") * s for s in (0.01, 1, 4, 100)])
    g = torch.randn(x.shape, generator=gen, device="cuda")
    _require_bits(_launches(lambda: act.gelu_tanh(x.clone()), 1), act._gelu_tanh_plain(x))
    _require_bits(_launches(lambda: act._gelu_tanh_bwd_cuda(x, g), 0, 1), _autograd_plain(x, g))


# the DiT's FFN products at 1.3B and 14B (3 CFG rows of 21,504 tokens), and
# element counts no multiple of a block's vectors nor of a vector
@pytest.mark.parametrize("rows,c", [(64512, 8960), (64512, 13824), (1000, 263), (3, 5)])
def test_gelu_tanh_exact_at_ffn_shapes(gen, rows, c):
    x = _randn(gen, rows, c) * 2
    want = act._gelu_tanh_plain(x)
    _require_bits(_launches(lambda: act._gelu_tanh_cuda(x, torch.empty_like(x)), 1), want)
    ptr = x.data_ptr()
    out = _launches(lambda: act.gelu_tanh(x), 1)
    assert out.data_ptr() == ptr  # in place
    _require_bits(out, want)
    del want, out
    x, g = _randn(gen, rows, c) * 2, _randn(gen, rows, c)
    _require_bits(_launches(lambda: act._gelu_tanh_bwd_cuda(x, g), 0, 1), _autograd_plain(x, g))
    xf = x[: max(1, rows // 8)].float()
    _require_bits(_launches(lambda: act.gelu_tanh(xf.clone()), 1), act._gelu_tanh_plain(xf))


def test_gelu_tanh_refuses_on_cuda(gen):
    """A CUDA tensor the kernel does not take raises: fp16, fp64, strided,
    not 16-byte aligned."""
    x = _randn(gen, 64, 24)
    for bad, error in ((x.half(), TypeError), (x.double(), TypeError), (x[:, :12], ValueError),
                       (x.reshape(-1)[1:], ValueError)):
        with pytest.raises(error):
            _launches(lambda: act.gelu_tanh(bad), 0)
        with pytest.raises(error):
            _launches(lambda: act.gelu_tanh(bad.detach().requires_grad_()), 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_tanh_under_autograd_on_cuda(gen, dtype):
    """Under a gradient the kernel runs forward and backward, and values and
    gradients equal autograd through the composition, also under
    non-reentrant checkpointing (the DiT's remat) with fc1 and fc2 around."""
    x = (_randn(gen, 3, 300, 256) * 2).to(dtype)
    g = _randn(gen, 3, 300, 256).to(dtype)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = _launches(lambda: act.gelu_tanh(xa), 1)
    _require_bits(out.detach(), act._gelu_tanh_plain(x))
    assert torch.equal(xa.detach(), x)  # a graph through the call: nothing overwritten
    got = _launches(lambda: torch.autograd.grad(out, xa, g)[0], 0, 1)
    _require_bits(got, torch.autograd.grad(act._gelu_tanh_plain(xb), xb, g)[0])

    p1 = {"w": (_randn(gen, 512, 256) * 0.06).to(dtype), "b": _randn(gen, 512).to(dtype)}
    p2 = {"w": (_randn(gen, 256, 512) * 0.04).to(dtype), "b": _randn(gen, 256).to(dtype)}
    leaves = [t.requires_grad_() for t in (p1["w"], p1["b"], p2["w"], p2["b"])]

    def ffn(gelu):
        return lambda h: apply_linear(p2, gelu(apply_linear(p1, h)))

    grads = []
    for gelu in (act.gelu_tanh, act._gelu_tanh_plain):
        h = x.clone().requires_grad_()
        y = checkpoint(ffn(gelu), h, use_reentrant=False)
        grads.append([y.detach(), *torch.autograd.grad(y, [h, *leaves], g)])
    for a, b in zip(*grads):
        _require_bits(a, b)


@pytest.mark.parametrize("form", ["float", "int8", "w8a8"])
def test_gelu_tanh_after_each_linear_form_on_cuda(gen, form):
    w = torch.randn((1024, 256), generator=gen, device="cuda") * 256 ** -0.5
    p = {"w": w.bfloat16()} if form == "float" else (
        {"w": quantize_weight(w)} if form == "int8" else {"w8": quantize_weight_for_compute(w)})
    p["b"] = _randn(gen, 1024)
    x = _randn(gen, 3, 300, 256)
    with torch.no_grad():
        got = _launches(lambda: act.gelu_tanh(apply_linear(p, x)), 1)
        _require_bits(got, act._gelu_tanh_plain(apply_linear(p, x)))


def test_dit_with_the_gelu_kernel_equals_the_composition(gen, monkeypatch):
    """dit_forward on the card with the kernel, against the same call with
    every FFN on the composition: equal bit for bit; one launch for each
    block, the text embedding and each vocal projector block."""
    from stableavatar_tpu_torch.config import DiTConfig
    from stableavatar_tpu_torch.models import dit as dit_mod
    from stableavatar_tpu_torch.models import vocal_projector as vp

    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=5, audio_proj_dim=256,
                    vocal_num_heads=2)
    params = dit_mod.init_dit(gen, cfg, "cuda", torch.bfloat16)
    x = _randn(gen, 3, 16, 9, 32, 32)
    y = _randn(gen, 3, 20, 9, 32, 32)
    args = (x, torch.full((3,), 500.0, device="cuda"), _randn(gen, 3, cfg.text_len, cfg.text_dim),
            _randn(gen, 3, cfg.clip_tokens, cfg.clip_dim), y, _randn(gen, 1, 66, cfg.audio_in_dim))
    kw = dict(video_sample_n_frames=33, vocal_cfg_tile=True)
    with torch.no_grad():
        got = _launches(lambda: dit_mod.dit_forward(params, cfg, *args, **kw),
                        cfg.num_layers + 1 + cfg.vocal_num_layers)
        for mod in (dit_mod, vp):
            monkeypatch.setattr(mod, "gelu_tanh", act._gelu_tanh_plain)
        want = _launches(lambda: dit_mod.dit_forward(params, cfg, *args, **kw), 0)
    assert torch.equal(got, want)
