"""The port's CUDA kernels and their wrappers on the card.

Every test here is marked `cuda` and skips without a CUDA device.  This file
imports no JAX, so it runs on a machine with an H100 and no JAX, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Each kernel
is held against its plain PyTorch version in the same module at rel-L2 1e-2,
the bound `chip_smoke.py` uses: bf16 outputs, summed in another order, with P
rounded to bf16 at other places.  K1's and K3's LSE (fp32, from fp32 row
statistics) are held to max-abs 1e-3.  K2v-qkpv is held against its plain
version at the kernel's key tile of 64 (its result depends on the tile).
"""

import pytest
import torch

from stableavatar_tpu_torch.ops import cross_attention as ca
from stableavatar_tpu_torch.ops import flash_attention as fa
from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.utils.quantization import int8_linear, quantize_weight_for_compute

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


@pytest.mark.parametrize("b,l,n,d,k_lens", [(2, 3000, 2, 128, [2500, 3000]),
                                            (1, 2100, 3, 64, None)])
def test_flash_kernels_match_plain(gen, b, l, n, d, k_lens):
    q, k, v = (_randn(gen, b, l, n, d) for _ in range(3))
    kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
    before = dict(fa.launch_counts)
    out = fa.flash_attention(q, k, v, k_lens=kl)
    assert _rel(out, fa._flash_fwd_plain(q, k, v, kl)) < REL_TOL
    out = fa.flash_attention(q, k, v, k_lens=kl, quant="qk")
    q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
    assert _rel(out, fa._flash_int8_plain(q8, k8, v, sqk, kl)) < REL_TOL
    assert fa.launch_counts["flash_fwd_bf16"] == before["flash_fwd_bf16"] + 1
    assert fa.launch_counts["flash_fwd_int8_qk"] == before["flash_fwd_int8_qk"] + 1


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", [(2, 3000, 3000, 2, 128, [2500, 3000]),
                                               (1, 2100, 2100, 3, 64, None),
                                               (1, 2048, 77, 2, 128, None),
                                               (2, 700, 257, 2, 64, [200, 257])])
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
    assert fa.launch_counts["flash_bwd_dkdv"] == before["flash_bwd_dkdv"] + 1
    assert fa.launch_counts["flash_bwd_dq"] == before["flash_bwd_dq"] + 1


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
    assert fa.launch_counts["flash_bwd_dkdv"] == before["flash_bwd_dkdv"] + 1
    assert fa.launch_counts["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
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


def test_dual_context_kernel_matches_plain(gen):
    b, l, n, d = 2, 3000, 2, 128
    q = _randn(gen, b, l, n, d)
    k1, v1 = _randn(gen, b, 77, n, d), _randn(gen, b, 77, n, d)
    k2, v2 = _randn(gen, b, 33, n, d), _randn(gen, b, 33, n, d)
    before = ca.launch_counts["dual_context"]
    out = ca.dual_context_attention(q, k1, v1, k2, v2)
    assert _rel(out, ca._dual_plain(q, k1, v1, k2, v2, d ** -0.5)) < REL_TOL
    assert ca.launch_counts["dual_context"] == before + 1


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
    with pytest.raises(NotImplementedError, match="K2-LSE"):
        fa.flash_attention_with_stats(q, q, q, quant="qkv")
    q8, k8, sqk = fa.prepare_int8(q, q, None, 128 ** -0.5)
    v8, sv = fa.quantize_v(q)
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
        want = fa._flash_int8_plain(q8, k8, v_in, sqk, kl, quant=quant, sv=sv, block_k=64,
                                    out_dtype=torch.bfloat16)
    assert _rel(got, want) < REL_TOL, _rel(got, want)
    assert float((got.float() - want.float()).abs().max()) < 6e-2
