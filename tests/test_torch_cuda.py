"""The port's CUDA kernels and their wrappers on the card.

Every test here is marked `cuda` and skips without a CUDA device.  This file
imports no JAX, so it runs on a machine with an H100 and no JAX, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Each kernel
is held against its plain PyTorch version in the same module at rel-L2 1e-2,
the bound `chip_smoke.py` uses: bf16 outputs, summed in another order, with P
rounded to bf16 at other places.
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
    """Long queries take the flash kernel; short ones SDPA (no launch)."""
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
    with pytest.raises(NotImplementedError, match="K2v"):
        fa.flash_attention(q, q, q, quant="qkv")
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
