"""The FFN's tanh GELU on the CPU: `ops/activations.py:gelu_tanh`.

On the CPU `gelu_tanh` runs the op-for-op composition, so it must equal
`_gelu_tanh_plain` bit for bit and leave the kernels' counters alone.  The
cases also hold what the card's wrappers check before a launch (everything
but the device is visible here), the arguments they hand the C entry
points, and the order of the backward that `sa_gelu_tanh_bwd` computes:
autograd's through the composition, op for op.
"""

import math

import pytest
import torch

from stableavatar_tpu_torch.models import vocal_projector as vp
from stableavatar_tpu_torch.ops import activations as act
from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.utils.quantization import quantize_weight, quantize_weight_for_compute


_INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(_INT[a.dtype]), b.view(_INT[b.dtype]))


def _bits_equal_nan(a, b):
    """Equal bit for bit where b is a number, NaN where b is NaN."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and _bits_equal(a[~nan], b[~nan])


def _every_bf16():
    return torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


def grad_by_hand(x, g):
    """x's gradient through `_gelu_tanh_plain` as `sa_gelu_tanh_bwd` computes
    it: the forward's intermediates, each op's backward rounded to x's dtype,
    and x's five terms summed in the order autograd adds them."""
    c0, c1 = act._const(math.sqrt(2 / math.pi), x), act._const(0.044715, x)
    a = x * x
    c = x * a
    e = x + c1 * c
    t = torch.tanh(c0 * e)
    i = 0.5 * (1.0 + t)
    gx_out = g * i
    gh = (g * x) * 0.5
    ge = torch.ops.aten.tanh_backward(gh, t) * c0
    gc = ge * c1
    gx_a = (gc * x) * x
    return (((gx_out + ge) + gc * a) + gx_a) + gx_a


def _linear(gen, d_in, d_out, form):
    w = torch.randn((d_out, d_in), generator=gen) * d_in ** -0.5
    b = torch.randn((d_out,), generator=gen).bfloat16()
    if form == "float":
        return {"w": w.bfloat16(), "b": b}
    if form == "int8":
        return {"w": quantize_weight(w), "b": b}
    return {"w8": quantize_weight_for_compute(w), "b": b}


def _untouched(fn):
    """fn() with the launch counters unchanged."""
    before = dict(act.launch_counts)
    out = fn()
    assert act.launch_counts == before
    return out


def _plain_case(dtype):
    def case(gen, monkeypatch):
        x = torch.cat([_every_bf16().to(dtype), torch.randn((999,), generator=gen).to(dtype)])
        x = x.reshape(-1, 7)
        kept = x.clone()
        got = _untouched(lambda: act.gelu_tanh(x))
        assert _bits_equal_nan(got, act._gelu_tanh_plain(kept))
        assert _bits_equal(x, kept)  # the CPU composition writes nothing over x
    return case


def case_constants(gen, monkeypatch):
    for dt in (torch.bfloat16, torch.float32):
        x = torch.zeros((), dtype=dt)
        assert act.CONSTS[dt] == (float(act._const(math.sqrt(2 / math.pi), x)),
                                  float(act._const(0.044715, x)))


def case_entry_arguments(gen, monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(act, "launch_counts", {"gelu_tanh": 0, "gelu_tanh_bwd": 0})
    want = []
    for dt, fp32 in ((torch.bfloat16, 0), (torch.float32, 1)):
        x = torch.randn((2, 3, 21), generator=gen).to(dt)
        out = torch.empty_like(x)
        assert act._gelu_tanh_cuda(x, out) is out
        assert act._gelu_tanh_cuda(x, x) is x
        dx = act._gelu_tanh_bwd_cuda(x, out)
        assert dx.shape == x.shape and dx.dtype == dt
        want += [("sa_gelu_tanh", (x.data_ptr(), out.data_ptr(), 126, fp32, *act.CONSTS[dt])),
                 ("sa_gelu_tanh", (x.data_ptr(), x.data_ptr(), 126, fp32, *act.CONSTS[dt])),
                 ("sa_gelu_tanh_bwd", (x.data_ptr(), out.data_ptr(), dx.data_ptr(), 126, fp32,
                                       *act.CONSTS[dt]))]
    assert calls == want
    assert act.launch_counts == {"gelu_tanh": 4, "gelu_tanh_bwd": 2}


def _refusal(make, error):
    """The card's wrappers refuse what `make` builds before any launch."""
    def case(gen, monkeypatch):
        monkeypatch.setattr(cuda_lib, "launch", lambda *a: pytest.fail("launched"))
        x, other = make(gen)
        with pytest.raises(error):
            act._gelu_tanh_cuda(x, torch.empty_like(x) if other is None else other)
        with pytest.raises(error):
            act._gelu_tanh_bwd_cuda(x, x.clone() if other is None else other)
    return case


def _wide(gen):
    return torch.randn((6, 32), generator=gen).bfloat16()


def case_empty(gen, monkeypatch):
    monkeypatch.setattr(cuda_lib, "launch", lambda *a: pytest.fail("launched"))
    x = torch.empty((0, 16), dtype=torch.bfloat16)
    out = torch.empty_like(x)
    assert _untouched(lambda: act._gelu_tanh_cuda(x, out)) is out
    assert _untouched(lambda: act._gelu_tanh_bwd_cuda(x, out)).shape == (0, 16)


def _backward_case(dtype):
    def case(gen, monkeypatch):
        if dtype == torch.bfloat16:
            x = _every_bf16().repeat(3)
            g = torch.cat([torch.ones(2 ** 16), torch.randn((2 ** 17,), generator=gen) * 3])
        else:
            x = torch.randn((64000,), generator=gen) * 4
            g = torch.randn((64000,), generator=gen)
        x, g = x.to(dtype).reshape(-1, 64), g.to(dtype).reshape(-1, 64)
        xg = x.clone().requires_grad_()
        (want,) = torch.autograd.grad(act._gelu_tanh_plain(xg), xg, g)
        assert _bits_equal_nan(grad_by_hand(x, g), want)
    return case


def case_autograd_function(gen, monkeypatch):
    # `_GeluTanh` with the launches replaced by their CPU equivalents: the
    # forward's x saved, the backward handed a contiguous g
    seen = []

    def bwd(x, g):
        seen.append(g.is_contiguous())
        return grad_by_hand(x, g)

    monkeypatch.setattr(act, "_gelu_tanh_cuda", lambda x, out: out.copy_(act._gelu_tanh_plain(x)))
    monkeypatch.setattr(act, "_gelu_tanh_bwd_cuda", bwd)
    x = torch.randn((5, 24), generator=gen).bfloat16()
    g = torch.randn((24, 5), generator=gen).bfloat16().t()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = act._GeluTanh.apply(xa), act._gelu_tanh_plain(xb)
    assert _bits_equal(got.detach(), want.detach())
    assert _bits_equal(torch.autograd.grad(got, xa, g)[0], torch.autograd.grad(want, xb, g)[0])
    assert seen == [True]


def _linear_grad_case(form):
    def case(gen, monkeypatch):
        # fc1 of each weight form, then the GELU as the FFN calls it, under a
        # gradient: the same values and gradients as the composition
        p = _linear(gen, 32, 48, form)
        x = torch.randn((2, 7, 32), generator=gen).bfloat16().requires_grad_()
        g = torch.randn((2, 7, 48), generator=gen).bfloat16()
        outs = [_untouched(lambda: act.gelu_tanh(vp.apply_linear(p, x))),
                act._gelu_tanh_plain(vp.apply_linear(p, x))]
        grads = [torch.autograd.grad(out, x, g)[0] for out in outs]
        assert _bits_equal(outs[0].detach(), outs[1].detach())
        assert _bits_equal(*grads)
    return case


CASES = {
    "plain_bf16": _plain_case(torch.bfloat16),
    "plain_fp32": _plain_case(torch.float32),
    "constants": case_constants,
    "entry_arguments": case_entry_arguments,
    "refuses_fp16": _refusal(lambda gen: (_wide(gen).half(), None), TypeError),
    "refuses_mixed_dtypes": _refusal(lambda gen: (_wide(gen), _wide(gen).float()), TypeError),
    "refuses_strided": _refusal(lambda gen: (_wide(gen)[:, :16], None), ValueError),
    "refuses_misaligned": _refusal(lambda gen: (_wide(gen).reshape(-1)[1:], None), ValueError),
    "empty": case_empty,
    "backward_order_bf16": _backward_case(torch.bfloat16),
    "backward_order_fp32": _backward_case(torch.float32),
    "autograd_function": case_autograd_function,
    "linear_float": _linear_grad_case("float"),
    "linear_int8_storage": _linear_grad_case("int8"),
    "linear_w8a8": _linear_grad_case("w8a8"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gelu_tanh_on_cpu(case, monkeypatch):
    gen = torch.Generator().manual_seed(sorted(CASES).index(case))
    CASES[case](gen, monkeypatch)
