"""Flash attention: kernels K1 (bf16 forward, optional LSE), K2 (int8 Q.K^T
forward) and K4 (the bf16 backward).

Port of `stableavatar_tpu/ops/flash_attention.py`.  On a CUDA tensor
`flash_attention` launches a hand-written Hopper kernel
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`); on a CPU tensor
it runs the plain PyTorch version beside it (`_flash_fwd_plain`,
`_flash_int8_plain`, `_flash_bwd_plain`).  There is no other path: a CUDA
call that the kernels do not take raises.

The bf16 path is differentiable like the JAX package's custom-VJP `_flash`:
with grad enabled and an input that requires grad, the forward launches K1
with its natural-log LSE and the backward launches K4a (dK, dV) and K4b
(dQ), which recompute P from that LSE.  Otherwise K1 runs without the LSE
write, as the JAX primal does.  The int8 paths are not differentiable.

Semantics kept from the JAX package: q/k/v [B, L, N, D]; keys at or past
`k_lens[b]` are masked with -1e30; the online softmax runs in base 2 with
log2(e) folded into the scale; P is rounded to the value dtype before P.V;
the row sum is guarded with max(l, 1e-30).  For `quant != "none"` q and k
are roped (split-pair layout) in fp32 and quantised to int8 with ONE absmax
scale per (batch, head) over the whole sequence (`_quant_slab`), and the
kernel multiplies the int32 logits by sqk = sq * sk * scale * log2(e).

The plain versions reproduce the kernels' arithmetic exactly where it is
exact (int8 products are integers, exact in fp32 up to 2^24; bf16 products
are exact in fp32) and walk the keys in blocks with the same online
softmax; they process queries in chunks so no [B, N, Lq, Lk] logit tensor is
ever materialised (66 GB at the 21,504-token DiT window).
"""

from __future__ import annotations

from typing import Optional

import torch

from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.ops.rope import rope_apply_split

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# kernel launches, counted where each wrapper launches its kernel; K1 with
# and without its LSE output count apart
launch_counts = {"flash_fwd_bf16": 0, "flash_fwd_bf16_lse": 0, "flash_fwd_int8_qk": 0,
                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

# bytes of fp32 logits one plain-version chunk may hold
_PLAIN_CHUNK_BYTES = 1 << 30


def _quant_slab(x: torch.Tensor):
    """[B, L, N, D] fp32 -> (int8, scales [B, N] fp32): one absmax scale per
    (batch, head) slab; round half to even like jnp.round."""
    s = torch.clamp(x.abs().amax(dim=(1, 3)) * (1.0 / 127.0), min=1e-10)
    q = torch.clamp(torch.round(x / s[:, None, :, None]), -127.0, 127.0).to(torch.int8)
    return q, s


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 arithmetic of the plain versions (fp64 for fp64 inputs, which
    gradcheck uses)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _online_softmax_plain(logits_fn, k_lens, lq, lk, block_k, out_shape,
                          pv_fn, device, dtype=torch.float32, with_lse=False):
    """Shared plain loop: query chunks x key blocks with the kernels' online
    base-2 softmax.  logits_fn(q0, q1, k0, k1) -> [B, N, qc, kc] base-2
    logits; pv_fn(s, m_cur, m_new, k0, k1) -> (pv [B, N, qc, D], row-sum
    term) for one block of masked logits s.  With `with_lse` it also returns
    the natural-log LSE [B, N, Lq], m * ln2 + log(max(l, 1e-30))."""
    b, n, _, d = out_shape
    qc = max(1, _PLAIN_CHUNK_BYTES // (4 * b * n * block_k))
    acc_out = torch.empty(out_shape, dtype=dtype, device=device)
    lse = torch.empty((b, n, lq), dtype=dtype, device=device) if with_lse else None
    cols = torch.arange(lk, device=device)
    klens = (torch.full((b,), lk, device=device) if k_lens is None
             else k_lens.to(device=device, dtype=torch.int64))
    for q0 in range(0, lq, qc):
        q1 = min(lq, q0 + qc)
        m = torch.full((b, n, q1 - q0, 1), NEG_INF, dtype=dtype, device=device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n, q1 - q0, d), dtype=dtype, device=device)
        for k0 in range(0, lk, block_k):
            k1 = min(lk, k0 + block_k)
            s = logits_fn(q0, q1, k0, k1)
            valid = cols[None, k0:k1] < klens[:, None]  # [B, kc]
            s = torch.where(valid[:, None, None, :], s, NEG_INF)
            m_cur = s.amax(dim=-1, keepdim=True)
            m_new = torch.maximum(m, m_cur)
            corr = torch.exp2(m - m_new)
            pv, rowsum = pv_fn(s, m_cur, m_new, k0, k1)
            l = corr * l + rowsum
            acc = acc * corr + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        acc_out[:, :, q0:q1] = acc / l
        if with_lse:
            lse[:, :, q0:q1] = (m * LN2 + torch.log(l))[..., 0]
    return (acc_out, lse) if with_lse else acc_out


def _flash_fwd_plain(q, k, v, k_lens=None, scale=None, block_k: int = 1024,
                     with_lse: bool = False):
    """Plain K1: bf16 (or fp32) flash forward, [B, L, N, D] in and out; with
    `with_lse` also the natural-log LSE [B, N, Lq] (fp32)."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    acc = _acc_dtype(q)
    qf = q.permute(0, 2, 1, 3).to(acc)
    kf = k.permute(0, 2, 1, 3).to(acc)
    vf = v.permute(0, 2, 1, 3).to(acc)
    eff = scale * LOG2E

    def logits(q0, q1, k0, k1):
        return (qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)) * eff

    def pv(s, m_cur, m_new, k0, k1):
        p = torch.exp2(s - m_new)
        return p.to(v.dtype).to(acc) @ vf[:, :, k0:k1], p.sum(-1, keepdim=True)

    res = _online_softmax_plain(logits, k_lens, lq, lk, min(block_k, lk),
                                (b, n, lq, d), pv, q.device, acc, with_lse)
    out, lse = res if with_lse else (res, None)
    out = out.to(q.dtype).permute(0, 2, 1, 3)
    return (out, lse) if with_lse else out


def _flash_bwd_plain(q, k, v, k_lens, out, lse, g, scale=None):
    """Plain K4: the flash backward from the forward's LSE [B, N, Lq], in
    chunks of queries so no [B, N, Lq, Lk] tensor is materialised.

    The arithmetic of the two TPU bodies: base-2 logits, p = exp2(s -
    lse * log2 e) with masked keys and rows with lse <= NEG_INF / 2 at 0,
    delta = rowsum(dO * O), ds = p * (dp - delta) * scale; P and dS are
    rounded to the input dtype before their products (dV = P^T dO,
    dK = dS^T Q, dQ = dS K).  Returns dq, dk, dv [B, L, N, D] in q's dtype."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    dt, acc = q.dtype, _acc_dtype(q)
    qf, kf, vf, gf, of = (x.permute(0, 2, 1, 3).to(acc) for x in (q, k, v, g, out))
    delta = (gf * of).sum(-1, keepdim=True)  # [B, N, Lq, 1]
    lse = lse.to(acc)[..., None]
    lse2 = lse * LOG2E
    live = lse > NEG_INF / 2
    klens = (torch.full((b,), lk, device=q.device) if k_lens is None
             else k_lens.to(device=q.device, dtype=torch.int64))
    valid = (torch.arange(lk, device=q.device)[None, :] < klens[:, None])[:, None, None, :]
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    qc = max(1, _PLAIN_CHUNK_BYTES // (4 * b * n * lk))
    for q0 in range(0, lq, qc):
        q1 = min(lq, q0 + qc)
        s = (qf[:, :, q0:q1] @ kf.transpose(-1, -2)) * (scale * LOG2E)
        s = torch.where(valid, s, NEG_INF)
        p = torch.where(live[:, :, q0:q1], torch.exp2(s - lse2[:, :, q0:q1]), 0.0)
        gc = gf[:, :, q0:q1]
        dv += p.to(dt).to(acc).transpose(-1, -2) @ gc
        dp = gc @ vf.transpose(-1, -2)
        ds = (p * (dp - delta[:, :, q0:q1]) * scale).to(dt).to(acc)
        dk += ds.transpose(-1, -2) @ qf[:, :, q0:q1]
        dq[:, :, q0:q1] = ds @ kf
    return tuple(x.to(dt).permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _flash_int8_plain(q8, k8, v, sqk, k_lens=None, quant: str = "qk", sv=None,
                      block_k: int = 1536, out_dtype=None):
    """Plain K2 and its off-slice variants on prepared int8 operands.

    q8/k8 int8 [B, L, N, D]; v [B, Lk, N, D] in the output dtype for "qk",
    int8 with per-channel scales `sv` [B, 1, N, D] for "qkv" / "qkpv";
    sqk [B*N] fp32 (sq * sk * scale * log2 e).  "qkpv" quantises P per row to
    its block max (as the TPU body does), so its result depends on block_k.
    out_dtype defaults to v's dtype (pass the unquantised V's for "qkv"/"qkpv").
    """
    b, lq, n, d = q8.shape
    lk = k8.shape[1]
    out_dtype = v.dtype if out_dtype is None else out_dtype
    qf = q8.permute(0, 2, 1, 3).float()
    kf = k8.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    sqk4 = sqk.reshape(b, n, 1, 1)

    def logits(q0, q1, k0, k1):
        # integer products: exact in fp32 (|q8 . k8| <= 127^2 * D < 2^24)
        return (qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)) * sqk4

    def pv(s, m_cur, m_new, k0, k1):
        vb = vf[:, :, k0:k1]
        if quant == "qkpv":
            p_rel = torch.exp2(s - m_cur)
            p8 = torch.clamp(torch.round(p_rel * 127.0), 0.0, 127.0)
            # int32 product of the TPU body; fp64 keeps it exact on any block
            prod = (p8.double() @ vb.double()).float()
            factor = torch.exp2(m_cur - m_new)
            return prod * (factor * (1.0 / 127.0)), p_rel.sum(-1, keepdim=True) * factor
        p = torch.exp2(s - m_new)
        pb = p.to(torch.bfloat16 if quant == "qkv" else v.dtype).float()
        return pb @ vb, p.sum(-1, keepdim=True)

    out = _online_softmax_plain(logits, k_lens, lq, lk, min(block_k, lk),
                                (b, n, lq, d), pv, q8.device)
    if quant in ("qkv", "qkpv"):
        out = out * sv.permute(0, 2, 1, 3)
    return out.to(out_dtype).permute(0, 2, 1, 3)


def prepare_int8(q, k, rope, scale):
    """K2 prep (plain torch ops, as they were XLA ops on the TPU): split rope
    in fp32, one absmax int8 scale per (batch, head), and
    sqk = sq * sk * scale * log2(e) [B*N]."""
    qf, kf = q.float(), k.float()
    if rope is not None:
        qf = rope_apply_split(qf, rope)
        kf = rope_apply_split(kf, rope)
    q8, sq = _quant_slab(qf)
    k8, sk = _quant_slab(kf)
    sqk = (sq * sk * (scale * LOG2E)).reshape(-1)
    return q8, k8, sqk


def quantize_v(v):
    """Per-channel int8 V for "qkv" / "qkpv": (v8, sv [B, 1, N, D])."""
    vf = v.float()
    sv = torch.clamp(vf.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0), min=1e-10)
    v8 = torch.clamp(torch.round(vf / sv), -127.0, 127.0).to(torch.int8)
    return v8, sv


def _check(name, t, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_cuda_common(q, k, v, k_lens):
    b, _, n, d = q.shape
    lk = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernels take 64 or 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    _check("v", v, torch.bfloat16, (b, lk, n, d))
    if k_lens is not None:
        _check("k_lens", k_lens, torch.int32, (b,))
        if k_lens.device != q.device:
            raise ValueError("k_lens must be on the same device as q")


def _flash_fwd_cuda(q, k, v, k_lens, scale, with_lse: bool = False):
    """K1; with `with_lse` returns (out, lse [B, N, Lq] fp32)."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check("q", q, torch.bfloat16)
    _check("k", k, torch.bfloat16, (b, lk, n, d))
    _check_cuda_common(q, k, v, k_lens)
    out = torch.empty_like(q)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=q.device) if with_lse else None
    cuda_lib.launch(
        "sa_flash_fwd_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_lens is None else k_lens.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, lq, lk, n, d, float(scale * LOG2E),
    )
    launch_counts["flash_fwd_bf16_lse" if with_lse else "flash_fwd_bf16"] += 1
    return (out, lse) if with_lse else out


def _flash_bwd_cuda(q, k, v, k_lens, out, lse, g, scale):
    """K4a then K4b: (dq, dk, dv) in bf16 from the forward's LSE."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check("q", q, torch.bfloat16)
    _check("k", k, torch.bfloat16, (b, lk, n, d))
    _check_cuda_common(q, k, v, k_lens)
    _check("dout", g, torch.bfloat16, (b, lq, n, d))
    _check("out", out, torch.bfloat16, (b, lq, n, d))
    _check("lse", lse, torch.float32, (b, n, lq))
    # delta = rowsum(dO * O) in fp32: a plain torch op, as on the TPU
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    kl = None if k_lens is None else k_lens.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), kl)
    dims = (b, lq, lk, n, d, float(scale), float(scale * LOG2E))
    cuda_lib.launch("sa_flash_bwd_dkdv", *args, dk.data_ptr(), dv.data_ptr(), *dims)
    launch_counts["flash_bwd_dkdv"] += 1
    cuda_lib.launch("sa_flash_bwd_dq", *args, dq.data_ptr(), *dims)
    launch_counts["flash_bwd_dq"] += 1
    return dq, dk, dv


def _flash_fwd_with_lse(q, k, v, k_lens, scale):
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, k_lens, scale, with_lse=True)
    return _flash_fwd_plain(q, k, v, k_lens, scale, with_lse=True)


class _Flash(torch.autograd.Function):
    """The custom VJP of the JAX package's `_flash` (flash_attention.py:967):
    forward K1 with LSE, backward K4 (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, scale):
        out, lse = _flash_fwd_with_lse(q, k, v, k_lens, scale)
        ctx.save_for_backward(q, k, v, k_lens, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_lens, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if q.is_cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, k_lens, out, lse, g, ctx.scale)
        else:
            dq, dk, dv = _flash_bwd_plain(q, k, v, k_lens, out, lse, g, ctx.scale)
        return dq, dk, dv, None, None


def _flash_int8_cuda(q8, k8, v, sqk, k_lens):
    b, lq, n, d = q8.shape
    lk = k8.shape[1]
    _check("q8", q8, torch.int8)
    _check("k8", k8, torch.int8, (b, lk, n, d))
    _check("sqk", sqk, torch.float32, (b * n,))
    _check_cuda_common(q8, k8, v, k_lens)
    out = torch.empty(q8.shape, dtype=torch.bfloat16, device=q8.device)
    cuda_lib.launch(
        "sa_flash_fwd_int8_qk", q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
        sqk.data_ptr(), None if k_lens is None else k_lens.data_ptr(),
        out.data_ptr(), b, lq, lk, n, d,
    )
    launch_counts["flash_fwd_int8_qk"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    k_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope: Optional[torch.Tensor] = None,
    quant: str = "none",
) -> torch.Tensor:
    """q [B, Lq, N, D], k/v [B, Lk, N, D] -> [B, Lq, N, D].

    quant: "none" (K1) | "qk" (K2) | "qkv" | "qkpv".  rope: packed split-pair
    [L, D] table; on the bf16 path it is applied before the kernel, on the
    int8 path inside the quantisation prep.  On CUDA only "none" and "qk"
    have kernels; "qkv" / "qkpv" (off by default in the JAX package) raise.
    Only "none" is differentiable (K1 with LSE forward, K4 backward).
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention path for device {q.device}")
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if quant == "none":
        if rope is not None:
            dt = q.dtype
            q = rope_apply_split(q, rope).to(dt)
            k = rope_apply_split(k, rope).to(dt)
        if needs_grad:
            return _Flash.apply(q, k, v, k_lens, scale)
        if q.is_cuda:
            return _flash_fwd_cuda(q, k, v, k_lens, scale)
        return _flash_fwd_plain(q, k, v, k_lens, scale)
    if quant not in ("qk", "qkv", "qkpv"):
        raise ValueError(f"unknown quant {quant!r}")
    if needs_grad:
        raise ValueError(f"quant={quant!r}: the int8 flash paths are not differentiable "
                         "(inference only, as in the JAX package)")
    if q.is_cuda and quant != "qk":
        raise NotImplementedError(
            f"quant={quant!r} has no Hopper kernel yet (ROADMAP queue 2, K2v)"
        )
    q8, k8, sqk = prepare_int8(q, k, rope, scale)
    if q.is_cuda:
        return _flash_int8_cuda(q8, k8, v, sqk, k_lens)
    sv, out_dtype = None, v.dtype
    if quant != "qk":
        v, sv = quantize_v(v)
    return _flash_int8_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv,
                             out_dtype=out_dtype)


def flash_attention_with_stats(q, k, v, *, k_lens=None, scale=None, rope=None,
                               quant: str = "none"):
    """Forward returning (out [B, Lq, N, D], lse [B, Lq, N] fp32, natural
    log): the combinable partials ring attention merges (JAX
    `flash_attention_with_stats`).  K1 with its LSE output on CUDA; the int8
    kernels have no LSE output yet (ROADMAP queue 2)."""
    if quant != "none":
        raise NotImplementedError(
            f"quant={quant!r}: K2 has no LSE output yet (ROADMAP queue 2)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention path for device {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if rope is not None:
        dt = q.dtype
        q = rope_apply_split(q, rope).to(dt)
        k = rope_apply_split(k, rope).to(dt)
    out, lse = _flash_fwd_with_lse(q, k, v, k_lens, scale)
    return out, lse.transpose(1, 2)
