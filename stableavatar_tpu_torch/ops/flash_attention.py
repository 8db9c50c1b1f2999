"""Flash attention: kernels K1 (bf16 forward, optional LSE), K2 (int8 Q.K^T
forward), K2v (K2 with int8 V: "qkv", "qkpv"), K3 (K2 / K2v-qkv with the
static-bound softmax) and K4 (the bf16 backward).

Port of `stableavatar_tpu/ops/flash_attention.py`.  On a CUDA tensor
`flash_attention` launches a hand-written Hopper kernel
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`); on a CPU tensor
it runs the plain PyTorch version beside it (`_flash_fwd_plain`,
`_flash_int8_plain`, `_flash_int8_static_plain`, `_flash_bwd_plain`).
There is no other path: a CUDA call that the kernels do not take raises.

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
"qkv" / "qkpv" also quantise V per channel (`quantize_v`); the output keeps
the unquantised V's dtype.  `STATIC_MAX` (env `STABLEAVATAR_STATIC_MAX=1`,
read at import as in the JAX package) or `static_max=True` replaces the
online max of "qk" / "qkv" by K3's precomputed bound (`static_bound`);
"qkpv" ignores it.

The plain versions reproduce the kernels' arithmetic exactly where it is
exact (int8 products are integers, exact in fp32 up to 2^24; bf16 products
are exact in fp32) and walk the keys in blocks with the same online
softmax; they process queries in chunks so no [B, N, Lq, Lk] logit tensor is
ever materialised (66 GB at the 21,504-token DiT window).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.ops.rope import rope_apply_split

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# K3 for every int8 self-attention but "qkpv" (off by default, as in the
# JAX package)
STATIC_MAX = os.environ.get("STABLEAVATAR_STATIC_MAX", "0") == "1"

# kernel launches, counted where each wrapper launches its kernel; K1 with
# and without its LSE output count apart
launch_counts = {"flash_fwd_bf16": 0, "flash_fwd_bf16_lse": 0, "flash_fwd_int8_qk": 0,
                 "flash_fwd_int8_qkv": 0, "flash_fwd_int8_qkpv": 0,
                 "flash_fwd_int8_static_qk": 0, "flash_fwd_int8_static_qkv": 0,
                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

# query rows per thread block of the CUDA kernels: K3's bound is per block
KERNEL_BLOCK_Q = 64

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


def static_bound(q8, k8, sqk, block_q: int = KERNEL_BLOCK_Q):
    """K3's prep (plain torch, as it was XLA on the TPU): the Cauchy-Schwarz
    bound of the base-2 logits per (slab, query block), sqk * max_rows |q8|
    * max_cols |k8| -> [B*N, ceil(Lq / block_q)] fp32.  The key maximum runs
    over all key rows, masked ones included, as in the JAX package."""
    b, lq, n, d = q8.shape
    nq = -(-lq // block_q)
    qf, kf = q8.float(), k8.float()
    qn = torch.sqrt((qf * qf).sum(-1)).permute(0, 2, 1).reshape(b * n, lq)
    qn = torch.nn.functional.pad(qn, (0, nq * block_q - lq))  # zero rows: norm 0
    qn_blk = qn.reshape(b * n, nq, block_q).amax(-1)
    kn = torch.sqrt((kf * kf).sum(-1)).amax(1).reshape(b * n)
    return sqk[:, None] * qn_blk * kn[:, None]


def _flash_int8_static_plain(q8, k8, v, sqk, k_lens=None, quant: str = "qk", sv=None,
                             block_q: int = KERNEL_BLOCK_Q, out_dtype=None,
                             with_lse: bool = False):
    """Plain K3: the static-bound softmax on prepared int8 operands, "qk" (v
    in the output dtype) or "qkv" (v int8 with scales `sv`).  p = exp2(s -
    M) with M the bound of the row's query block of `block_q` rows (the
    kernel's 64; the JAX package's default is 1536: the result is the same
    up to underflow); l and P.V are plain sums.  With `with_lse` also
    returns the natural-log LSE [B, N, Lq], M * ln2 + log(max(l, 1e-30))."""
    b, lq, n, d = q8.shape
    lk = k8.shape[1]
    out_dtype = v.dtype if out_dtype is None else out_dtype
    mstat = static_bound(q8, k8, sqk, block_q).reshape(b, n, -1)
    m = mstat.repeat_interleave(block_q, dim=2)[:, :, :lq, None]  # [B, N, Lq, 1]
    qf = q8.permute(0, 2, 1, 3).float()
    kf = k8.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    sqk4 = sqk.reshape(b, n, 1, 1)
    klens = (torch.full((b,), lk, device=q8.device) if k_lens is None
             else k_lens.to(device=q8.device, dtype=torch.int64))
    valid = (torch.arange(lk, device=q8.device)[None, :] < klens[:, None])[:, None, None, :]
    p_dtype = torch.bfloat16 if quant == "qkv" else v.dtype
    out = torch.empty((b, n, lq, d), device=q8.device)
    lse = torch.empty((b, n, lq), device=q8.device) if with_lse else None
    qc = max(1, _PLAIN_CHUNK_BYTES // (4 * b * n * lk))
    for q0 in range(0, lq, qc):
        q1 = min(lq, q0 + qc)
        s = (qf[:, :, q0:q1] @ kf.transpose(-1, -2)) * sqk4
        p = torch.exp2(torch.where(valid, s, NEG_INF) - m[:, :, q0:q1])
        l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        out[:, :, q0:q1] = (p.to(p_dtype).float() @ vf) / l
        if with_lse:
            lse[:, :, q0:q1] = (m[:, :, q0:q1] * LN2 + torch.log(l))[..., 0]
    if quant == "qkv":
        out = out * sv.permute(0, 2, 1, 3)
    out = out.to(out_dtype).permute(0, 2, 1, 3)
    return (out, lse) if with_lse else out


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


def _check_cuda_common(q, k, v, k_lens, v_dtype=torch.bfloat16):
    b, _, n, d = q.shape
    lk = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernels take 64 or 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    _check("v", v, v_dtype, (b, lk, n, d))
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


def _flash_int8_cuda(q8, k8, v, sqk, k_lens, quant: str = "qk", sv=None,
                     mstat=None, with_lse: bool = False):
    """K2 ("qk"), K2v ("qkv", "qkpv") or, given K3's bound `mstat` (the
    prep's `static_bound`), K3 ("qk" / "qkv") on prepared operands: v bf16
    for "qk", int8 with scales sv [B, 1, N, D] otherwise.  Returns bf16 out,
    and with `with_lse` (K3 only) the LSE [B, N, Lq] fp32."""
    b, lq, n, d = q8.shape
    lk = k8.shape[1]
    static = mstat is not None
    if (static and quant == "qkpv") or (with_lse and not static):
        raise ValueError(f"no int8 kernel for quant={quant!r}, static={static}, "
                         f"with_lse={with_lse} (K2-LSE: ROADMAP queue 2)")
    _check("q8", q8, torch.int8)
    _check("k8", k8, torch.int8, (b, lk, n, d))
    _check("sqk", sqk, torch.float32, (b * n,))
    _check_cuda_common(q8, k8, v, k_lens, torch.bfloat16 if quant == "qk" else torch.int8)
    ptrs = [q8.data_ptr(), k8.data_ptr(), v.data_ptr()]
    if quant != "qk":
        _check("sv", sv, torch.float32, (b, 1, n, d))
        ptrs.append(sv.data_ptr())
    ptrs.append(sqk.data_ptr())
    if static:
        _check("mstat", mstat, torch.float32, (b * n, -(-lq // KERNEL_BLOCK_Q)))
        ptrs.append(mstat.data_ptr())
    out = torch.empty(q8.shape, dtype=torch.bfloat16, device=q8.device)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=q8.device) if with_lse else None
    ptrs += [None if k_lens is None else k_lens.data_ptr(), out.data_ptr()]
    if static:
        ptrs.append(None if lse is None else lse.data_ptr())
    name = f"flash_fwd_int8_{'static_' if static else ''}{quant}"
    cuda_lib.launch(f"sa_{name}", *ptrs, b, lq, lk, n, d)
    launch_counts[name] += 1
    return (out, lse) if with_lse else out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    k_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope: Optional[torch.Tensor] = None,
    quant: str = "none",
    static_max: Optional[bool] = None,
) -> torch.Tensor:
    """q [B, Lq, N, D], k/v [B, Lk, N, D] -> [B, Lq, N, D] in v's dtype.

    quant: "none" (K1) | "qk" (K2) | "qkv" | "qkpv" (K2v).  static_max
    (None: `STATIC_MAX`) takes K3 for "qk" / "qkv"; "qkpv" ignores it.
    rope: packed split-pair [L, D] table; on the bf16 path it is applied
    before the kernel, on the int8 paths inside the quantisation prep.  Only
    "none" is differentiable (K1 with LSE forward, K4 backward).
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
    static = bool(STATIC_MAX if static_max is None else static_max) and quant != "qkpv"
    q8, k8, sqk = prepare_int8(q, k, rope, scale)
    sv, out_dtype = None, v.dtype
    if q.is_cuda and out_dtype != torch.bfloat16:
        raise TypeError(f"v: the int8 kernels write bf16 outputs, got v in {out_dtype}")
    if quant != "qk":
        v, sv = quantize_v(v)
    if q.is_cuda:
        mstat = static_bound(q8, k8, sqk) if static else None
        return _flash_int8_cuda(q8, k8, v, sqk, k_lens, quant=quant, sv=sv, mstat=mstat)
    if static:
        return _flash_int8_static_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv,
                                        out_dtype=out_dtype)
    return _flash_int8_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv, out_dtype=out_dtype)


def flash_attention_with_stats(q, k, v, *, k_lens=None, scale=None, rope=None,
                               quant: str = "none"):
    """Forward returning (out [B, Lq, N, D], lse [B, Lq, N] fp32, natural
    log): the combinable partials ring attention merges (JAX
    `flash_attention_with_stats`).  K1 with its LSE output on CUDA; the int8
    paths need K2-LSE, not ported yet (ROADMAP queue 2)."""
    if quant != "none":
        raise NotImplementedError(
            f"quant={quant!r}: the int8 partials need K2-LSE, K2's LSE output, which is not "
            "ported yet (ROADMAP queue 2)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention path for device {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if rope is not None:
        dt = q.dtype
        q = rope_apply_split(q, rope).to(dt)
        k = rope_apply_split(k, rope).to(dt)
    out, lse = _flash_fwd_with_lse(q, k, v, k_lens, scale)
    return out, lse.transpose(1, 2)
