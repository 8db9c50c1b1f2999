"""Flash attention: kernels K1 (bf16 forward, optional LSE), K1-rope (K1
on q and k rotated by split-pair rope), K2 (int8 Q.K^T forward), K2v (K2
with int8 V: "qkv", "qkpv"), K2-LSE (K2 / K2v with the LSE output), K3 (K2
/ K2v-qkv with the static-bound softmax) and K4 (the bf16 backward, with
its rope branch K4-rope).  K1, K2, K2v, K2-LSE and K3 are instances of one
wgmma / TMA kernel; K1-rope is one rotation pass (`rope_rotate`) before K1,
and K4-rope the fused K4 on the rotated q and k with one pass after it that
inverse-rotates dQ and dK (`rope_finalize_bwd`).

Port of `stableavatar_tpu/ops/flash_attention.py`.  On a CUDA tensor
`flash_attention` launches hand-written Hopper kernels
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`, `csrc/rope.cu`);
on a CPU tensor it runs the plain PyTorch versions beside them
(`_flash_fwd_plain`, `_flash_int8_plain`, `_flash_int8_static_plain`,
`_flash_bwd_plain`, `_rope_rows`, `_rope_finalize_plain`).  There is no
other path: a CUDA call that the kernels do not take raises.

The bf16 path is differentiable like the JAX package's custom-VJP `_flash`:
with grad enabled and an input that requires grad, the forward launches K1
with its natural-log LSE and the backward launches K4, one fused pass that
recomputes P from that LSE and writes dQ, dK and dV.  Otherwise K1 runs
without the LSE write, as the JAX primal does.  The int8 paths are not
differentiable.  With `rope=` the bf16 path computes what the JAX
package's `flash_attention(rope=)` computes with its in-kernel rotation:
q and k rotated in fp32 and rounded once, and under autograd dQ and dK
inverse-rotated in fp32 before their one rounding (K1-rope, K4-rope);
`ops/attention.py` rotates before K1 instead, as the JAX package's
`attention()` does.

Semantics kept from the JAX package: q/k/v [B, L, N, D]; keys at or past
`k_lens[b]` are masked with -1e30 (a batch with `k_lens[b] == 0` gets zero
rows and the LSE of an empty row, kernels and plain versions alike: the
JAX package's online kernels give the mean of V over their zero-padded key
blocks there, which depends on the block); the online softmax runs in base 2 with
log2(e) folded into the scale; P is rounded to the value dtype before P.V;
the row sum is guarded with max(l, 1e-30).  For `quant != "none"` q and k
are roped (split-pair layout) in fp32 and quantised to int8 with ONE absmax
scale per (batch, head) over the whole sequence (`_quant_slab`), and the
kernel multiplies the int32 logits by sqk = sq * sk * scale * log2(e).
"qkv" / "qkpv" also quantise V per channel (`quantize_v`); the output keeps
the unquantised V's dtype.  "qkpv" quantises P per row against its maximum
over the JAX package's key block, `min(1536, round_up(Lk, 128))` in
`flash_attention` and `min(1024, round_up(Lk, 128))` in
`flash_attention_with_stats` (`jax_key_block`), on the CPU and on the card.
`STATIC_MAX` (env `STABLEAVATAR_STATIC_MAX=1`, read at import as in the JAX
package) or `static_max=True` replaces the online max of "qk" / "qkv" by
K3's precomputed bound (`static_bound`); "qkpv" ignores it.

The plain versions reproduce the kernels' arithmetic exactly where it is
exact (int8 products are integers, exact in fp32 up to 2^24; bf16 products
are exact in fp32) and walk the keys in blocks with the same online
softmax; they process queries in chunks so no [B, N, Lq, Lk] logit tensor is
ever materialised (66 GB at the 21,504-token DiT window).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.ops.rope import rope_apply_split, rope_apply_split_inv

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# K3 for every int8 self-attention but "qkpv" (off by default, as in the
# JAX package)
STATIC_MAX = os.environ.get("STABLEAVATAR_STATIC_MAX", "0") == "1"

# kernel launches, counted where each wrapper launches its kernel; K1 and
# the online int8 kernels with and without their LSE output count apart.
# K1-rope is one `rope_rotate` and one `flash_fwd_bf16` (or `..._lse`),
# K4-rope one `flash_bwd` and one `rope_finalize_bwd`
launch_counts = {"flash_fwd_bf16": 0, "flash_fwd_bf16_lse": 0, "flash_fwd_int8_qk": 0,
                 "flash_fwd_int8_qkv": 0, "flash_fwd_int8_qkpv": 0,
                 "flash_fwd_int8_qk_lse": 0, "flash_fwd_int8_qkv_lse": 0,
                 "flash_fwd_int8_qkpv_lse": 0,
                 "flash_fwd_int8_static_qk": 0, "flash_fwd_int8_static_qkv": 0,
                 "flash_bwd": 0, "rope_rotate": 0, "rope_finalize_bwd": 0}

# the JAX package's default key blocks of the int8 paths: `flash_attention`
# and `flash_attention_with_stats`, each capped to Lk rounded up to 128
INT8_BLOCK_K = 1536
STATS_BLOCK_K = 1024

# query rows per thread block of the CUDA kernels: K3's bound is per block
KERNEL_BLOCK_Q = 64

# bytes of fp32 logits one plain-version chunk may hold
_PLAIN_CHUNK_BYTES = 1 << 30


def jax_key_block(lk: int, block_k: int) -> int:
    """The JAX package's effective key block: min(block_k, round_up(lk, 128))."""
    return min(block_k, -(-lk // 128) * 128)


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
    # a batch with no valid key: zero rows and the LSE of an empty row, as
    # the kernels write them (every logit is -1e30, so the loop above gave
    # the mean of V)
    empty = klens <= 0
    if bool(empty.any()):
        acc_out[empty] = 0.0
        if with_lse:
            lse[empty] = NEG_INF * LN2 + math.log(1e-30)
    return (acc_out, lse) if with_lse else acc_out


def _rope_rows(x, rope):
    """x [B, L, N, D] rotated by the first L rows of the packed split-pair
    table in fp32 and rounded to x's dtype once (JAX `_rot(...).astype(dt)`):
    the plain `rope_rotate` of one tensor."""
    return rope_apply_split(x, rope[: x.shape[1]]).to(x.dtype)


def _rope_finalize_plain(dq, dk, dv, rope, dtype):
    """Plain `rope_finalize_bwd`: the fp32 sums dQ [B, Lq, N, D] and dK
    [B, Lk, N, D] inverse-rotated by the table's rows [0, Lq) / [0, Lk)
    (JAX `_rot_inv`), then each of dQ, dK and dV rounded to `dtype` once."""
    return (rope_apply_split_inv(dq, rope[: dq.shape[1]]).to(dtype),
            rope_apply_split_inv(dk, rope[: dk.shape[1]]).to(dtype), dv.to(dtype))


def _flash_fwd_plain(q, k, v, k_lens=None, scale=None, block_k: int = 1024,
                     with_lse: bool = False, rope=None):
    """Plain K1: bf16 (or fp32) flash forward, [B, L, N, D] in and out; with
    `with_lse` also the natural-log LSE [B, N, Lq] (fp32).  With `rope` (plain
    K1-rope) q and k are rotated first, q by the table's rows [0, Lq), k by
    [0, Lk)."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    if rope is not None:
        q, k = _rope_rows(q, rope), _rope_rows(k, rope)
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


def _flash_bwd_plain(q, k, v, k_lens, out, lse, g, scale=None, rope=None):
    """Plain K4: the flash backward from the forward's LSE [B, N, Lq], in
    chunks of queries so no [B, N, Lq, Lk] tensor is materialised.

    The arithmetic of the two TPU bodies: base-2 logits, p = exp2(s -
    lse * log2 e) with masked keys and rows with lse <= NEG_INF / 2 at 0,
    delta = rowsum(dO * O), ds = p * (dp - delta) * scale; P and dS are
    rounded to the input dtype before their products (dV = P^T dO,
    dK = dS^T Q, dQ = dS K).  With `rope` (the rope branch) q and k are the
    forward's rotated operands (as `_Flash` saves them), and dQ and dK are
    inverse-rotated in fp32 before the final rounding.  Returns dq, dk, dv
    [B, L, N, D] in q's dtype."""
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
    dq, dk, dv = (x.permute(0, 2, 1, 3) for x in (dq, dk, dv))
    if rope is not None:
        return _rope_finalize_plain(dq, dk, dv, rope, dt)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _flash_int8_plain(q8, k8, v, sqk, k_lens=None, quant: str = "qk", sv=None,
                      block_k: int = INT8_BLOCK_K, out_dtype=None, with_lse: bool = False):
    """Plain K2, K2v and K2-LSE on prepared int8 operands.

    q8/k8 int8 [B, L, N, D]; v [B, Lk, N, D] in the output dtype for "qk",
    int8 with per-channel scales `sv` [B, 1, N, D] for "qkv" / "qkpv";
    sqk [B*N] fp32 (sq * sk * scale * log2 e).  "qkpv" quantises P per row to
    its maximum within each key block of `block_k` keys (as the TPU body
    does), so its result depends on block_k: pass the JAX package's block
    (`jax_key_block`).  out_dtype defaults to v's dtype (pass the
    unquantised V's for "qkv"/"qkpv").  With `with_lse` also returns the
    natural-log LSE [B, N, Lq] fp32, m * ln2 + log(max(l, 1e-30)).
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

    res = _online_softmax_plain(logits, k_lens, lq, lk, min(block_k, lk),
                                (b, n, lq, d), pv, q8.device, with_lse=with_lse)
    out, lse = res if with_lse else (res, None)
    if quant in ("qkv", "qkpv"):
        out = out * sv.permute(0, 2, 1, 3)
    out = out.to(out_dtype).permute(0, 2, 1, 3)
    return (out, lse) if with_lse else out


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


def _check_rope(rope, q, lk):
    """The packed split-pair table [L, D] fp32 on q's device, L >= Lq, Lk."""
    lq, d = q.shape[1], q.shape[3]
    _check("rope", rope, torch.float32)
    if rope.device != q.device:
        raise ValueError("rope must be on the same device as q")
    if rope.dim() != 2 or rope.shape[1] != d or rope.shape[0] < max(lq, lk):
        raise ValueError(f"rope: expected [L >= {max(lq, lk)}, {d}], got {tuple(rope.shape)}")


def _check_bf16_qk(q, k):
    b, _, n, d = q.shape
    _check("q", q, torch.bfloat16)
    _check("k", k, torch.bfloat16, (b, k.shape[1], n, d))


def _rope_rotate_cuda(q, k, rope):
    """The rotation pass of K1-rope and K4-rope (`sa_rope_rotate`, one
    launch): new bf16 q and k rotated by the table's rows [0, Lq) / [0, Lk),
    equal to `_rope_rows` bit for bit."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check_bf16_qk(q, k)
    _check_rope(rope, q, lk)
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernels take 64 or 128")
    if k.device != q.device:
        raise ValueError(f"k is on {k.device}, q on {q.device}")
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    cuda_lib.launch("sa_rope_rotate", q.data_ptr(), k.data_ptr(), rope.data_ptr(),
                    qr.data_ptr(), kr.data_ptr(), b, lq, lk, n, d)
    launch_counts["rope_rotate"] += 1
    return qr, kr


def rope_rotate(q, k, rope):
    """q and k rotated by the packed split-pair table `rope` (q by its rows
    [0, Lq), k by [0, Lk)) in fp32 and rounded to their dtype once: the
    kernel on CUDA tensors, `_rope_rows` on CPU ones."""
    if q.is_cuda:
        return _rope_rotate_cuda(q, k, rope)
    return _rope_rows(q, rope), _rope_rows(k, rope)


def _rope_finalize_cuda(dq, dk, dv, rope):
    """`sa_rope_finalize_bwd` (one launch): the fp32 sums dQ [B, Lq, N, D]
    and dK, dV [B, Lk, N, D] to bf16, dQ and dK inverse-rotated first; equal
    to `_rope_finalize_plain` bit for bit."""
    b, lq, n, d = dq.shape
    lk = dk.shape[1]
    _check("dq", dq, torch.float32)
    _check("dk", dk, torch.float32, (b, lk, n, d))
    _check("dv", dv, torch.float32, (b, lk, n, d))
    _check_rope(rope, dq, lk)
    out = [torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) for x in (dq, dk, dv)]
    cuda_lib.launch("sa_rope_finalize_bwd", dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    rope.data_ptr(), *(x.data_ptr() for x in out), b, lq, lk, n, d)
    launch_counts["rope_finalize_bwd"] += 1
    return tuple(out)


def _flash_fwd_cuda(q, k, v, k_lens, scale, with_lse: bool = False, rope=None):
    """K1, or K1-rope given the packed table `rope` (`rope_rotate`, then K1
    on the rotated copies); with `with_lse` returns (out, lse [B, N, Lq]
    fp32)."""
    if rope is not None:
        q, k = _rope_rotate_cuda(q, k, rope)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check_bf16_qk(q, k)
    _check_cuda_common(q, k, v, k_lens)
    out = torch.empty_like(q)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=q.device) if with_lse else None
    cuda_lib.launch("sa_flash_fwd_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if k_lens is None else k_lens.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, lq, lk, n, d,
                    float(scale * LOG2E))
    launch_counts["flash_fwd_bf16_lse" if with_lse else "flash_fwd_bf16"] += 1
    return (out, lse) if with_lse else out


# K1's tiles: query rows per block and keys per K / V tile
FWD_BLOCK_Q = 128
FWD_BLOCK_KEYS = 128

# the fused K4's tiles: keys per block and query rows per tile
BWD_BLOCK_KEYS = 128
BWD_BLOCK_Q = 64


def bwd_splits(bn: int, lq: int, lk: int, sms: int) -> int:
    """How many ways the fused K4 splits the query tiles: 1 where the key
    blocks alone give at least two blocks per SM, else enough splits for
    about four blocks per SM (the cross-attention shapes: 48 or 36 key
    blocks for 132 SMs at Lk 512 / 257), at most one per query tile."""
    blocks = -(-lk // BWD_BLOCK_KEYS) * bn
    if blocks >= 2 * sms:
        return 1
    return max(1, min(-(-lq // BWD_BLOCK_Q), -(-4 * sms // blocks)))


def _flash_bwd_cuda(q, k, v, k_lens, out, lse, g, scale, rope=None):
    """K4: (dq, dk, dv) in bf16 from the forward's LSE, in one fused pass.
    The fused pass adds dQ into a zeroed fp32 buffer (rounded to bf16 here)
    and, where it splits the queries (`bwd_splits`), writes fp32 dK / dV
    partials that are summed here in a fixed order.  Given the packed table
    `rope` (K4-rope), q and k are the forward's rotated operands: dK and dV
    always go through the fp32 partials, and `rope_finalize_bwd`
    inverse-rotates the fp32 dQ and dK before their one rounding."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check_bf16_qk(q, k)
    _check_cuda_common(q, k, v, k_lens)
    _check("dout", g, torch.bfloat16, (b, lq, n, d))
    _check("out", out, torch.bfloat16, (b, lq, n, d))
    _check("lse", lse, torch.float32, (b, n, lq))
    # delta = rowsum(dO * O) in fp32: a plain torch op, as on the TPU
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kl = None if k_lens is None else k_lens.data_ptr()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), kl]
    scales = (float(scale), float(scale * LOG2E))
    if rope is not None:
        _check_rope(rope, q, lk)
    splits = bwd_splits(b * n, lq, lk,
                        torch.cuda.get_device_properties(q.device).multi_processor_count)
    dq_acc = torch.zeros((b, lq, n, d), dtype=torch.float32, device=q.device)
    if splits > 1 or rope is not None:
        dk = dv = None
        dk_part, dv_part = (torch.empty((splits, b, lk, n, d), dtype=torch.float32,
                                        device=q.device) for _ in range(2))
        outs = [dk_part.data_ptr(), dv_part.data_ptr()]
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        outs = [None, None]
    cuda_lib.launch("sa_flash_bwd", *args, dq_acc.data_ptr(),
                    None if dk is None else dk.data_ptr(), None if dv is None else dv.data_ptr(),
                    *outs, b, lq, lk, n, d, splits, *scales)
    launch_counts["flash_bwd"] += 1
    if rope is not None:
        dk, dv = (x.sum(0) if splits > 1 else x[0] for x in (dk_part, dv_part))
        return _rope_finalize_cuda(dq_acc, dk, dv, rope)
    if splits > 1:
        dk, dv = dk_part.sum(0).to(torch.bfloat16), dv_part.sum(0).to(torch.bfloat16)
    return dq_acc.to(torch.bfloat16), dk, dv


def _flash_fwd_with_lse(q, k, v, k_lens, scale, rope=None):
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, k_lens, scale, with_lse=True, rope=rope)
    return _flash_fwd_plain(q, k, v, k_lens, scale, with_lse=True, rope=rope)


class _Flash(torch.autograd.Function):
    """The custom VJP of the JAX package's `_flash` (flash_attention.py:967):
    forward K1 with LSE, backward K4; given `rope`, q and k are rotated once
    (`rope_rotate`) and the rotated copies are what K1 reads and what is
    saved, so K4-rope does not rotate again.  Plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, scale, rope=None):
        if rope is not None:
            q, k = rope_rotate(q, k, rope)
        out, lse = _flash_fwd_with_lse(q, k, v, k_lens, scale)
        ctx.save_for_backward(q, k, v, k_lens, out, lse, rope)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_lens, out, lse, rope = ctx.saved_tensors
        g = g.contiguous()
        if q.is_cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, k_lens, out, lse, g, ctx.scale, rope)
        else:
            dq, dk, dv = _flash_bwd_plain(q, k, v, k_lens, out, lse, g, ctx.scale, rope)
        return dq, dk, dv, None, None, None


def _flash_int8_cuda(q8, k8, v, sqk, k_lens, quant: str = "qk", sv=None,
                     mstat=None, with_lse: bool = False, pv_block: Optional[int] = None):
    """K2 ("qk"), K2v ("qkv", "qkpv") or, given K3's bound `mstat` (the
    prep's `static_bound`), K3 ("qk" / "qkv") on prepared operands: v bf16
    for "qk", int8 with scales sv [B, 1, N, D] otherwise.  "qkpv" quantises
    P on key blocks of `pv_block` keys (default: `flash_attention`'s JAX
    block).  Returns bf16 out, and with `with_lse` (K2-LSE, or K3's LSE) the
    LSE [B, N, Lq] fp32."""
    b, lq, n, d = q8.shape
    lk = k8.shape[1]
    static = mstat is not None
    if static and quant == "qkpv":
        raise ValueError(f"no int8 kernel for quant={quant!r}, static={static}")
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
    ptrs += [None if k_lens is None else k_lens.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr()]
    dims = [b, lq, lk, n, d]
    if quant == "qkpv":
        pv_block = jax_key_block(lk, INT8_BLOCK_K) if pv_block is None else pv_block
        if pv_block <= 0 or pv_block % 64:
            raise ValueError(f"pv_block {pv_block}: the kernel takes positive multiples of 64")
        dims.append(pv_block)
    name = f"flash_fwd_int8_{'static_' if static else ''}{quant}"
    cuda_lib.launch(f"sa_{name}", *ptrs, *dims)
    name += "_lse" if with_lse and not static else ""
    launch_counts[name] += 1
    return (out, lse) if with_lse else out


def _flash_int8(q, k, v, k_lens, scale, rope, quant, static_max, block_k, with_lse=False):
    """The int8 paths of `flash_attention` and `flash_attention_with_stats`:
    the plain-torch prep, then the kernel (CUDA) or its plain version (CPU).
    `block_k` is the JAX entry point's default key block, on which "qkpv"
    quantises P."""
    if quant not in ("qk", "qkv", "qkpv"):
        raise ValueError(f"unknown quant {quant!r}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise ValueError(f"quant={quant!r}: the int8 flash paths are not differentiable "
                         "(inference only, as in the JAX package)")
    static = bool(STATIC_MAX if static_max is None else static_max) and quant != "qkpv"
    pv_block = jax_key_block(k.shape[1], block_k)
    q8, k8, sqk = prepare_int8(q, k, rope, scale)
    sv, out_dtype = None, v.dtype
    if q.is_cuda and out_dtype != torch.bfloat16:
        raise TypeError(f"v: the int8 kernels write bf16 outputs, got v in {out_dtype}")
    if quant != "qk":
        v, sv = quantize_v(v)
    if q.is_cuda:
        mstat = static_bound(q8, k8, sqk) if static else None
        return _flash_int8_cuda(q8, k8, v, sqk, k_lens, quant=quant, sv=sv, mstat=mstat,
                                with_lse=with_lse, pv_block=pv_block)
    if static:
        return _flash_int8_static_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv,
                                        out_dtype=out_dtype, with_lse=with_lse)
    return _flash_int8_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv, block_k=pv_block,
                             out_dtype=out_dtype, with_lse=with_lse)


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
    rope: packed split-pair [L, D] fp32 table (row i: position i, L >= Lq,
    Lk); on the bf16 path one rotation pass feeds K1 (K1-rope; under
    autograd K4-rope inverse-rotates dQ and dK), on the int8 paths the
    quantisation prep rotates.  Only "none" is differentiable (K1 with LSE
    forward, K4 backward).
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention path for device {q.device}")
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if quant == "none":
        if needs_grad:
            return _Flash.apply(q, k, v, k_lens, scale, rope)
        if q.is_cuda:
            return _flash_fwd_cuda(q, k, v, k_lens, scale, rope=rope)
        return _flash_fwd_plain(q, k, v, k_lens, scale, rope=rope)
    return _flash_int8(q, k, v, k_lens, scale, rope, quant, static_max, INT8_BLOCK_K)


def flash_attention_with_stats(q, k, v, *, k_lens=None, scale=None, rope=None,
                               quant: str = "none", static_max: Optional[bool] = None):
    """Forward returning (out [B, Lq, N, D], lse [B, Lq, N] fp32, natural
    log): the combinable partials ring attention merges (JAX
    `flash_attention_with_stats`).  "none" runs K1 (K1-rope given `rope`)
    with its LSE output;
    "qk" / "qkv" / "qkpv" run K2-LSE (or K3 with its LSE under `static_max`
    / `STATIC_MAX`, "qkpv" excepted), with "qkpv" quantising P on the JAX
    function's key block of min(1024, round_up(Lk, 128)).  Not
    differentiable."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention path for device {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if quant != "none":
        out, lse = _flash_int8(q, k, v, k_lens, scale, rope, quant, static_max, STATS_BLOCK_K,
                               with_lse=True)
        return out, lse.transpose(1, 2)
    out, lse = _flash_fwd_with_lse(q, k, v, k_lens, scale, rope)
    return out, lse.transpose(1, 2)
