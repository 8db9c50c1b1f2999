"""Flash attention forward: kernels K1 (bf16) and K2 (int8 Q.K^T).

Port of `stableavatar_tpu/ops/flash_attention.py` (forward, inference).  On a
CUDA tensor `flash_attention` launches a hand-written Hopper kernel
(`csrc/flash_attention.cu`); on a CPU tensor it runs the plain PyTorch
version beside it (`_flash_fwd_plain`, `_flash_int8_plain`).  There is no
other path: a CUDA call that the kernels do not take raises.

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

# kernel launches, counted where each wrapper launches its kernel
launch_counts = {"flash_fwd_bf16": 0, "flash_fwd_int8_qk": 0}

# bytes of fp32 logits one plain-version chunk may hold
_PLAIN_CHUNK_BYTES = 1 << 30


def _quant_slab(x: torch.Tensor):
    """[B, L, N, D] fp32 -> (int8, scales [B, N] fp32): one absmax scale per
    (batch, head) slab; round half to even like jnp.round."""
    s = torch.clamp(x.abs().amax(dim=(1, 3)) * (1.0 / 127.0), min=1e-10)
    q = torch.clamp(torch.round(x / s[:, None, :, None]), -127.0, 127.0).to(torch.int8)
    return q, s


def _online_softmax_plain(logits_fn, k_lens, lq, lk, block_k, out_shape,
                          pv_fn, device):
    """Shared plain loop: query chunks x key blocks with the kernels' online
    base-2 softmax.  logits_fn(q0, q1, k0, k1) -> [B, N, qc, kc] base-2
    logits; pv_fn(s, m_cur, m_new, k0, k1) -> (pv [B, N, qc, D], row-sum
    term) for one block of masked logits s."""
    b, n, _, d = out_shape
    qc = max(1, _PLAIN_CHUNK_BYTES // (4 * b * n * block_k))
    acc_out = torch.empty(out_shape, dtype=torch.float32, device=device)
    cols = torch.arange(lk, device=device)
    klens = (torch.full((b,), lk, device=device) if k_lens is None
             else k_lens.to(device=device, dtype=torch.int64))
    for q0 in range(0, lq, qc):
        q1 = min(lq, q0 + qc)
        m = torch.full((b, n, q1 - q0, 1), NEG_INF, dtype=torch.float32, device=device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n, q1 - q0, d), dtype=torch.float32, device=device)
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
        acc_out[:, :, q0:q1] = acc / torch.clamp(l, min=1e-30)
    return acc_out


def _flash_fwd_plain(q, k, v, k_lens=None, scale=None, block_k: int = 1024):
    """Plain K1: bf16 (or fp32) flash forward, [B, L, N, D] in and out."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qf = q.permute(0, 2, 1, 3).float()
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    eff = scale * LOG2E

    def logits(q0, q1, k0, k1):
        return (qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)) * eff

    def pv(s, m_cur, m_new, k0, k1):
        p = torch.exp2(s - m_new)
        return p.to(v.dtype).float() @ vf[:, :, k0:k1], p.sum(-1, keepdim=True)

    out = _online_softmax_plain(logits, k_lens, lq, lk, min(block_k, lk),
                                (b, n, lq, d), pv, q.device)
    return out.to(q.dtype).permute(0, 2, 1, 3)


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


def _flash_fwd_cuda(q, k, v, k_lens, scale):
    b, lq, n, d = q.shape
    lk = k.shape[1]
    _check("q", q, torch.bfloat16)
    _check("k", k, torch.bfloat16, (b, lk, n, d))
    _check_cuda_common(q, k, v, k_lens)
    out = torch.empty_like(q)
    cuda_lib.launch(
        "sa_flash_fwd_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_lens is None else k_lens.data_ptr(), out.data_ptr(),
        b, lq, lk, n, d, float(scale * LOG2E),
    )
    launch_counts["flash_fwd_bf16"] += 1
    return out


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
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention path for device {q.device}")
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if quant == "none":
        if rope is not None:
            dt = q.dtype
            q = rope_apply_split(q, rope).to(dt)
            k = rope_apply_split(k, rope).to(dt)
        if q.is_cuda:
            return _flash_fwd_cuda(q, k, v, k_lens, scale)
        return _flash_fwd_plain(q, k, v, k_lens, scale)
    if quant not in ("qk", "qkv", "qkpv"):
        raise ValueError(f"unknown quant {quant!r}")
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
