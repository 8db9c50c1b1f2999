"""Ring attention over the 'sp' mesh axis (port of
`stableavatar_tpu/ops/ring_attention.py`).

Each rank keeps its query chunk [B, L/W, N, D] and passes its K/V chunk to
the next rank of the sp group W - 1 times (`torch.distributed`
point-to-point, both directions posted in one batch; the next chunk travels
while this one's partial is computed).  Every chunk gives a combinable
partial (o_i, lse_i) from `flash_attention_with_stats` -- K1 with its LSE,
or K2-LSE for `quant != "none"`, whatever the query length, as the JAX
ring does on its TPU path -- and the partials merge exactly as

    lse* = logsumexp_i(lse_i),   o* = sum_i o_i * exp(lse_i - lse*)

with o carried in q's dtype and rounded after every merge (the JAX loop
body).  The int8 slab scales are per chunk, as in the JAX ring, so the ring
and the one-device int8 attention differ at the int8 level.  Rope is
applied by the caller (positions are global).  On CPU tensors the partials
are the kernels' plain versions, `quant` included; the JAX package's CPU
path ignores `quant` -- the port follows the kernel, as it does for K5.

Inference only: the backward raises, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from stableavatar_tpu_torch.ops.flash_attention import flash_attention_with_stats


def attention_partials(q, k, v, scale: Optional[float] = None, quant: str = "none"):
    """(o [B, Lq, N, D], lse [B, Lq, N] fp32) over one key chunk."""
    return flash_attention_with_stats(q, k, v, scale=scale, quant=quant)


def merge_partials(o, lse, o_i, lse_i):
    """Merge two partials over disjoint key sets; o keeps its dtype."""
    m = torch.maximum(lse, lse_i)
    w_old = torch.exp(lse - m)
    w_new = torch.exp(lse_i - m)
    denom = w_old + w_new
    o = (o.float() * (w_old / denom)[..., None]
         + o_i.float() * (w_new / denom)[..., None]).to(o.dtype)
    return o, m + torch.log(denom)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale, quant):
        w = dist.get_world_size(group)
        r = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (r + 1) % w)
        prv = dist.get_global_rank(group, (r - 1) % w)
        k_cur, v_cur = k.contiguous(), v.contiguous()
        o = lse = None
        for i in range(w):
            if i < w - 1:
                k_nxt, v_nxt = torch.empty_like(k_cur), torch.empty_like(v_cur)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, k_cur, nxt, group),
                    dist.P2POp(dist.irecv, k_nxt, prv, group),
                    dist.P2POp(dist.isend, v_cur, nxt, group),
                    dist.P2POp(dist.irecv, v_nxt, prv, group),
                ])
            o_i, lse_i = attention_partials(q, k_cur, v_cur, scale, quant)
            o, lse = (o_i.to(q.dtype), lse_i) if o is None else merge_partials(o, lse, o_i, lse_i)
            if i < w - 1:
                for req in reqs:
                    req.wait()
                k_cur, v_cur = k_nxt, v_nxt
        return o

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("ring_attention has no backward (inference only, as in the "
                                  "JAX package); train with attn_impl='ulysses' instead")


def ring_attention(q, k, v, group=None, scale: Optional[float] = None, quant: str = "none"):
    """The local query chunk's attention over the GLOBAL key sequence, whose
    chunks are spread over the ranks of `group` in rank order (each rank
    passes q, k, v [B, L/W, N, D] of its own chunk, rope applied)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _Ring.apply(q, k, v, group, scale, quant)
