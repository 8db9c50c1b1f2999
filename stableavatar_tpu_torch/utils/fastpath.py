"""Inference fast-path parameter preparation (port of
`stableavatar_tpu/utils/fastpath.py`).

1. Split-pair rope permutation: the self-attention q/k projection output
   channels (rows of the [d_out, d_in] weights), their biases and their
   RMS-norm weights are permuted per head so rope pairs sit at (j, j + d/2).
   Attention logits are unchanged by this joint permutation.
2. int8 quantisation of the 14 per-block linears: quant=True gives W8A8
   compute weights ({"w8": ...}, `utils/quantization.py:int8_linear`),
   quant="store" int8 storage with bf16 compute, quant=False none.

The result is consumed by `dit_forward(..., rope_split=True,
attn_quant=...)`; the input tree is not modified.
"""

from __future__ import annotations

import torch

from stableavatar_tpu_torch.ops.rope import split_pair_permutation
from stableavatar_tpu_torch.utils.quantization import (
    quantize_weight,
    quantize_weight_for_compute,
)

_QUANT_TARGETS = (
    ("self_attn", "q"),
    ("self_attn", "k"),
    ("self_attn", "v"),
    ("self_attn", "o"),
    ("cross_attn", "q"),
    ("cross_attn", "k"),
    ("cross_attn", "v"),
    ("cross_attn", "o"),
    ("cross_attn", "k_img"),
    ("cross_attn", "v_img"),
    ("cross_attn", "k_vocal"),
    ("cross_attn", "v_vocal"),
    ("ffn", "fc1"),
    ("ffn", "fc2"),
)


def _prepare_block(bp, perm, quant):
    bp = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bp.items()}
    sa = bp["self_attn"]
    for proj in ("q", "k"):
        p = dict(sa[proj])
        p["w"] = p["w"][perm]
        if "b" in p:
            p["b"] = p["b"][perm]
        sa[proj] = p
        sa[f"norm_{proj}"] = {"w": sa[f"norm_{proj}"]["w"][perm]}
    if quant:
        for mod, name in _QUANT_TARGETS:
            p = bp[mod][name]
            new = ({"w": quantize_weight(p["w"])} if quant == "store"
                   else {"w8": quantize_weight_for_compute(p["w"])})
            if "b" in p:
                new["b"] = p["b"]
            bp[mod][name] = new
    return bp


def prepare_fast_params(params, cfg, quant=True):
    """Return a fast-path parameter tree (see the module docstring)."""
    device = params["blocks"][0]["self_attn"]["q"]["w"].device
    perm = torch.as_tensor(split_pair_permutation(cfg.head_dim, cfg.num_heads),
                           dtype=torch.long, device=device)
    out = dict(params)
    out["blocks"] = [_prepare_block(bp, perm, quant) for bp in params["blocks"]]
    return out
