"""Wan2.1 DiT backbone, port of `stableavatar_tpu/models/dit.py`.

Plain functions over a parameter tree of tensors.  The JAX package stacks
the block parameters on a leading layer axis for `lax.scan`; here `blocks`
is a list of per-layer dicts walked by a Python loop.  Linear weights are in
`nn.Linear` layout [d_out, d_in].  The patch embedding stays a reshape plus
one matmul, as in the JAX package.

Under a mesh (`parallel/mesh.py:mesh_context`) whose 'sp' axis has W > 1
ranks, `dit_forward` runs the blocks sequence-parallel: the prologue (the
vocal projector reads every token) runs whole on every rank, then rank r
keeps tokens [r L/W, (r+1) L/W), and the tokens are all-gathered before the
head.  Self-attention either turns [B, L/W, N, D] into [B, L, N/W, D] with
an all-to-all around the attention call and back (attn_impl="ulysses"), or
keeps the tokens where they are and rotates K/V around the ring
(attn_impl="ring", `ops/ring_attention.py`, rope applied first); the
cross-attention runs on the local queries.  Parameters sharded over 'fsdp'
(`parallel/sharding.py:shard_params`) are gathered block by block (inside
the remat checkpoint, so the backward gathers again).  The gathers and the
Ulysses all-to-alls carry gradients (`parallel/mesh.py`), so training runs
the same paths (`train/trainer.py`); the ring is inference only.  One
rank, or no mesh, takes none of these paths.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.ops.cross_attention import dual_context_attention
from stableavatar_tpu_torch.ops.embeddings import sinusoidal_embedding_1d
from stableavatar_tpu_torch.ops.norms import layer_norm, rms_norm
from stableavatar_tpu_torch.ops.ring_attention import ring_attention
from stableavatar_tpu_torch.ops.rope import (
    RopeFreqs,
    pack_split,
    rope_apply,
    rope_apply_split,
    rope_freqs_3d,
)
from stableavatar_tpu_torch.parallel.mesh import (
    all_gather_dim0,
    all_to_all_dim0,
    axis_group,
    axis_rank,
    axis_size,
)
from stableavatar_tpu_torch.parallel.sharding import gather_block
from stableavatar_tpu_torch.models.vocal_projector import (
    _affine,
    _linear,
    _normal,
    _ones,
    apply_linear,
    apply_vocal_projector,
    gelu_exact,
    gelu_tanh,
    init_vocal_projector,
)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(gen, cfg, device="cuda", dtype=torch.float32):
    d = cfg.dim
    kw = dict(device=device, dtype=dtype)
    return {
        "self_attn": {
            "q": _linear(gen, d, d, **kw),
            "k": _linear(gen, d, d, **kw),
            "v": _linear(gen, d, d, **kw),
            "o": _linear(gen, d, d, **kw),
            "norm_q": _ones(d, device, dtype),
            "norm_k": _ones(d, device, dtype),
        },
        "norm3": _affine(d, device, dtype),
        "cross_attn": {
            "q": _linear(gen, d, d, **kw),
            "k": _linear(gen, d, d, **kw),
            "v": _linear(gen, d, d, **kw),
            "o": _linear(gen, d, d, **kw),
            "norm_q": _ones(d, device, dtype),
            "norm_k": _ones(d, device, dtype),
            "k_img": _linear(gen, d, d, **kw),
            "v_img": _linear(gen, d, d, **kw),
            "norm_k_img": _ones(d, device, dtype),
            # zero-init vocal branch, as in the reference
            "k_vocal": _linear(gen, d, d, zero=True, **kw),
            "v_vocal": _linear(gen, d, d, zero=True, **kw),
        },
        "ffn": {
            "fc1": _linear(gen, d, cfg.ffn_dim, **kw),
            "fc2": _linear(gen, cfg.ffn_dim, d, **kw),
        },
        "modulation": _normal(gen, (1, 6, d), d ** -0.5, device, dtype),
    }


def init_dit(gen: torch.Generator, cfg, device="cuda", dtype=torch.float32):
    """Random parameter tree, drawn on `device` from `gen` (a generator on
    that device) with the JAX package's distributions."""
    d = cfg.dim
    kw = dict(device=device, dtype=dtype)
    patch_in = cfg.in_dim * math.prod(cfg.patch_size)
    return {
        "patch_embedding": _linear(gen, patch_in, d, **kw),
        "text_embedding": {
            "fc1": _linear(gen, cfg.text_dim, d, init="normal", **kw),
            "fc2": _linear(gen, d, d, init="normal", **kw),
        },
        "time_embedding": {
            "fc1": _linear(gen, cfg.freq_dim, d, init="normal", **kw),
            "fc2": _linear(gen, d, d, init="normal", **kw),
        },
        "time_projection": {"fc": _linear(gen, d, d * 6, **kw)},
        "img_emb": {
            "norm1": _affine(cfg.clip_dim, device, dtype),
            "fc1": _linear(gen, cfg.clip_dim, cfg.clip_dim, **kw),
            "fc2": _linear(gen, cfg.clip_dim, d, **kw),
            "norm2": _affine(d, device, dtype),
        },
        "blocks": [init_block(gen, cfg, device, dtype) for _ in range(cfg.num_layers)],
        "head": {
            "head": _linear(gen, d, math.prod(cfg.patch_size) * cfg.out_dim, zero=True, **kw),
            "modulation": _normal(gen, (1, 2, d), d ** -0.5, device, dtype),
        },
        "vocal_projector": init_vocal_projector(gen, cfg, device, dtype),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


ATTN_IMPLS = ("ulysses", "ring")


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's slice of the token sequence: tokens [start, start +
    length) of `total`, one of `size` equal slices over the sp `group`."""

    group: dist.ProcessGroup
    size: int
    start: int
    length: int
    total: int


def _seq_shard(length: int) -> Optional[SeqShard]:
    """The active mesh's sequence slice of a [B, length, ...] activation
    that is already sliced, or None with one sp rank (or no mesh)."""
    w = axis_size("sp")
    if w == 1:
        return None
    return SeqShard(axis_group("sp"), w, axis_rank("sp") * length, length, w * length)


def _rope_rows(freqs: RopeFreqs, rope_packed, sp: Optional[SeqShard]):
    """The rope tables' rows of this rank's tokens."""
    if sp is None:
        return freqs, rope_packed
    rows = slice(sp.start, sp.start + sp.length)
    return (RopeFreqs(freqs.cos[rows], freqs.sin[rows]),
            None if rope_packed is None else rope_packed[rows])


def _seq_to_heads(x, sp: SeqShard):
    """Ulysses all-to-all: [B, L/W, N, D] -> [B, L, N/W, D] (rank j gets head
    group j of every slice, in slice order)."""
    b, lw, n, d = x.shape
    send = x.reshape(b, lw, sp.size, n // sp.size, d).permute(2, 0, 1, 3, 4)
    recv = all_to_all_dim0(send, sp.group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, sp.size * lw, n // sp.size, d)


def _heads_to_seq(x, sp: SeqShard):
    """The inverse all-to-all: [B, L, N/W, D] -> [B, L/W, N, D]."""
    b, l, nw, d = x.shape
    send = x.reshape(b, sp.size, l // sp.size, nw, d).permute(1, 0, 2, 3, 4)
    recv = all_to_all_dim0(send, sp.group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, l // sp.size, sp.size * nw, d)


def _gather_seq(x, sp: SeqShard):
    """All-gather the token slices: [B, L/W, C] -> [B, L, C].  Every rank
    of the group computes the same output from here, so under autograd the
    summing reduce-scatter of the backward gives each slice W times its
    gradient: `train/trainer.py:train_step` divides each rank's loss by the
    ranks that compute it."""
    full = all_gather_dim0(x, sp.group).reshape(sp.size, *x.shape)
    return full.transpose(0, 1).reshape(x.shape[0], sp.size * x.shape[1], *x.shape[2:])


def _self_attention(p, x, freqs: RopeFreqs, num_heads, eps, rope_packed=None, quant="none",
                    attn_impl="ulysses"):
    """WanSelfAttention.  With `rope_packed` (fast path) q/k weights are in
    split-pair layout and rope is applied by the attention call (by this
    function before the ring under attn_impl="ring", as in the JAX
    package); otherwise it is applied here from the interleaved tables.
    `freqs` / `rope_packed` cover the whole sequence; under sequence
    parallelism x holds this rank's tokens (see the module docstring)."""
    b, l, dim = x.shape
    d = dim // num_heads
    sp = _seq_shard(l)
    freqs_local, rope_local = _rope_rows(freqs, rope_packed, sp)
    q = rms_norm(apply_linear(p["q"], x), p["norm_q"]["w"], eps).reshape(b, l, num_heads, d)
    k = rms_norm(apply_linear(p["k"], x), p["norm_k"]["w"], eps).reshape(b, l, num_heads, d)
    v = apply_linear(p["v"], x).reshape(b, l, num_heads, d)
    if rope_packed is None:
        q = rope_apply(q, freqs_local).to(x.dtype)
        k = rope_apply(k, freqs_local).to(x.dtype)
    elif attn_impl == "ring":
        # positions are global and K/V move between ranks: rope first
        q = rope_apply_split(q, rope_local).to(x.dtype)
        k = rope_apply_split(k, rope_local).to(x.dtype)
        rope_packed = None
    else:
        q = q.to(x.dtype)
        k = k.to(x.dtype)
    if sp is None:
        out = attention(q, k, v, rope=rope_packed, quant=quant)
    elif attn_impl == "ring":
        out = ring_attention(q, k, v, group=sp.group, quant=quant)
    else:
        q, k, v = (_seq_to_heads(t, sp) for t in (q, k, v))
        out = _heads_to_seq(attention(q, k, v, rope=rope_packed, quant=quant), sp)
    return apply_linear(p["o"], out.reshape(b, l, dim))


def _cross_attention(p, x, context_text, context_img, vocal_context, vocal_k_lens,
                     num_heads, latents_num_frames, eps, fused=False):
    """Text + image + per-frame vocal cross-attention, summed; bf16 (no int8
    attention) as in the JAX package.  `fused` takes the K5 kernel for the
    text + image pair.  Under sequence parallelism x holds this rank's
    tokens, which may start and end inside a latent frame."""
    b, l, dim = x.shape
    d = dim // num_heads
    f = latents_num_frames
    dt = x.dtype

    q = rms_norm(apply_linear(p["q"], x), p["norm_q"]["w"], eps).to(dt).reshape(b, l, num_heads, d)
    k = rms_norm(apply_linear(p["k"], context_text), p["norm_k"]["w"], eps).to(dt)
    v = apply_linear(p["v"], context_text)
    k = k.reshape(b, -1, num_heads, d)
    v = v.reshape(b, -1, num_heads, d)
    k_img = rms_norm(apply_linear(p["k_img"], context_img), p["norm_k_img"]["w"], eps).to(dt)
    v_img = apply_linear(p["v_img"], context_img)
    k_img = k_img.reshape(b, -1, num_heads, d)
    v_img = v_img.reshape(b, -1, num_heads, d)

    if fused:
        txt_img = dual_context_attention(q, k, v, k_img, v_img)
    else:
        txt_img = attention(q, k, v) + attention(q, k_img, v_img)

    if vocal_context.shape[1] == 1:
        # clip-level mode: one global pass over all windows' vocal tokens
        vk = apply_linear(p["k_vocal"], vocal_context[:, 0]).reshape(b, -1, num_heads, d)
        vv = apply_linear(p["v_vocal"], vocal_context[:, 0]).reshape(b, -1, num_heads, d)
        voc = attention(q, vk, vv)
    else:
        # vocal branch: per-latent-frame attention, q regrouped to [b*nf,
        # tokens per frame, ...] over the frames this rank's tokens touch (all
        # f without sequence parallelism); a slice that starts or ends inside
        # a frame is zero-padded to whole frames, the padding rows dropped
        sp = _seq_shard(l)
        start, total = (0, l) if sp is None else (sp.start, sp.total)
        per = total // f
        f0, f1 = start // per, -(-(start + l) // per)
        off, nf = start - f0 * per, f1 - f0
        vq = q if (off, nf * per) == (0, l) else torch.cat(
            [q.new_zeros((b, off, num_heads, d)), q,
             q.new_zeros((b, nf * per - off - l, num_heads, d))], dim=1)
        vq = vq.reshape(b * nf, per, num_heads, d)
        vc = vocal_context[:, f0:f1]
        vk = apply_linear(p["k_vocal"], vc).reshape(b * nf, -1, num_heads, d)
        vv = apply_linear(p["v_vocal"], vc).reshape(b * nf, -1, num_heads, d)
        klens = None if vocal_k_lens is None else vocal_k_lens[f0:f1].repeat(b)
        voc = attention(vq, vk, vv, k_lens=klens).reshape(b, nf * per, num_heads, d)
        voc = voc[:, off:off + l]

    out = txt_img.reshape(b, l, dim) + voc.reshape(b, l, dim)
    return apply_linear(p["o"], out)


def apply_block(p, x, e0, context_text, context_img, vocal_context, vocal_k_lens,
                freqs: RopeFreqs, cfg, latents_num_frames: int, rope_packed=None,
                attn_quant="none", attn_impl="ulysses", fuse_cross=False):
    """WanAttentionBlock; x holds this rank's tokens under sequence
    parallelism, `attn_impl` picks its self-attention strategy."""
    e = p["modulation"].to(e0.dtype) + e0  # [B, 6, dim]
    e = [e[:, i : i + 1] for i in range(6)]

    temp = (layer_norm(x, eps=cfg.eps) * (1 + e[1]) + e[0]).to(x.dtype)
    y = _self_attention(p["self_attn"], temp, freqs, cfg.num_heads, cfg.eps,
                        rope_packed=rope_packed, quant=attn_quant, attn_impl=attn_impl)
    x = x + y * e[2]

    normed = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], eps=cfg.eps)
    x = x + _cross_attention(p["cross_attn"], normed.to(x.dtype), context_text, context_img,
                             vocal_context, vocal_k_lens, cfg.num_heads, latents_num_frames,
                             cfg.eps, fused=fuse_cross)

    temp = (layer_norm(x, eps=cfg.eps) * (1 + e[4]) + e[3]).to(x.dtype)
    y = apply_linear(p["ffn"]["fc2"], gelu_tanh(apply_linear(p["ffn"]["fc1"], temp)))
    return x + y * e[5]


def patchify(x: torch.Tensor, patch_size: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, F*(H/ph)*(W/pw), C*pt*ph*pw], channel-major
    patches (the Conv3d(kernel=stride=patch) weight order)."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch_size
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid, patch_size, out_dim: int) -> torch.Tensor:
    """[B, L, pt*ph*pw*C] -> [B, C, F, H, W] (reference 'fhwpqrc->cfphqwr')."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def time_embeddings(params, cfg, t: torch.Tensor, dtype):
    """e [B, dim] and e0 [B, 6, dim], fp32 inside."""
    emb = sinusoidal_embedding_1d(cfg.freq_dim, t.float())
    te = params["time_embedding"]
    e = apply_linear(te["fc2"], F.silu(apply_linear(te["fc1"], emb.float())))
    e0 = apply_linear(params["time_projection"]["fc"], F.silu(e))
    e0 = e0.reshape(e0.shape[0], 6, cfg.dim)
    return e.to(dtype), e0.to(dtype)


def encode_context(params, cfg, text_embeds, clip_fea, dtype):
    """Text MLP (tanh GELU) and CLIP-image MLPProj (exact GELU)."""
    tp = params["text_embedding"]
    context_text = apply_linear(tp["fc2"], gelu_tanh(apply_linear(tp["fc1"], text_embeds.to(dtype))))
    ip = params["img_emb"]
    h = layer_norm(clip_fea.to(dtype), ip["norm1"]["w"], ip["norm1"]["b"], eps=1e-5)
    h = gelu_exact(apply_linear(ip["fc1"], h))
    h = apply_linear(ip["fc2"], h)
    context_img = layer_norm(h, ip["norm2"]["w"], ip["norm2"]["b"], eps=1e-5)
    return context_text, context_img


def dit_prologue(params, cfg, x, t, text_embeds, clip_fea, y, vocal_embeddings,
                 video_sample_n_frames: int = 81, vocal_cfg_tile: bool = False,
                 is_clip_level_modeling: bool = False, freqs: Optional[RopeFreqs] = None,
                 rope_split: bool = False, honor_vocal_k_lens: bool = True):
    """Everything before the block stack: patch embed, rope tables (unless
    `freqs` are given), time / text / image embeddings, vocal projector.
    Returns (tokens, e, e0, context_text, context_img, vocal_context,
    vocal_k_lens, freqs, rope_packed, grid, latents_num_frames)."""
    b, _, f, h, w = x.shape
    pt, ph, pw = cfg.patch_size
    grid = (f // pt, h // ph, w // pw)
    dtype = x.dtype

    xin = torch.cat([x, y.to(dtype)], dim=1)
    tokens = apply_linear(params["patch_embedding"], patchify(xin, cfg.patch_size))

    if freqs is None:
        freqs = rope_freqs_3d(grid, cfg.head_dim, riflex_k=cfg.riflex_k,
                              riflex_L_test=cfg.riflex_L_test, riflex_scale=cfg.riflex_scale,
                              device=x.device)
    rope_packed = pack_split(freqs) if rope_split else None

    e, e0 = time_embeddings(params, cfg, t, dtype)
    context_text, context_img = encode_context(params, cfg, text_embeds, clip_fea, dtype)

    vocal_embeddings = vocal_embeddings.to(dtype)
    if vocal_cfg_tile:
        # CFG triple: the projector runs on the last row, tiled as [0, v, v]
        vocal_context, vocal_k_lens = apply_vocal_projector(
            params["vocal_projector"], cfg, vocal_embeddings[-1:], tokens[-1:], e0[-1:],
            e[-1:], video_sample_n_frames)
        vocal_context = torch.cat(
            [torch.zeros_like(vocal_context), vocal_context, vocal_context], dim=0)
    else:
        vocal_context, vocal_k_lens = apply_vocal_projector(
            params["vocal_projector"], cfg, vocal_embeddings, tokens, e0, e,
            video_sample_n_frames)
    if not honor_vocal_k_lens:
        vocal_k_lens = None

    latents_num_frames = (video_sample_n_frames - 1) // 4 + 1
    if is_clip_level_modeling:
        # clip-level: all windows concatenated into one global vocal context
        # [B, 1, F*Lw, C]; the cross-attention runs one global pass
        vocal_context = vocal_context.reshape(vocal_context.shape[0], 1, -1,
                                              vocal_context.shape[-1])
        vocal_k_lens = None
    return (tokens, e, e0, context_text, context_img, vocal_context, vocal_k_lens, freqs,
            rope_packed, grid, latents_num_frames)


def _sp_check(cfg, n_tokens: int, attn_impl: str) -> Optional[int]:
    """The sp size when the blocks run sequence-parallel (None otherwise),
    after checking that it splits what it has to split."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
    w = axis_size("sp")
    if w == 1:
        return None
    if n_tokens % w:
        raise ValueError(f"sequence parallelism over {w} ranks needs the token count to be a "
                         f"multiple of {w}: {n_tokens} tokens")
    if attn_impl == "ulysses" and cfg.num_heads % w:
        raise ValueError(f"Ulysses over {w} ranks needs the head count to be a multiple of {w}: "
                         f"{cfg.num_heads} heads (attn_impl='ring' splits tokens only)")
    return w


def _gathered_block(bp, x, **kw):
    return apply_block(gather_block(bp), x, **kw)


def _top_params(params):
    """The parameters outside the block stack, gathered where sharded."""
    return gather_block({k: v for k, v in params.items() if k != "blocks"})


def dit_forward(params, cfg, x, t, text_embeds, clip_fea, y, vocal_embeddings,
                video_sample_n_frames: int = 81, vocal_cfg_tile: bool = False,
                is_clip_level_modeling: bool = False, freqs: Optional[RopeFreqs] = None,
                remat: bool = False, rope_split: bool = False, attn_quant: str = "none",
                attn_impl: str = "ulysses", honor_vocal_k_lens: bool = True,
                return_residual: bool = False):
    """One denoise evaluation; returns the velocity [B, 16, F, H, W] in fp32.

    x [B, 16, F, H, W], t [B], text_embeds [B, text_len, text_dim], clip_fea
    [B, 257, clip_dim], y [B, 20, F, H, W], vocal_embeddings [Bv, La, 768].
    `is_clip_level_modeling` (training) makes the vocal cross-attention one
    global pass over all windows.  `remat` recomputes each block in the
    backward (`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`
    around the scanned block): only the block inputs stay alive.
    `rope_split` needs params from `utils/fastpath.py:prepare_fast_params`;
    `attn_quant` in {"none", "qk", "qkv", "qkpv"} picks the self-attention
    kernel (K1, or K2 / K2v / K3 by `ops/flash_attention.py:STATIC_MAX`), and
    the fused cross-attention kernel K5 is on exactly when it is not "none"
    (the JAX package's `fuse_cross_attn` auto rule).  `attn_impl`
    ("ulysses" | "ring") is the sequence-parallel self-attention under a
    mesh with more than one 'sp' rank (module docstring).
    `honor_vocal_k_lens=False` drops the vocal padding masks like the
    reference's SDPA deployment.  `return_residual` also returns the block
    stack's delta [B, L, dim] (TeaCache's cached residual).
    """
    top = _top_params(params)
    (tokens, e, e0, context_text, context_img, vocal_context, vocal_k_lens, freqs,
     rope_packed, grid, latents_num_frames) = dit_prologue(
        top, cfg, x, t, text_embeds, clip_fea, y, vocal_embeddings,
        video_sample_n_frames=video_sample_n_frames, vocal_cfg_tile=vocal_cfg_tile,
        is_clip_level_modeling=is_clip_level_modeling, freqs=freqs,
        rope_split=rope_split, honor_vocal_k_lens=honor_vocal_k_lens)

    tokens_in = tokens
    w = _sp_check(cfg, tokens.shape[1], attn_impl)
    if w is not None:
        lw = tokens.shape[1] // w
        r = axis_rank("sp")
        tokens = tokens[:, r * lw:(r + 1) * lw]
    for bp in params["blocks"]:
        # the block's fsdp gather runs inside the checkpointed function, so
        # remat drops the gathered tensors and the recomputation gathers
        # them again (every rank in the same order)
        block = functools.partial(
            _gathered_block, bp, e0=e0, context_text=context_text,
            context_img=context_img, vocal_context=vocal_context, vocal_k_lens=vocal_k_lens,
            freqs=freqs, cfg=cfg, latents_num_frames=latents_num_frames,
            rope_packed=rope_packed, attn_quant=attn_quant, attn_impl=attn_impl,
            fuse_cross=attn_quant != "none")
        tokens = checkpoint(block, tokens, use_reentrant=False) if remat else block(tokens)
    if w is not None:
        tokens = _gather_seq(tokens, _seq_shard(tokens.shape[1]))
    out = _apply_head(top, cfg, tokens, e, grid)
    if return_residual:
        return out, tokens - tokens_in
    return out


def _apply_head(params, cfg, tokens, e, grid):
    """Head + unpatchify."""
    hp = params["head"]
    hm = hp["modulation"].to(e.dtype) + e[:, None]
    h0, h1 = hm[:, 0:1], hm[:, 1:2]
    out = apply_linear(hp["head"], layer_norm(tokens, eps=cfg.eps) * (1 + h1) + h0)
    return unpatchify(out.float(), grid, cfg.patch_size, cfg.out_dim)


def dit_time_e0(params, cfg, t: torch.Tensor, dtype=torch.bfloat16):
    """The modulated time embedding e0 [B, 6, dim]: TeaCache's input."""
    return time_embeddings(_top_params(params), cfg, t, dtype)[1]


def dit_forward_skip(params, cfg, x, t, y, residual):
    """TeaCache's skip path: patch embedding + the cached block-stack
    residual [B, L, dim] + head, no blocks.  It has no attention, so under
    sequence parallelism it runs whole on every rank on the whole residual
    (which `dit_forward` returns gathered)."""
    params = _top_params(params)
    b, _, f, h, w = x.shape
    pt, ph, pw = cfg.patch_size
    grid = (f // pt, h // ph, w // pw)
    xin = torch.cat([x, y.to(x.dtype)], dim=1)
    tokens = apply_linear(params["patch_embedding"], patchify(xin, cfg.patch_size))
    e, _ = time_embeddings(params, cfg, t, x.dtype)
    tokens = tokens + residual.to(tokens.dtype)
    return _apply_head(params, cfg, tokens, e, grid)
