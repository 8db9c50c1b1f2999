"""Host-streamed ("sequential offload") DiT forward, port of
`stableavatar_tpu/models/streaming.py`: the DiT's blocks live in host
memory and stream through the card one at a time.

- Every parameter outside the block stack (patch embedding, time / text /
  image embeddings, vocal projector, head) stays resident on the device.
- Each block is packed into one flat host buffer (pinned on a CUDA run,
  each leaf at a 256-byte aligned offset), so a block crosses PCIe in one
  copy and its leaves are views of the device copy.
- The forward runs `dit_prologue`, then the blocks through two persistent
  device slots, then `_apply_head`: block k+1's host-to-device copy is
  issued on a side stream before block k's compute, after the compute that
  last read its slot (block k-1) has finished; the compute stream waits for
  the copy's event before it reads the slot.  At most two blocks are on the
  device at once, and the slots are never freed while a copy or a compute
  can touch them, so the caching allocator has no part in the ordering.

Numerics: the prologue, block and head are the functions `dit_forward`
runs (`models/dit.py:dit_prologue`, `apply_block`, `_apply_head`), on the
same values, so the streamed forward equals the in-memory one bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from stableavatar_tpu_torch.models.dit import _apply_head, apply_block, dit_prologue
from stableavatar_tpu_torch.pipelines.common import resolve_device
from stableavatar_tpu_torch.utils.tree import tree_leaves, tree_map

_ALIGN = 256  # bytes; every leaf of a packed block starts at such an offset


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where a leaf lies in its block's flat buffer."""

    offset: int
    dtype: torch.dtype
    shape: tuple


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _view_size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _view(flat: torch.Tensor, s: _Slot) -> torch.Tensor:
    n = int(torch.Size(s.shape).numel()) * _view_size(s.dtype)
    return flat[s.offset:s.offset + n].view(s.dtype).view(s.shape)


def _kept(t: torch.Tensor, dtype) -> torch.dtype:
    """The dtype a leaf is kept in: floating leaves cast to `dtype` (None
    keeps every leaf's own)."""
    return dtype if dtype is not None and t.is_floating_point() else t.dtype


class HostBlock:
    """One DiT block packed into a flat host buffer (`flat`, uint8) with the
    tree of its leaves' places (`layout`); floating leaves cast to `dtype`
    on the way in, wherever they lay."""

    def __init__(self, block, pin: bool = False, dtype=None):
        offset = 0

        def place(t):
            nonlocal offset
            s = _Slot(offset, _kept(t, dtype), tuple(t.shape))
            offset += -(-t.numel() * _view_size(s.dtype) // _ALIGN) * _ALIGN
            return s

        self.layout = tree_map(place, block)
        self.nbytes = offset
        self.flat = torch.empty(offset, dtype=torch.uint8, pin_memory=pin)
        tree_map(lambda t, s: _view(self.flat, s).copy_(t), block, self.layout)

    def tree(self, flat: Optional[torch.Tensor] = None):
        """The block's leaves as views of `flat` (default: the host buffer)."""
        flat = self.flat if flat is None else flat
        return tree_map(lambda s: _view(flat, s), self.layout)


def split_streaming_params(params, pin: bool = False, dtype=None):
    """(resident_params, host_blocks): the tree without "blocks", and each
    block packed into host memory (pinned when `pin`, floating leaves cast
    to `dtype`).  The caller drops its own block tensors afterwards."""
    resident = {k: v for k, v in params.items() if k != "blocks"}
    return resident, [HostBlock(bp, pin, dtype) for bp in params["blocks"]]


class StreamedDiT:
    """Callable DiT forward with host-resident blocks (module docstring).

    `params` may be raw or `utils/fastpath.py:prepare_fast_params`-prepared
    (int8 weights then halve the bytes a block streams), on the device or
    the host; `dtype` casts its floating leaves (None keeps them)."""

    def __init__(self, params, cfg, *, rope_split: bool = False, attn_quant: str = "none",
                 attn_impl: str = "ulysses", honor_vocal_k_lens: bool = True, device="cuda",
                 dtype=None):
        device = resolve_device(device)
        resident, self.host_blocks = split_streaming_params(params, pin=device.type == "cuda",
                                                            dtype=dtype)
        self.resident = tree_map(
            lambda x: x.to(device=device, dtype=_kept(x, dtype)) if torch.is_tensor(x) else x,
            resident)
        self.cfg = cfg
        self.rope_split = rope_split
        self.attn_quant = attn_quant
        self.attn_impl = attn_impl
        self.honor_vocal_k_lens = honor_vocal_k_lens
        self.device = device
        # two device slots of the largest block, and per slot the event of
        # the last compute that read it (kept across calls)
        size = max(hb.nbytes for hb in self.host_blocks)
        self.slots = [torch.empty(size, dtype=torch.uint8, device=device) for _ in range(2)]
        self._freed = [None, None]
        self._copy_stream = None
        if device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device)
            for slot in self.slots:  # freeing a slot waits for its last copy
                slot.record_stream(self._copy_stream)

    @property
    def num_layers(self) -> int:
        return len(self.host_blocks)

    @property
    def resident_bytes(self) -> int:
        return sum(_nbytes(x) for x in tree_leaves(self.resident) if torch.is_tensor(x))

    def _put(self, i: int):
        """Issue block i's copy into slot i % 2: on the side stream, after
        the compute that last read the slot; returns the copy's event (None
        off CUDA, where the copy is done on return)."""
        s, hb = i % 2, self.host_blocks[i]
        dst = self.slots[s][:hb.nbytes]
        if self._copy_stream is None:
            dst.copy_(hb.flat)
            return None
        with torch.cuda.stream(self._copy_stream):
            if self._freed[s] is not None:
                self._copy_stream.wait_event(self._freed[s])
            dst.copy_(hb.flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return done

    def blocks(self):
        """Yield each block's tree on the device, block k+1's copy issued
        before block k is handed out; the caller enqueues block k's compute
        before it asks for the next."""
        n = self.num_layers
        copied = {0: self._put(0)}
        for i in range(n):
            if i + 1 < n:
                copied[i + 1] = self._put(i + 1)
            s = i % 2
            done = copied.pop(i)
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
            yield self.host_blocks[i].tree(self.slots[s])
            if self._copy_stream is not None:
                freed = torch.cuda.Event()
                freed.record(torch.cuda.current_stream(self.device))
                self._freed[s] = freed

    def __call__(self, x, t, text_embeds, clip_fea, y, vocal_embeddings,
                 video_sample_n_frames: int = 81, vocal_cfg_tile: bool = False,
                 is_clip_level_modeling: bool = False, return_residual: bool = False):
        """Same contract as `dit_forward` (without remat or a freqs override)."""
        (tokens, e, e0, ctx_t, ctx_i, vocal_ctx, vocal_k_lens, freqs, rope_packed, grid,
         lnf) = dit_prologue(
            self.resident, self.cfg, x, t, text_embeds, clip_fea, y, vocal_embeddings,
            video_sample_n_frames=video_sample_n_frames, vocal_cfg_tile=vocal_cfg_tile,
            is_clip_level_modeling=is_clip_level_modeling, rope_split=self.rope_split,
            honor_vocal_k_lens=self.honor_vocal_k_lens)
        tokens_in = tokens
        for bp in self.blocks():
            tokens = apply_block(bp, tokens, e0, ctx_t, ctx_i, vocal_ctx, vocal_k_lens, freqs,
                                 self.cfg, lnf, rope_packed=rope_packed,
                                 attn_quant=self.attn_quant, attn_impl=self.attn_impl,
                                 fuse_cross=self.attn_quant != "none")
        out = _apply_head(self.resident, self.cfg, tokens, e, grid)
        if return_residual:
            return out, tokens - tokens_in
        return out
