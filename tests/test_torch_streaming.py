"""The port's host-streamed DiT (`models/streaming.py`) equals its in-memory
`dit_forward` bit for bit -- fp32 and bf16 parameters, the prepared fast
path, and `generate_long` with `models.streamed_dit` set -- and
`generate_long` refuses the modes the JAX package does not stream
(mirroring tests/test_streaming.py:45-138).  The weights are the JAX
package's, bridged."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stableavatar_tpu.config import DiTConfig
from stableavatar_tpu.models.dit import init_dit
from stableavatar_tpu_torch.models.dit import dit_forward
from stableavatar_tpu_torch.models.streaming import HostBlock, StreamedDiT, split_streaming_params
from stableavatar_tpu_torch.models.teacache import TeaCache, get_teacache_coefficients
from stableavatar_tpu_torch.pipelines import long as tlong
from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params
from stableavatar_tpu_torch.utils.tree import tree_paths
from stableavatar_tpu_torch.utils.weights import dit_from_jax
from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    _inputs,
    jax_models,
    port_models,
)
from tests.torch_parity import densify_dit, jit_init, to_numpy_tree

# tests/test_streaming.py's config
TINY = DiTConfig(dim=48, ffn_dim=96, freq_dim=32, text_dim=64, num_heads=4, num_layers=3,
                 text_len=16, clip_tokens=9, clip_dim=40, audio_proj_dim=48, vocal_num_heads=4)


def _params(dtype):
    jp = densify_dit(jit_init(init_dit, TINY, jax.random.PRNGKey(1)))
    return dit_from_jax(to_numpy_tree(jp), dtype=dtype)


def _dit_inputs(dtype, b=3, f=3, h=8, w=8):
    rng = np.random.default_rng(2)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return (r(b, 16, f, h, w).to(dtype), torch.full((b,), 500.0), r(b, TINY.text_len, TINY.text_dim),
            r(b, TINY.clip_tokens, TINY.clip_dim), r(b, 20, f, h, w), r(1, 20, TINY.audio_in_dim))


def test_split_streaming_params_partition():
    params = _params(torch.float32)
    resident, host_blocks = split_streaming_params(params)
    assert "blocks" not in resident and len(host_blocks) == TINY.num_layers
    assert all(isinstance(hb, HostBlock) for hb in host_blocks)
    w0 = host_blocks[0].tree()["self_attn"]["q"]["w"]
    assert w0.shape == (TINY.dim, TINY.dim) and w0.device.type == "cpu"
    # every leaf is a view of the block's one flat buffer, at its own offset
    for (path, leaf), (_, want) in zip(tree_paths(host_blocks[1].tree()),
                                       tree_paths(params["blocks"][1])):
        assert leaf.untyped_storage().data_ptr() == host_blocks[1].flat.untyped_storage().data_ptr()
        assert torch.equal(leaf, want), path
    # floating leaves cast on the way in
    _, cast = split_streaming_params(params, dtype=torch.bfloat16)
    assert cast[0].tree()["ffn"]["fc1"]["w"].dtype == torch.bfloat16
    assert cast[0].nbytes < host_blocks[0].nbytes


@pytest.mark.parametrize("dtype,return_residual", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.bfloat16, True)])
def test_streamed_equals_in_memory(dtype, return_residual):
    params = _params(dtype)
    args = _dit_inputs(dtype)
    kw = dict(video_sample_n_frames=9, vocal_cfg_tile=True, return_residual=return_residual)
    with torch.no_grad():
        want = dit_forward(params, TINY, *args, **kw)
        sdit = StreamedDiT(params, TINY, device="cpu")
        got = sdit(*args, **kw)
        again = sdit(*args, **kw)  # the slots are reused across calls
    for a, b, c in zip(*((x,) if not return_residual else x for x in (got, want, again))):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("quant,attn_quant", [("store", "none"), (True, "qk")])
def test_streamed_equals_in_memory_fastpath(quant, attn_quant):
    """Streaming composes with the prepared fast path (int8 weights halve
    the bytes a block streams), bit for bit (tests/test_streaming.py:84
    holds it to 2e-2)."""
    prepared = prepare_fast_params(_params(torch.bfloat16), TINY, quant=quant)
    args = _dit_inputs(torch.bfloat16)
    kw = dict(video_sample_n_frames=9, vocal_cfg_tile=True)
    with torch.no_grad():
        want = dit_forward(prepared, TINY, *args, rope_split=True, attn_quant=attn_quant, **kw)
        sdit = StreamedDiT(prepared, TINY, rope_split=True, attn_quant=attn_quant, device="cpu")
        got = sdit(*args, **kw)
    assert torch.equal(got, want)
    assert sdit.host_blocks[0].tree()["ffn"]["fc1"]["w8" if quant is True else "w"]["q"].dtype \
        == torch.int8


def test_streamed_pipeline_matches_in_memory(jax_models):
    """generate_long with models.streamed_dit set equals the in-memory path
    bit for bit (Euler, two windows with overlap blending)."""
    ref, wav, text_ctx, latents = _inputs()
    kw = dict(ref_image=ref, vocal_waveform=wav, text_ctx=torch.from_numpy(text_ctx),
              num_inference_steps=2, clip_length=9, overlap_window_length=1,
              initial_latents=latents, output_type="latent")
    models = port_models(jax_models, False)
    want = tlong.generate_long(models, **kw)
    streamed = dataclasses.replace(models, dit_params=None, streamed_dit=StreamedDiT(
        models.dit_params, models.dit_cfg, rope_split=models.rope_split,
        attn_quant=models.attn_quant, honor_vocal_k_lens=models.honor_vocal_k_lens,
        device="cpu"))
    got = tlong.generate_long(streamed, **kw)
    assert torch.equal(got.latents, want.latents)


@pytest.mark.parametrize("scheduler,teacache", [("unipc", False), ("dpm++", False),
                                                ("euler", True)])
def test_streamed_pipeline_rejects_unsupported_modes(jax_models, scheduler, teacache):
    """As the JAX package: the streamed DiT serves Euler without TeaCache."""
    ref, wav, text_ctx, _ = _inputs()
    models = port_models(jax_models, False)
    models = dataclasses.replace(
        models, streamed_dit=StreamedDiT(models.dit_params, models.dit_cfg, device="cpu"),
        teacache=TeaCache(get_teacache_coefficients("wan2.1-t2v-1.3b"), 2) if teacache else None)
    with pytest.raises(ValueError, match="sequential"):
        tlong.generate_long(models, ref_image=ref, vocal_waveform=wav,
                            text_ctx=torch.from_numpy(text_ctx), num_inference_steps=2,
                            clip_length=9, overlap_window_length=1, scheduler=scheduler)
