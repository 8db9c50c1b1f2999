"""The port's causal VAE against the JAX package's on the tiny config of
tests/test_pipeline.py (weights through the bridge, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stableavatar_tpu.models import vae as jvae
from stableavatar_tpu_torch.models import vae as tvae
from stableavatar_tpu_torch.utils.weights import from_jax_tree
from tests.test_pipeline import VAE_E2E
from tests.torch_parity import jit_init, t, to_numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jit_init(jvae.init_vae, VAE_E2E, jax.random.PRNGKey(1))
    # non-zero attention projection so the mid attention is exercised
    for part in ("encoder", "decoder"):
        proj = jp[part]["mid_attn"]["proj"]
        proj["w"] = jax.random.normal(jax.random.PRNGKey(7), proj["w"].shape) * 0.1
    return jp, from_jax_tree(to_numpy_tree(jp))


@pytest.mark.parametrize("frames,chunks", [(9, 1), (13, 2)])
def test_encode_matches_jax(params, frames, chunks):
    jp, tp = params
    video = np.random.default_rng(0).uniform(-1, 1, (1, 3, frames, 16, 16)).astype(np.float32)
    want = jvae.encode_video(jp, jnp.asarray(video), VAE_E2E, chunks_per_step=chunks)
    got = tvae.encode_video(tp, t(video), VAE_E2E, chunks_per_step=chunks)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fps", [1, 2])
def test_decode_matches_jax(params, fps):
    jp, tp = params
    z = np.random.default_rng(1).standard_normal((1, 4, 5, 4, 4)).astype(np.float32)
    want = jvae.decode_video(jp, jnp.asarray(z), VAE_E2E, frames_per_step=fps)
    got = tvae.decode_video(tp, t(z), VAE_E2E, frames_per_step=fps)
    assert got.shape == tuple(want.shape) == (1, 3, 17, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segmented_decode_equals_monolithic(params):
    _, tp = params
    z = t(np.random.default_rng(2).standard_normal((1, 4, 7, 4, 4)).astype(np.float32))
    full = tvae.decode_video(tp, z, VAE_E2E, frames_per_step=1)
    segs = tvae.decode_video_segmented(tp, z, VAE_E2E, segment_latents=3, frames_per_step=1)
    assert len(segs) == 3
    assert torch.equal(torch.cat(segs, dim=2), full)
    u8 = tvae.decode_video_segmented(tp, z, VAE_E2E, segment_latents=3, frames_per_step=1,
                                     out_uint8=True)
    assert u8[0].dtype == torch.uint8
    np.testing.assert_array_equal(
        torch.cat(u8, dim=2).numpy(),
        torch.clamp(torch.round((full / 2 + 0.5) * 255), 0, 255).to(torch.uint8).numpy())


@pytest.mark.parametrize("seg", [3, 2, 7])
def test_streamed_decode_equals_decode_video(params, seg):
    """`decode_video_segments` (the decode's copy overlap; on the CPU the
    segments are handed over as they are) yields host tensors, in order,
    whose concatenation equals `decode_video`'s display frames bit for
    bit; `decode_video_segmented` is their list."""
    _, tp = params
    z = t(np.random.default_rng(2).standard_normal((1, 4, 7, 4, 4)).astype(np.float32))
    full = tvae.decode_video(tp, z, VAE_E2E, frames_per_step=1)
    host = list(tvae.decode_video_segments(tp, z, VAE_E2E, segment_latents=seg,
                                           frames_per_step=1, out_uint8=True))
    want = tvae.decode_video_segmented(tp, z, VAE_E2E, segment_latents=seg, frames_per_step=1,
                                       out_uint8=True)
    assert len(host) == len(want) == -(-7 // seg)
    for h, w in zip(host, want):
        assert h.device.type == "cpu" and h.dtype == torch.uint8
        assert torch.equal(h, w)
    np.testing.assert_array_equal(
        torch.cat(host, dim=2).numpy(),
        torch.clamp(torch.round((full / 2 + 0.5) * 255), 0, 255).to(torch.uint8).numpy())


def test_streamed_decode_hands_over_one_segment_behind(params, monkeypatch):
    """Segment k is handed over only once segment k+1's decode is enqueued
    (the host takes k while the card decodes k+1), and nothing is decoded
    before the first segment is asked for."""
    _, tp = params
    z = t(np.random.default_rng(5).standard_normal((1, 4, 7, 4, 4)).astype(np.float32))
    calls = []
    seg_fn = tvae._decode_segment
    monkeypatch.setattr(tvae, "_decode_segment",
                        lambda *a, **k: calls.append(1) or seg_fn(*a, **k))
    it = tvae.decode_video_segments(tp, z, VAE_E2E, segment_latents=3, frames_per_step=1)
    assert len(calls) == 0
    next(it)
    assert len(calls) == 2
    next(it)
    assert len(calls) == 3
    assert len(list(it)) == 1 and len(calls) == 3


# ---------------------------------------------------------------------------
# bf16: the port rounds where XLA rounds (excess precision off)
# ---------------------------------------------------------------------------

CONV_SHAPES = {"conv3d": ((1, 5, 6, 6, 8), (3, 3, 3, 8, 16)),   # x NDHWC, w DHWIO
               "conv2d": ((2, 6, 6, 8), (3, 3, 8, 16))}        # x NHWC, w HWIO


def _biased(tree, rng):
    """Every conv bias of a numpy VAE tree set to N(0, 0.1)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                    if k == "b" else _biased(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_biased(v, rng) for v in tree]
    return tree


def _bf16_inputs():
    rng = np.random.default_rng(0)
    return dict(
        z=rng.standard_normal((1, 4, 4, 4, 4)).astype(np.float32),
        silu_x=(rng.standard_normal(4096) * 4).astype(np.float32),
        convs={name: (rng.standard_normal(xs).astype(np.float32),
                      (rng.standard_normal(ws) * 0.2).astype(np.float32),
                      (rng.standard_normal(ws[-1]) * 0.5).astype(np.float32))
               for name, (xs, ws) in CONV_SHAPES.items()})


def jax_bf16_references(vae, z, silu_x, convs):
    """The JAX side of the bf16 comparisons (run by `run_jax_exact`, XLA's
    excess precision off): the pipeline's bf16 segmented uint8 decode, bf16
    `jax.nn.silu` and the bf16 `conv3d` / `conv2d` with bias, each as fp32
    numpy (bf16 widens exactly); SiLU also in fp32."""
    bf = jnp.bfloat16
    params = jax.tree.map(jnp.asarray, vae)
    video = np.concatenate([np.asarray(s) for s in jvae.decode_video_segmented(
        params, jnp.asarray(z).astype(bf), VAE_E2E, out_uint8=True)], axis=2)
    silu = {dt: np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(silu_x).astype(dt)), np.float32)
            for dt in ("bfloat16", "float32")}
    conv_fns = {"conv3d": jvae.conv3d,
                "conv2d": lambda x, w, b: jvae.conv2d(x, w, b, padding="VALID")}
    conv = {name: np.asarray(jax.jit(conv_fns[name])(jnp.asarray(x).astype(bf), jnp.asarray(w),
                                                      jnp.asarray(b)), np.float32)
            for name, (x, w, b) in convs.items()}
    return dict(video=video, silu=silu, conv=conv)


@pytest.fixture(scope="module")
def bf16_case(params):
    from tests.test_torch_pipeline import run_jax_exact

    jp, _ = params
    vae = _biased(to_numpy_tree(jp), np.random.default_rng(5))
    inputs = _bf16_inputs()
    return vae, inputs, run_jax_exact(jax_bf16_references, vae=vae, **inputs)


def test_bf16_segmented_decode_equals_jax_bit_for_bit(bf16_case):
    """The pipeline's decode (bf16 latents, uint8 frames) with non-zero conv
    biases and mid-attention projection: the port's SiLU, conv bias and mid
    attention round where XLA's do, so the frames are equal."""
    vae, inputs, want = bf16_case
    got = torch.cat(tvae.decode_video_segmented(
        from_jax_tree(vae), t(inputs["z"]).to(torch.bfloat16), VAE_E2E, out_uint8=True), dim=2)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want["video"].shape
    np.testing.assert_array_equal(got.numpy(), want["video"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_matches_jax(bf16_case, dtype):
    """bf16: op for op, bit for bit.  fp32: F.silu in one pass, within an
    fp32 rounding of XLA's op-for-op result."""
    from stableavatar_tpu_torch.models.vocal_projector import silu

    _, inputs, want = bf16_case
    got = silu(t(inputs["silu_x"]).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want["silu"][dtype])
    else:
        np.testing.assert_allclose(got, want["silu"][dtype], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_bf16_conv_with_bias_equals_jax_bit_for_bit(bf16_case, name):
    """Product rounded to bf16 first, then + b in bf16, as the JAX conv3d /
    conv2d add it."""
    _, inputs, want = bf16_case
    x, w, b = inputs["convs"][name]
    nd = x.ndim - 2
    xt = t(x).permute(0, nd + 1, *range(1, nd + 1)).to(torch.bfloat16)   # channels first
    p = {"w": t(w).permute(nd + 1, nd, *range(nd)), "b": t(b)}
    got = (tvae._conv3d if nd == 3 else tvae._conv2d)(p, xt)
    got = got.permute(0, *range(2, nd + 2), 1).float().numpy()
    np.testing.assert_array_equal(got, want["conv"][name])
