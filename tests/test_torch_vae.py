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
