"""The port's conditioning encoders (CLIP visual tower, wav2vec2) against
the JAX package's on the tiny configs of tests/test_pipeline.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stableavatar_tpu.models import clip as jclip
from stableavatar_tpu.models import wav2vec as jw2v
from stableavatar_tpu.config import CLIPConfig
from stableavatar_tpu_torch.models import clip as tclip
from stableavatar_tpu_torch.models import wav2vec as tw2v
from stableavatar_tpu_torch.utils.weights import from_jax_tree
from tests.test_pipeline import CLIP_E2E, W2V_E2E
from tests.torch_parity import jit_init, t, to_numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_31_block", [True, False])
def test_clip_visual_matches_jax(use_31_block):
    jp = jit_init(jclip.init_clip_visual, CLIP_E2E, jax.random.PRNGKey(2))
    img = np.random.default_rng(0).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    jin = jclip.preprocess_reference_image(jnp.asarray(img), CLIP_E2E)
    tin = tclip.preprocess_reference_image(t(img), CLIP_E2E)
    np.testing.assert_allclose(tin.numpy(), np.asarray(jin), **TOL)
    want = jclip.clip_visual_forward(jp, CLIP_E2E, jin, use_31_block=use_31_block)
    got = tclip.clip_visual_forward(from_jax_tree(to_numpy_tree(jp)), CLIP_E2E, tin,
                                    use_31_block=use_31_block)
    assert got.shape == tuple(want.shape) == (2, CLIP_E2E.num_tokens, CLIP_E2E.vision_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(512, 512), (300, 200)])
def test_clip_preprocess_resize_matches_jax(hw):
    """The cubic antialiased resize to 224 equals jax.image.resize."""
    cfg = CLIPConfig()
    img = np.random.default_rng(1).uniform(-1, 1, (1, 3, *hw)).astype(np.float32)
    want = jclip.preprocess_reference_image(jnp.asarray(img), cfg)
    got = tclip.preprocess_reference_image(t(img), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("samples", [4000, 8960])
def test_wav2vec_matches_jax(samples):
    jp = jit_init(jw2v.init_wav2vec2, W2V_E2E, jax.random.PRNGKey(3))
    wav = np.random.default_rng(2).standard_normal((1, samples)).astype(np.float32) * 0.1
    jn = jw2v.normalize_waveform(jnp.asarray(wav))
    tn = tw2v.normalize_waveform(t(wav))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    want = jw2v.wav2vec2_forward(jp, W2V_E2E, jn)
    got = tw2v.wav2vec2_forward(from_jax_tree(to_numpy_tree(jp)), W2V_E2E, tn)
    assert got.shape == tuple(want.shape)
    assert got.shape[1] == W2V_E2E.output_length(samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
