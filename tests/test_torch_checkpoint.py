"""The port's checkpoint I/O (`utils/checkpoint.py`) against the JAX
package's: each converter's tree equals, bit for bit, `utils/weights.py`'s
bridge of the JAX converter's output on the same state dict; the fine-tuned
override merge skips the same keys; the exporters, the `.safetensors`
reader / writer and the port's own checkpoints round-trip exactly."""

import os

import jax
import numpy as np
import pytest
import torch

from stableavatar_tpu.config import CLIPConfig, DiTConfig, T5Config, tiny_debug_configs
from stableavatar_tpu.models.clip import init_clip_visual
from stableavatar_tpu.models.dit import init_dit
from stableavatar_tpu.models.t5 import init_t5
from stableavatar_tpu.models.vae import init_vae
from stableavatar_tpu.models.vocal_projector import init_vocal_projector
from stableavatar_tpu.utils import checkpoint as jck
from stableavatar_tpu_torch.utils import checkpoint as tck
from stableavatar_tpu_torch.utils.weights import dit_from_jax, from_jax_tree, t5_from_jax
from tests.test_pipeline import VAE_E2E
from tests.torch_parity import (assert_trees_equal, clip_state_dict, jit_init, randomize_tree,
                                t5_state_dict, to_numpy_tree, vae_state_dict)

# tests/test_export.py's DiT config, and the same with 14B's two-stage
# audio projection; the 16-channel base model's patch embedding is padded
DIT_1B = DiTConfig(dim=32, ffn_dim=64, num_heads=2, num_layers=2, text_len=16, text_dim=24,
                   freq_dim=32, audio_in_dim=16, audio_proj_dim=32, vocal_num_heads=2)
DIT_14B = DiTConfig(dim=32, ffn_dim=64, num_heads=2, num_layers=2, text_len=16, text_dim=24,
                    freq_dim=32, audio_in_dim=16, audio_proj_dim=32, audio_proj_hidden=24,
                    vocal_num_heads=2)
T5_TINY = T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4, num_layers=2,
                   text_len=16)
CLIP_TINY = CLIPConfig(image_size=28, patch_size=14, vision_dim=32, vision_heads=2,
                       vision_layers=2)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _dit_sd(cfg, seed=0):
    """The JAX exporter's state dict of a random JAX DiT, every leaf drawn."""
    params = randomize_tree(jit_init(init_dit, cfg, jax.random.PRNGKey(seed)), seed)
    return params, jck.export_dit_to_torch_state_dict(params, cfg)


@pytest.mark.parametrize("cfg", [DIT_1B, DIT_14B], ids=["1B", "14B"])
def test_convert_dit_matches_jax(cfg):
    _, sd = _dit_sd(cfg)
    want = dit_from_jax(to_numpy_tree(jck.convert_dit(sd, cfg)))
    assert_trees_equal(tck.convert_dit(_torch_sd(sd), cfg), want)
    # numpy state dicts convert the same
    assert_trees_equal(tck.convert_dit(sd, cfg), want)


def test_convert_dit_pads_the_base_patch_embedding():
    """A 16-channel patch embedding under the 36-channel model: zero-padded."""
    _, sd = _dit_sd(DIT_1B)
    sd["patch_embedding.weight"] = sd["patch_embedding.weight"][:, :16].copy()
    want = dit_from_jax(to_numpy_tree(jck.convert_dit(sd, DIT_1B)))
    got = tck.convert_dit(_torch_sd(sd), DIT_1B)
    assert_trees_equal(got, want)
    w = got["patch_embedding"]["w"].reshape(DIT_1B.dim, DIT_1B.in_dim, -1)
    assert not w[:, 16:].any() and w[:, :16].any()


@pytest.mark.parametrize("cfg", [DIT_1B, DIT_14B], ids=["1B", "14B"])
def test_convert_vocal_projector_matches_jax(cfg):
    params = randomize_tree(jax.jit(lambda k: init_vocal_projector(k, cfg))(
        jax.random.PRNGKey(1)), 1)
    sd = jck.export_vocal_projector(params, cfg, prefix="vp.")
    want = from_jax_tree(to_numpy_tree(jck.convert_vocal_projector(sd, cfg, prefix="vp.")))
    got = tck.convert_vocal_projector(_torch_sd(sd), cfg, prefix="vp.")
    assert_trees_equal(got, want)
    assert ("fc1" in got["proj"]) == (cfg.audio_proj_hidden is not None)


def test_convert_vae_matches_jax():
    params = randomize_tree(jit_init(init_vae, VAE_E2E, jax.random.PRNGKey(2)), 2)
    sd = vae_state_dict(params, VAE_E2E)
    want = from_jax_tree(to_numpy_tree(jck.convert_vae(sd, VAE_E2E)))
    assert_trees_equal(tck.convert_vae(_torch_sd(sd), VAE_E2E), want)


@pytest.mark.parametrize("shared_pos", [False, True])
def test_convert_t5_matches_jax(shared_pos):
    import dataclasses

    cfg = dataclasses.replace(T5_TINY, shared_pos=shared_pos)
    params = randomize_tree(jit_init(init_t5, cfg, jax.random.PRNGKey(3)), 3)
    sd = t5_state_dict(params, cfg)
    want = t5_from_jax(to_numpy_tree(jck.convert_t5(sd, cfg)))
    assert_trees_equal(tck.convert_t5(_torch_sd(sd), cfg), want)


def test_convert_clip_matches_jax():
    params = randomize_tree(jit_init(init_clip_visual, CLIP_TINY, jax.random.PRNGKey(4)), 4)
    sd = clip_state_dict(params, CLIP_TINY)
    want = from_jax_tree(to_numpy_tree(jck.convert_clip_visual(sd, CLIP_TINY)))
    assert_trees_equal(tck.convert_clip_visual(_torch_sd(sd), CLIP_TINY), want)


def hf_wav2vec2_state_dict(seed=0):
    """The tiny HF `Wav2Vec2Model` of tests/test_encoders.py:14 (its position
    conv weight-normed through a parametrization), random weights."""
    from transformers import Wav2Vec2Config as HFConfig, Wav2Vec2Model

    torch.manual_seed(seed)
    model = Wav2Vec2Model(HFConfig(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        conv_dim=(8,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_stable_layer_norm=False,
        feat_extract_norm="group", hidden_act="gelu", layer_norm_eps=1e-5)).eval()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("pos_conv", ["parametrization", "weight_g", "plain"])
def test_convert_wav2vec2_matches_jax(pos_conv):
    """The HF model's keys, with the position conv as a weight-norm
    parametrization (today's transformers), as legacy weight_g / weight_v,
    or as a plain weight."""
    cfg = tiny_debug_configs()[4]
    sd = hf_wav2vec2_state_dict()
    pc = "encoder.pos_conv_embed.conv"
    g = sd.pop(f"{pc}.parametrizations.weight.original0")
    v = sd.pop(f"{pc}.parametrizations.weight.original1")
    if pos_conv == "parametrization":
        sd[f"{pc}.parametrizations.weight.original0"] = g
        sd[f"{pc}.parametrizations.weight.original1"] = v
    elif pos_conv == "weight_g":
        sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"] = g, v
    else:
        sd[f"{pc}.weight"] = v
    want = from_jax_tree(to_numpy_tree(jck.convert_wav2vec2(
        {k: x.numpy() for k, x in sd.items()}, cfg)))
    assert_trees_equal(tck.convert_wav2vec2(sd, cfg), want)


def test_merge_pt_override_matches_jax(capsys):
    """A fine-tuned override over a base tree: every leaf of the override
    lands except the size-mismatched one, as the JAX merge does
    (tests/test_utils.py:241)."""
    base, _ = _dit_sd(DIT_1B, seed=5)
    _, sd = _dit_sd(DIT_1B, seed=6)
    sd["head.head.weight"] = np.zeros((3, 3), np.float32)
    want = dit_from_jax(to_numpy_tree(jck.merge_pt_override(base, sd, DIT_1B)))
    got = tck.merge_pt_override(dit_from_jax(to_numpy_tree(base)), _torch_sd(sd), DIT_1B)
    assert "skipped 1 size-mismatched" in capsys.readouterr().out
    assert_trees_equal(got, want)
    assert torch.equal(got["head"]["head"]["w"],
                       dit_from_jax(to_numpy_tree(base))["head"]["head"]["w"])
    assert torch.equal(got["blocks"][1]["ffn"]["fc1"]["w"],
                       torch.from_numpy(sd["blocks.1.ffn.0.weight"]))


@pytest.mark.parametrize("cfg", [DIT_1B, DIT_14B], ids=["1B", "14B"])
def test_export_matches_jax_and_round_trips(cfg):
    """The port's exporter writes the JAX exporter's state dict, and
    convert_dit inverts it bit for bit."""
    params, want = _dit_sd(cfg, seed=7)
    tree = dit_from_jax(to_numpy_tree(params))
    sd = tck.export_dit_to_torch_state_dict(tree, cfg)
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert_trees_equal(tck.convert_dit(sd, cfg), tree)


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_save_torch_dit_round_trips(tmp_path, suffix):
    params, _ = _dit_sd(DIT_14B, seed=8)
    tree = dit_from_jax(to_numpy_tree(params), dtype=torch.bfloat16)
    path = tck.save_torch_dit(str(tmp_path / f"transformer3d{suffix}"), tree, DIT_14B)
    back = tck.convert_dit(tck.load_torch_state_dict(path), DIT_14B)
    assert_trees_equal(tck.to_device(back, "cpu", torch.bfloat16), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64,
                                   torch.int32, torch.int8, torch.uint8, torch.bool])
def test_safetensors_against_the_package(tmp_path, dtype):
    """The port's reader and writer against the `safetensors` package: each
    reads what the other wrote, values and dtypes exact."""
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {name: (torch.randn(shape, generator=gen) * 50).to(dtype)
               for name, shape in (("a.weight", (3, 5)), ("b", (7,)), ("scalar", ()),
                                   ("empty", (0, 4)), ("c.d", (2, 3, 4)))}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    tck.save_safetensors(tensors, ours)
    save_file(tensors, theirs)
    for read in (load_file(ours), tck.load_safetensors(theirs), tck.load_safetensors(ours)):
        assert sorted(read) == sorted(tensors)
        for k, v in tensors.items():
            assert read[k].dtype == dtype and read[k].shape == v.shape and torch.equal(read[k], v)


def test_load_torch_state_dict_pt(tmp_path):
    """A `.pt` / `.pth` loads with its dtypes (bf16 kept), a "state_dict"
    wrapper unwrapped."""
    sd = {"w": torch.randn(4, 3).bfloat16(), "i": torch.arange(5)}
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pth")
    torch.save(sd, tmp_path / "plain.pt")
    for name in ("wrapped.pth", "plain.pt"):
        got = tck.load_torch_state_dict(str(tmp_path / name))
        assert got.keys() == sd.keys()
        assert all(got[k].dtype == sd[k].dtype and torch.equal(got[k], sd[k]) for k in sd)


def test_save_and_restore_checkpoint(tmp_path):
    """The port's own checkpoints: a tree saved and restored as it was, or
    into a template's devices and dtypes (shapes checked)."""
    tree = {"blocks": [{"w": torch.randn(3, 2), "n": torch.arange(4)}, {"w": torch.randn(3, 2),
                                                                       "n": torch.arange(4)}],
            "head": {"modulation": torch.randn(1, 2, 3).bfloat16()}, "scale": 2.5}
    path = str(tmp_path / "ckpt")
    tck.save_checkpoint(path, tree)
    assert os.listdir(path) == ["tree.pt"]
    back = tck.restore_checkpoint(path)
    assert_trees_equal(back, tree)
    template = {"blocks": [{"w": torch.zeros(3, 2, dtype=torch.bfloat16),
                            "n": torch.zeros(4, dtype=torch.int64)}] * 2,
                "head": {"modulation": torch.zeros(1, 2, 3, dtype=torch.float32)}, "scale": 0.0}
    into = tck.restore_checkpoint(path, template)
    assert into["blocks"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(into["blocks"][1]["w"], tree["blocks"][1]["w"].bfloat16())
    assert torch.equal(into["head"]["modulation"], tree["head"]["modulation"].float())
    assert into["scale"] == 2.5
    with pytest.raises(ValueError, match="does not fit"):
        tck.restore_checkpoint(path, {**template, "head": {"modulation": torch.zeros(2)}})
