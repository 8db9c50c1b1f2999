"""The port's LoRA adapters (`stableavatar_tpu_torch/utils/lora.py`) against
the JAX package's (`stableavatar_tpu/utils/lora.py`): the JAX factors,
bridged through numpy onto the port's per-block tree, merge into the same
weights (1e-6) and unmerge back; the port's own factors have the JAX
shapes and bounds; save / load round-trip."""

import jax
import numpy as np
import pytest
import torch

from stableavatar_tpu.config import DiTConfig
from stableavatar_tpu.models import dit as jdit
from stableavatar_tpu.utils import lora as jlora
from stableavatar_tpu_torch.utils import lora as tlora
from stableavatar_tpu_torch.utils.tree import tree_paths
from stableavatar_tpu_torch.utils.weights import dit_from_jax
from tests.torch_parity import to_numpy_tree

CFG = DiTConfig(dim=32, ffn_dim=48, num_heads=4, num_layers=2, audio_proj_dim=32,
                vocal_num_heads=4, text_len=8, clip_tokens=5, clip_dim=24, text_dim=16,
                audio_in_dim=16)
RANK, ALPHA = 4, 8.0


def _jax_pairs(lora):
    """{"blocks/<module>/.../w": {"down", "up"}} of a JAX lora tree."""
    flat = jax.tree_util.tree_leaves_with_path(
        lora, is_leaf=lambda x: isinstance(x, dict) and "down" in x)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat
            if leaf is not None}


def _port_lora(jax_pairs, params):
    """The JAX factors on the port's tree: block i's factors are row i of
    the stacked ones; targets the port does not have (the stacked norm
    scales) are left out."""

    def pick(path, leaf):
        parts = path.split("/")
        if not tlora._is_target(path, leaf, False):
            return None
        pair = jax_pairs["/".join(parts[:1] + parts[2:])]
        i = int(parts[1])
        return {"down": torch.from_numpy(np.array(pair["down"][i])),
                "up": torch.from_numpy(np.array(pair["up"][i]))}

    return tlora._map(pick, params)


@pytest.fixture(scope="module")
def trees():
    jparams = jdit.init_dit(jax.random.PRNGKey(0), CFG)
    jl = jlora.create_lora(jax.random.PRNGKey(1), jparams, rank=RANK, alpha=ALPHA)
    # random up factors (zero at init), so the merge moves every weight
    for i, (name, pair) in enumerate(sorted(_jax_pairs(jl).items())):
        pair["up"] = jax.random.normal(jax.random.PRNGKey(100 + i), pair["up"].shape) * 0.1
    return jparams, jl


@pytest.mark.parametrize("multiplier", [1.0, 0.5])
def test_merge_and_unmerge_match_jax(trees, multiplier):
    jparams, jl = trees
    tparams = dit_from_jax(to_numpy_tree(jparams))
    tl = _port_lora(_jax_pairs(jl), tparams)
    want = dit_from_jax(to_numpy_tree(jlora.merge_lora(jparams, jl, RANK, ALPHA, multiplier)))
    got = tlora.merge_lora(tparams, tl, RANK, ALPHA, multiplier)
    back = tlora.unmerge_lora(got, tl, RANK, ALPHA, multiplier)
    want_back = dit_from_jax(to_numpy_tree(jlora.unmerge_lora(
        jlora.merge_lora(jparams, jl, RANK, ALPHA, multiplier), jl, RANK, ALPHA, multiplier)))
    merged = 0
    for (path, g), (_, w), (_, p), (_, b), (_, wb) in zip(
            tree_paths(got), tree_paths(want), tree_paths(tparams), tree_paths(back),
            tree_paths(want_back), strict=True):
        if "norm" in path and path.startswith("blocks"):
            # the JAX rule also merges into the stacked norm scales [L, dim]
            # (ROADMAP queue 3); the port's are one-axis leaves, left alone
            assert torch.equal(g, p) and torch.equal(w, p) != path.endswith("/w"), path
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(b.numpy(), wb.numpy(), rtol=1e-6, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(b.numpy(), p.numpy(), rtol=1e-6, atol=1e-6, err_msg=path)
        merged += not torch.equal(g, p)
    # every block linear but the vocal k / v moved: q k v o, text and image
    # k v, the two FFN matrices, the cross q o
    assert merged == CFG.num_layers * 12


def test_create_lora_shapes_and_bounds_match_jax(trees):
    jparams, jl = trees
    jpairs = _jax_pairs(jl)
    tparams = dit_from_jax(to_numpy_tree(jparams))
    tl = tlora.create_lora(torch.Generator().manual_seed(1), tparams, rank=RANK, alpha=ALPHA)
    pairs = dict(tlora._pairs(tl))
    assert pairs and all("vocal" not in p and p.startswith("blocks") for p in pairs)
    for path, pair in pairs.items():
        parts = path.split("/")
        want = jpairs["/".join(parts[:1] + parts[2:])]
        assert tuple(pair["down"].shape) == tuple(want["down"].shape[1:]), path
        assert tuple(pair["up"].shape) == tuple(want["up"].shape[1:]), path
        lim = np.sqrt(6.0 / pair["down"].shape[0])
        assert 0 < float(pair["down"].abs().max()) <= lim and not pair["up"].any()
    jnames = {n for n in jpairs if "norm" not in n}
    assert {"/".join(p.split("/")[:1] + p.split("/")[2:]) for p in pairs} == jnames
    frozen, trained = tlora.lora_trainable_mask(tparams, tl)
    assert not any(frozen) and len(frozen) == len(tree_paths(tparams))
    assert all(trained) and len(trained) == 2 * len(pairs)
    # the zero up factor: merging a fresh adapter changes nothing
    for (_, a), (_, b) in zip(tree_paths(tlora.merge_lora(tparams, tl, RANK, ALPHA)),
                              tree_paths(tparams)):
        assert torch.equal(a, b)


def test_save_and_load_round_trip(trees, tmp_path):
    jparams, jl = trees
    tparams = dit_from_jax(to_numpy_tree(jparams))
    tl = _port_lora(_jax_pairs(jl), tparams)
    path = str(tmp_path / "adapter.npz")
    tlora.save_lora(path, tl, RANK, ALPHA)
    loaded, rank, alpha = tlora.load_lora(path, tparams)
    assert (rank, alpha) == (RANK, ALPHA)
    got, want = dict(tlora._pairs(loaded)), dict(tlora._pairs(tl))
    assert set(got) == set(want)
    for name in want:
        for k in ("down", "up"):
            assert torch.equal(got[name][k], want[name][k]), name
    with_vocal, _, _ = tlora.load_lora(path, tparams, include_vocal=True)
    assert set(dict(tlora._pairs(with_vocal))) == set(want)  # none saved for vocal
