"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package runs on the CPU (as in every test here); the port runs its
plain kernel versions on CPU tensors.  Inputs are numpy arrays made from a
seed and handed to both sides.
"""

import os
from contextlib import contextmanager
from unittest import mock

import jax
import numpy as np
import torch


@contextmanager
def pallas_interpret():
    """Run every Pallas kernel of the JAX package in interpret mode."""
    from stableavatar_tpu.ops import flash_attention as fa

    orig = fa.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(fa.pl, "pallas_call", interp_call):
        yield


@contextmanager
def pallas_k5():
    """The JAX fused cross-attention through its Pallas kernel K5 in
    interpret mode (`STABLEAVATAR_DUAL_CROSS=pallas`, `pl.pallas_call` with
    interpret=True, the patch of tests/test_ops.py:203-213), instead of its
    CPU fallback `_dual_reference` (two XLA attentions, summed): the port's
    K5 follows the kernel (one softmax per context, P normalised and
    rounded to the value dtype, one P.V over both)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.dict(os.environ, {"STABLEAVATAR_DUAL_CROSS": "pallas"}), \
            mock.patch.object(pl, "pallas_call", interp_call):
        yield


def jit_init(init_fn, cfg, key):
    """A JAX package initialiser under one jit: the eager init of the VAE
    costs ~20 s of per-op compiles on the CPU.  (Python-float leaves, the
    VAE norm scales, come back as 0-d arrays, which the models accept.)"""
    return jax.jit(lambda k: init_fn(k, cfg))(key)


def to_numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(np.asarray(x), copy=True))
    return out if dtype is None else out.to(dtype)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def densify_dit(params):
    """The tests' `_densify` (tests/test_fastpath.py): random head and vocal
    k/v weights instead of the zero init, so every branch is exercised."""
    for name, key, scale in [
        (("head", "head"), 10, 0.05),
        (("blocks", "cross_attn", "k_vocal"), 11, 0.1),
        (("blocks", "cross_attn", "v_vocal"), 12, 0.1),
    ]:
        node = params
        for part in name:
            node = node[part]
        node["w"] = jax.random.normal(jax.random.PRNGKey(key), node["w"].shape) * scale
    return params


def _w8_key(q) -> tuple:
    """A W8A8 weight's fingerprint (its dims in either layout and two
    integer sums), the same for the JAX copy [d_in, d_out] and the port's."""
    q = np.asarray(q).astype(np.int64)
    return tuple(sorted(q.shape)), int(q.sum()), int((q * q).sum())


def _quant_rows(x) -> np.ndarray:
    """int8 activations of the W8A8 linears: per row amax * fp32(1/127),
    round half to even (both sides' arithmetic)."""
    sx = np.maximum(np.abs(x).max(-1, keepdims=True) * np.float32(1.0 / 127.0), np.float32(1e-10))
    return np.clip(np.round(x / sx.astype(np.float32)), -127, 127)


def int8_activation_flips(jax_fn, port_fn):
    """Run the JAX and the port forward (`jax_fn()`, `port_fn()`) recording
    the input of every W8A8 linear (`int8_linear` of both packages), pair
    the calls by weight fingerprint and input shape (in order), and count
    the int8 activations that differ.  Returns (outputs of both, [(weight
    shape, flipped, count, max |dx| of the inputs)] in the port's call
    order); raises if a port call has no JAX partner."""
    from stableavatar_tpu.utils import quantization as jq
    from stableavatar_tpu_torch.models import vocal_projector as tvp

    rec_j, rec_t = [], []
    orig_j, orig_t = jq.int8_linear, tvp.int8_linear

    def record_j(x, w8, b=None):
        jax.debug.callback(lambda xv, qv: rec_j.append((_w8_key(qv), np.asarray(xv, np.float32))),
                           x, w8["q"])
        return orig_j(x, w8, b)

    def record_t(x, w8, b=None):
        rec_t.append((_w8_key(w8["q"].numpy()), x.float().numpy().copy()))
        return orig_t(x, w8, b)

    with mock.patch.object(jq, "int8_linear", record_j):
        want = jax_fn()
    with mock.patch.object(tvp, "int8_linear", record_t):
        got = port_fn()
    pool = {}
    for key, x in rec_j:
        pool.setdefault((key, x.shape), []).append(x)
    flips = []
    for key, xt in rec_t:
        xj = pool.get((key, xt.shape), []).pop(0) if pool.get((key, xt.shape)) else None
        if xj is None:
            raise AssertionError(f"no JAX W8A8 call with weight {key[0]} and input {xt.shape}")
        flips.append((key[0], int((_quant_rows(xj) != _quant_rows(xt)).sum()), xt.size,
                      float(np.abs(xj - xt).max())))
    return (want, got), flips


# ---------------------------------------------------------------------------
# reference-layout state dicts of JAX trees, for the checkpoint converters
# (the JAX package exports only the DiT; these write the keys its
# `convert_t5`, `convert_clip_visual` and `convert_vae` read)
# ---------------------------------------------------------------------------


def randomize_tree(tree, seed: int):
    """A numpy copy of a JAX tree with every array leaf (ndim >= 1) drawn
    anew, so that ones / zeros initialisations do not hide a swapped key."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.ndim == 0 or not np.issubdtype(x.dtype, np.floating):
            return x
        return rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree.map(draw, tree)


def _sd_lin(sd, name, p):
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _sd_ln(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["w"])
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def t5_state_dict(params, cfg):
    """JAX umT5 tree -> `models_t5_umt5-xxl-enc-bf16.pth` keys."""
    sd = {"token_embedding.weight": np.asarray(params["token_embedding"])}
    for i, bp in enumerate(params["blocks"]):
        b = f"blocks.{i}"
        _sd_ln(sd, f"{b}.norm1", bp["norm1"])
        _sd_ln(sd, f"{b}.norm2", bp["norm2"])
        for n in ("q", "k", "v", "o"):
            _sd_lin(sd, f"{b}.attn.{n}", bp["attn"][n])
        _sd_lin(sd, f"{b}.ffn.gate.0", bp["ffn"]["gate"])
        _sd_lin(sd, f"{b}.ffn.fc1", bp["ffn"]["fc1"])
        _sd_lin(sd, f"{b}.ffn.fc2", bp["ffn"]["fc2"])
        if "pos_emb" in bp:
            sd[f"{b}.pos_embedding.embedding.weight"] = np.asarray(bp["pos_emb"])
    _sd_ln(sd, "norm", params["norm"])
    if "pos_emb" in params:
        sd["pos_embedding.embedding.weight"] = np.asarray(params["pos_emb"])
    return sd


def clip_state_dict(params, cfg, prefix="visual."):
    """JAX CLIP visual tree -> open-clip `.pth` keys (patch conv [O, 3, p, p])."""
    w = np.asarray(params["patch_embedding"]["w"])
    p = cfg.patch_size
    sd = {f"{prefix}patch_embedding.weight": np.ascontiguousarray(
              w.T.reshape(w.shape[1], 3, p, p)),
          f"{prefix}cls_embedding": np.asarray(params["cls_embedding"]),
          f"{prefix}pos_embedding": np.asarray(params["pos_embedding"])}
    _sd_ln(sd, f"{prefix}pre_norm", params["pre_norm"])
    for i, bp in enumerate(params["blocks"]):
        b = f"{prefix}transformer.{i}"
        _sd_ln(sd, f"{b}.norm1", bp["norm1"])
        _sd_ln(sd, f"{b}.norm2", bp["norm2"])
        _sd_lin(sd, f"{b}.attn.to_qkv", bp["attn"]["qkv"])
        _sd_lin(sd, f"{b}.attn.proj", bp["attn"]["proj"])
        _sd_lin(sd, f"{b}.mlp.0", bp["mlp"]["fc1"])
        _sd_lin(sd, f"{b}.mlp.2", bp["mlp"]["fc2"])
    return sd


def vae_state_dict(params, cfg):
    """JAX VAE tree -> `Wan2.1_VAE.pth` keys: conv kernels [O, I, k...], the
    norm gammas in the reference's broadcast shapes."""
    sd = {}

    def conv(name, p):
        w = np.asarray(p["w"])
        axes = (4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1)
        sd[f"{name}.weight"] = np.ascontiguousarray(w.transpose(axes))
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def norm(name, p, spatial):
        g = np.asarray(p["gamma"])
        sd[f"{name}.gamma"] = g.reshape(g.shape[0], *(1,) * spatial)

    def res(name, p):
        norm(f"{name}.residual.0", p["norm1"], 3)
        conv(f"{name}.residual.2", p["conv1"])
        norm(f"{name}.residual.3", p["norm2"], 3)
        conv(f"{name}.residual.6", p["conv2"])
        if "shortcut" in p:
            conv(f"{name}.shortcut", p["shortcut"])

    def attn(name, p):
        norm(f"{name}.norm", p["norm"], 2)
        conv(f"{name}.to_qkv", p["qkv"])
        conv(f"{name}.proj", p["proj"])

    def stack(prefix, ps, resample):
        for i, p in enumerate(ps):
            if "conv" in p:
                conv(f"{prefix}.{i}.resample.1", p["conv"])
                if "time_conv" in p:
                    conv(f"{prefix}.{i}.time_conv", p["time_conv"])
            else:
                res(f"{prefix}.{i}", p)

    for part, key in (("encoder", "down"), ("decoder", "up")):
        p = params[part]
        conv(f"{part}.conv1", p["conv1"])
        stack(f"{part}.{'downsamples' if key == 'down' else 'upsamples'}", p[key], True)
        res(f"{part}.middle.0", p["mid1"])
        attn(f"{part}.middle.1", p["mid_attn"])
        res(f"{part}.middle.2", p["mid2"])
        norm(f"{part}.head.0", p["head_norm"], 3)
        conv(f"{part}.head.2", p["head_conv"])
    conv("conv1", params["conv1"])
    conv("conv2", params["conv2"])
    return sd


def assert_trees_equal(got, want):
    """Port tree == bridged JAX tree: the same paths, and every leaf equal in
    value and dtype (numbers by value)."""
    from stableavatar_tpu_torch.utils.tree import tree_paths

    g, w = dict(tree_paths(got)), dict(tree_paths(want))
    assert sorted(g) == sorted(w), set(g) ^ set(w)
    for k, a in g.items():
        b = w[k]
        if not (torch.is_tensor(a) and torch.is_tensor(b)):  # the VAE norm scales
            assert float(a) == float(b), k
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape,
                                                               b.shape)
            assert torch.equal(a, b), k
