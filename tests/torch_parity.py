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
