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
