"""Weight bridge: the JAX package's parameter trees -> the port's.

Input is a JAX parameter tree whose leaves are numpy arrays (convert with
`jax.tree.map(np.asarray, params)` on the JAX side).  The tree structure is
kept key for key; these layouts change:

- linear weights "w" [d_in, d_out] -> [d_out, d_in] (`nn.Linear` /
  `F.linear` layout); int8 weights likewise: W8A8 {"w8": {"q"}} [d_in, d_out]
  -> [d_out, d_in] with "s" [d_out] unchanged, storage {"w": {"q", "s"}}
  "q" transposed the same way and "s" [1, d_out] -> [d_out, 1];
- conv1d kernels "w" [k, C_in/groups, C_out] -> [C_out, C_in/groups, k];
- conv2d kernels "w" [kh, kw, C_in, C_out] -> [C_out, C_in, kh, kw];
- conv3d kernels "w" [kt, kh, kw, C_in, C_out] -> [C_out, C_in, kt, kh, kw];
- the DiT's "blocks", stacked on a leading layer axis for lax.scan, become
  a list of per-layer trees.

Everything else (norm weights, modulation tables, embeddings, the VAE's
python-float norm scales) is copied as is.  Floating leaves keep their
dtype (bfloat16 included); `dtype=` casts them.
"""

from __future__ import annotations

import numpy as np
import torch

# layout change of a weight "w" by its number of axes
_W_AXES = {
    2: (1, 0),
    3: (2, 1, 0),
    4: (3, 2, 0, 1),
    5: (4, 3, 0, 1, 2),
}


def _tensor(arr, device, dtype):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def _convert(node, key, device, dtype):
    if isinstance(node, dict):
        if key in ("w", "w8") and "q" in node and "s" in node:
            q, s = np.asarray(node["q"]), np.asarray(node["s"])
            s = np.swapaxes(s, -1, -2) if s.ndim == q.ndim else s
            return {"q": _tensor(np.swapaxes(q, -1, -2), device, None),
                    "s": _tensor(s, device, None)}
        return {k: _convert(v, k, device, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, key, device, dtype) for v in node]
    if isinstance(node, (int, float)):
        return node
    arr = np.asarray(node)
    if key == "w" and arr.ndim in _W_AXES:
        arr = arr.transpose(_W_AXES[arr.ndim])
    return _tensor(arr, device, dtype)


def from_jax_tree(tree, device=None, dtype=None):
    """Convert a JAX parameter tree (numpy leaves) of the VAE, CLIP or
    wav2vec models -- or any tree without stacked layers."""
    return _convert(tree, None, device, dtype)


def t5_from_jax(params, device=None, dtype=None):
    """Convert a JAX umT5 tree: its "blocks" are already a list, so only the
    linear layouts change (token and position embeddings, norms as is)."""
    return from_jax_tree(params, device, dtype)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def dit_from_jax(params, device=None, dtype=None):
    """Convert a JAX DiT tree (plain, or prepared by the JAX
    `prepare_fast_params`): unstack "blocks" into a per-layer list, then
    apply the layout changes above."""
    params = dict(params)
    blocks = params.pop("blocks")
    n = int(np.asarray(blocks["modulation"]).shape[0])
    out = from_jax_tree(params, device, dtype)
    out["blocks"] = [from_jax_tree(_unstack(blocks, i), device, dtype) for i in range(n)]
    return out
