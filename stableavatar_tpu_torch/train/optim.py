"""The optax gradient transformations the training chain is built from, as
init/update pairs over flat lists of tensors (one entry per parameter leaf,
`utils/tree.py:tree_leaves` order).

Each reproduces optax's arithmetic and dtypes: `update` takes the incoming
updates, the state and the parameters and returns new updates and a new
state; the state holds only tensors, lists and dicts, so `torch.save`
writes it.  Like optax, a transform's moments take the dtype of the updates
it receives (fp32 once the anomaly clip has scaled bf16 gradients by an
fp32 factor).  Unlike optax, `scale_by_adam` writes its moments into the
state's tensors in place, leaf by leaf, where the dtype allows: at 1.7 B
parameters each fp32 moment list is 7 GB, and a functional update would
hold the old and new moments and both bias-corrected copies at once.

Under fsdp the lists hold this rank's slices of the split parameters
(`parallel/sharding.py`), and so does every transform's state, as the JAX
package's is under GSPMD.  Most transforms work element by element.
Those that reduce over a parameter's axes learn each leaf's split from
`leaf_splits` and reduce through its `Split`: `global_norm` sums the
squares of the slices over the fsdp group, 8-bit Adam takes a row's absmax
over the group where the split cuts the row, CAME its row and column means.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from stableavatar_tpu_torch.parallel.sharding import Shard
from stableavatar_tpu_torch.utils.tree import tree_map

# (specs, group) of the leaf lists in flight: per leaf its `Shard` where it
# is this rank's slice of a parameter split over 'fsdp' (else None), and
# that axis's group
_SHARDED: contextvars.ContextVar = contextvars.ContextVar("stableavatar_torch_sharded_leaves",
                                                          default=None)


@contextlib.contextmanager
def sharded_leaves(flags: Sequence, group: Optional[dist.ProcessGroup]):
    """Inside, `global_norm` and `leaf_splits` of a leaf list take the
    leaves flagged as slices of a parameter split over `group` (the fsdp
    group): a flag is the leaf's `parallel/sharding.py:Shard`
    (`parallel/sharding.py:leaf_specs`), None for a replicated leaf."""
    token = _SHARDED.set((tuple(flags), group) if group is not None and any(flags) else None)
    try:
        yield
    finally:
        _SHARDED.reset(token)


class GradientTransformation(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (updates, state, params) -> (updates, state)


def _counter(params: Sequence[torch.Tensor]) -> torch.Tensor:
    device = params[0].device if len(params) else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of sum(x^2), each
    leaf's sum in its own dtype.  Inside `sharded_leaves` the sums of the
    flagged leaves (slices) are summed over the fsdp group first, so every
    rank gets the norm of the whole gradient, each replicated leaf counted
    once."""
    sums = [x.float().square().sum() for x in leaves]
    sharded = _SHARDED.get()
    if sharded is not None and sums and sums[0].device.type != "meta":
        flags, group = sharded
        if len(flags) != len(sums):
            raise ValueError(f"{len(sums)} leaves, {len(flags)} sharding flags")
        idx = [i for i, f in enumerate(flags) if f]
        part = torch.stack([sums[i] for i in idx])
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        for j, i in enumerate(idx):
            sums[i] = part[j]
    total = 0
    for x, s in zip(leaves, sums):
        total = total + s.to(x.dtype)
    return torch.sqrt(torch.as_tensor(total))


class Split(NamedTuple):
    """How this rank holds a leaf, or a statistic of one, under fsdp: the
    full tensor has `ndim` axes and is split on `axis` over `group` (None:
    whole here).  A slice is kept as its `Shard` keeps it, the split axis
    first (`local`); `view` lays it out in the full tensor's axis order,
    the split axis shortened.  The reductions take a view and reduce over
    the fsdp group where they run over the split axis, so every rank gets
    the full tensor's statistic; outside a split they are torch's own."""

    axis: Optional[int]
    ndim: int
    group: Optional[dist.ProcessGroup] = None

    def view(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.axis is None else x.movedim(0, self.axis)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of `view`, contiguous (as a `Shard` keeps it)."""
        return x if self.axis is None else x.movedim(self.axis, 0).contiguous()

    def reduced(self, dim: int, keepdim: bool = False) -> "Split":
        """The split of a statistic reduced over `dim`: whole on every rank
        where `dim` is the split axis, else split on the same axis."""
        dim %= self.ndim
        axis = self.axis
        if axis == dim:
            axis = None
        elif axis is not None and not keepdim and axis > dim:
            axis -= 1
        return Split(axis, self.ndim - (not keepdim), self.group)

    def _cuts(self, x: torch.Tensor, dim: Optional[int]) -> bool:
        return (self.axis is not None and x.device.type != "meta"
                and (dim is None or dim % self.ndim == self.axis))

    def mean(self, x, dim: Optional[int] = None, keepdim: bool = False) -> torch.Tensor:
        """The mean over `dim` (None: over every axis) of the full tensor."""
        if not self._cuts(x, dim):
            return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
        s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=self.group)
        n = x.numel() if dim is None else x.shape[dim]
        return s / (dist.get_world_size(self.group) * n)

    def amax(self, x, dim: int, keepdim: bool = False) -> torch.Tensor:
        m = x.amax(dim=dim, keepdim=keepdim)
        if self._cuts(x, dim):
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return m


def leaf_splits(leaves: Sequence[torch.Tensor]) -> list:
    """The `Split` of each leaf of a list in flight: inside `sharded_leaves`
    the axis of its parameter's `Shard` over the fsdp group, else whole."""
    sharded = _SHARDED.get()
    if sharded is None:
        return [Split(None, x.dim()) for x in leaves]
    flags, group = sharded
    if len(flags) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(flags)} sharding flags")
    return [Split(f.axis, len(f.shape), group) if f else Split(None, x.dim())
            for x, f in zip(leaves, flags)]


# the per-leaf statistics of 8-bit Adam and CAME, by their key in a leaf's
# state: the parameter's axis each is reduced over, and whether it is kept
# (as length 1)
STATISTICS = {"scale": (-1, True), "row": (-1, False), "res_row": (-1, False),
              "col": (-2, False), "res_col": (-2, False)}


def field_spec(key: str, x: torch.Tensor, leaf_shape, spec: Optional[Shard]) -> Optional[Shard]:
    """The `Shard` of the tensor `x` that a leaf's state keeps under `key`,
    where its parameter is split as `spec` (None: replicated): the
    parameter's own for a tensor of the leaf's shape (a moment), the one of
    a statistic's `Split.reduced`, None for a tensor that every rank holds
    the same (a statistic over the split axis, a scalar)."""
    if spec is None or x.dim() == 0:
        return None
    ndim = len(spec.shape)
    if key in STATISTICS and x.dim() == ndim - (not STATISTICS[key][1]):
        dim, keepdim = STATISTICS[key]
        axis = Split(spec.axis, ndim).reduced(dim, keepdim).axis
        if axis is None:
            return None
        shape = list(spec.shape)
        if keepdim:
            shape[dim] = 1
        else:
            del shape[dim]
        return Shard(x, axis, tuple(shape))
    if tuple(x.shape) == tuple(leaf_shape):
        return spec
    raise ValueError(f"no fsdp layout for the state field {key!r} of shape {tuple(x.shape)} "
                     f"of a leaf {tuple(leaf_shape)}")


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    return GradientTransformation(init, update)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay ** count in fp32 (as optax; bf16 would round it to 1); the
    moment is divided by it in the moment's dtype."""
    return 1 - torch.tensor(decay, dtype=torch.float32, device=count.device) ** count


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        return {"count": _counter(params), "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None):
        count = state["count"] + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        mu, nu, out = list(state["mu"]), list(state["nu"]), []
        for i, g in enumerate(updates):
            m = (1 - b1) * g + b1 * mu[i]
            v = (1 - b2) * g.square() + b2 * nu[i]
            out.append((m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype) + eps_root) + eps))
            mu[i] = _store(mu[i], m)
            nu[i] = _store(nu[i], v)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def _store(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The new moment, written into the old tensor when the dtypes agree."""
    if old.dtype != new.dtype:
        return new
    return old.copy_(new)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return [g + weight_decay * p for g, p in zip(updates, params)], state

    return GradientTransformation(lambda params: {}, update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return [step_size * g for g in updates], state

    return GradientTransformation(lambda params: {}, update)


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]) -> GradientTransformation:
    """Multiplies by schedule(count), cast to each update's dtype."""

    def init(params):
        return {"count": _counter(params)}

    def update(updates, state, params=None):
        step = schedule(state["count"])
        return [step.to(g.dtype) * g for g in updates], {"count": state["count"] + 1}

    return GradientTransformation(init, update)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: Adam, then decoupled weight decay, then -lr."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale(-learning_rate))


def masked(inner: GradientTransformation, mask: Sequence[bool]) -> GradientTransformation:
    """optax.masked: `inner` sees only the leaves where mask is True; the
    others pass their incoming updates through unchanged."""
    idx = [i for i, m in enumerate(mask) if m]

    def pick(xs):
        return None if xs is None else [xs[i] for i in idx]

    def init(params):
        flags, group = _SHARDED.get() or (None, None)
        with sharded_leaves(pick(flags) or (), group):
            return {"inner": inner.init(pick(params))}

    def update(updates, state, params=None):
        flags, group = _SHARDED.get() or (None, None)
        with sharded_leaves(pick(flags) or (), group):
            sub, inner_state = inner.update(pick(updates), state["inner"], pick(params))
        out = list(updates)
        for j, i in enumerate(idx):
            out[i] = sub[j]
        return out, {"inner": inner_state}

    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation, every_k: int) -> GradientTransformation:
    """optax.MultiSteps with use_grad_mean: a running (Welford) mean of k
    micro-gradients; the inner chain's update is emitted on every k-th call
    (zeros otherwise), and the accumulator then restarts from zero."""

    def init(params):
        return {"mini_step": _counter(params), "gradient_step": _counter(params),
                "inner": inner.init(params), "acc": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None):
        n = int(state["mini_step"])
        acc = [a + (g - a) / (n + 1) for g, a in zip(updates, state["acc"])]
        emit = n == every_k - 1
        if emit:
            final, new_inner = inner.update(acc, state["inner"], params)
        else:
            # optax runs the inner update on every call and keeps it only on
            # emit; its dtypes still decide the accumulator's: trace it on
            # meta tensors (the inner state may be updated in place)
            final, _ = inner.update(*(tree_map(_meta, x) for x in (acc, state["inner"], params)))
            new_inner = state["inner"]
        new_state = {
            "mini_step": (state["mini_step"] + 1) % every_k,
            "gradient_step": state["gradient_step"] + int(emit),
            "inner": new_inner,
            # (1 - emit) * acc, in the dtype of the emitted updates
            "acc": [torch.zeros_like(a, dtype=u.dtype) if emit else a.to(u.dtype)
                    for a, u in zip(acc, final)],
        }
        out = final if emit else [torch.zeros_like(a, dtype=u.dtype) for a, u in zip(acc, final)]
        return out, new_state

    return GradientTransformation(init, update)


def _meta(x):
    return x.to("meta") if torch.is_tensor(x) else x


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """optax.apply_updates, in place: p <- (p + u) rounded to p's dtype.
    (The JAX package makes new arrays; in place, the step holds one copy of
    the parameters.)"""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.copy_((p + u).to(p.dtype))
