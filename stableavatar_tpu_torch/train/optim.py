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
(`parallel/sharding.py`); every transform but the global norm works
element by element, and `global_norm` sums the squares of the slices over
the fsdp group inside `sharded_leaves`.  A transform that reduces over a
parameter's rows or columns (8-bit Adam's per-row scales, CAME's factored
moments) runs inside `whole_leaves`, which gives it the whole leaves.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from stableavatar_tpu_torch.parallel.mesh import all_gather_dim0
from stableavatar_tpu_torch.utils.tree import tree_map

# (specs, group) of the leaf lists in flight: per leaf its `Shard` where it
# is this rank's slice of a parameter split over 'fsdp' (else None), and
# that axis's group
_SHARDED: contextvars.ContextVar = contextvars.ContextVar("stableavatar_torch_sharded_leaves",
                                                          default=None)


@contextlib.contextmanager
def sharded_leaves(flags: Sequence, group: Optional[dist.ProcessGroup]):
    """Inside, `global_norm` of a leaf list takes the leaves flagged as
    slices of a parameter split over `group` (the fsdp group): a flag is
    the leaf's `parallel/sharding.py:Shard` (`parallel/sharding.py:leaf_specs`),
    None for a replicated leaf."""
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


# the key of `whole_leaves`'s state: full tensors, the same on every rank,
# which checkpoints neither gather nor split (`train/loop.py:map_leaf_lists`)
REPLICATED = "replicated"


def _whole(x: torch.Tensor, spec, group) -> torch.Tensor:
    """The full tensor of this rank's slice `x` of the leaf split as `spec`."""
    if x.device.type == "meta":
        return torch.empty(spec.shape, dtype=x.dtype, device="meta")
    full = all_gather_dim0(x, group)
    return full if spec.axis == 0 else full.movedim(0, spec.axis).contiguous()


def _part(x: torch.Tensor, spec, group) -> torch.Tensor:
    """This rank's slice of the full tensor `x`, laid out as its Shard, in
    memory of its own (the full tensor can be freed)."""
    n = 1 if x.device.type == "meta" else dist.get_world_size(group)
    r = 0 if x.device.type == "meta" else dist.get_rank(group)
    return x.movedim(spec.axis, 0).chunk(n, dim=0)[r].clone(
        memory_format=torch.contiguous_format)


def _leaf_state(state, n: int, i: int):
    """Leaf i's view of an inner state over n leaves: its entry of every
    per-leaf list (a list n long), the rest (the step count) as it is."""
    if isinstance(state, dict):
        return {k: _leaf_state(v, n, i) for k, v in state.items()}
    if isinstance(state, list) and len(state) == n:
        return [state[i]]
    return state


def _join_states(template, parts, n: int):
    """The inner state over n leaves from the per-leaf states `parts`
    (each from `_leaf_state` through one update): the per-leaf lists
    joined, the rest (the step count, the same in every part) from the
    last part."""
    if isinstance(template, dict):
        return {k: _join_states(v, [p[k] for p in parts], n) for k, v in template.items()}
    if isinstance(template, list) and len(template) == n:
        return [p[0] for p in parts]
    return parts[-1]


def whole_leaves(inner: GradientTransformation,
                 with_params: bool = False) -> GradientTransformation:
    """`inner` on whole leaves under fsdp.  Inside `sharded_leaves` `inner`
    updates one leaf at a time: a leaf that is a slice (its flag a `Shard`)
    is all-gathered over the fsdp group -- its update, and its parameter
    when `with_params` -- updated whole, and each rank keeps its slice of
    the result; outside, `inner` runs as it is.  For transforms that reduce
    over a parameter's rows, columns or blocks, which the fsdp split would
    cut: 8-bit Adam (one scale per row), CAME (row and column moments);
    both update each leaf on its own, so a leaf at a time gives the same
    numbers.

    The state, `{"replicated": inner's state}`, holds full tensors, the same
    on every rank.  Memory per rank: the state whole instead of a 1/fsdp
    slice (8-bit Adam: bf16 mu + int8 nu, 3 bytes a parameter, plus one fp32
    scale a row; CAME: an fp32 first moment, 4 bytes a parameter, plus its
    factored rows and columns), and during the update the gathered
    gradient, parameter and fp32 update of the one leaf in flight
    (`cli/train.py:train_bytes` counts both)."""

    def init(params):
        sharded = _SHARDED.get()
        if sharded is not None:
            specs, _ = sharded
            # the full shapes as zero-stride views: no memory of their own
            params = [p if not s else p.new_empty(()).expand(s.shape)
                      for p, s in zip(params, specs)]
        token = _SHARDED.set(None)
        try:
            return {REPLICATED: inner.init(params)}
        finally:
            _SHARDED.reset(token)

    def update(updates, state, params=None):
        sharded = _SHARDED.get()
        if sharded is None:
            out, new = inner.update(updates, state[REPLICATED], params)
            return out, {REPLICATED: new}
        specs, group = sharded
        n, outs, parts = len(updates), [], []
        if n == 0:
            return [], state
        token = _SHARDED.set(None)
        try:
            for i, (g, spec) in enumerate(zip(updates, specs)):
                p = params[i] if with_params and params is not None else None
                if spec:
                    g = _whole(g, spec, group)
                    p = None if p is None else _whole(p, spec, group)
                out, part = inner.update([g], _leaf_state(state[REPLICATED], n, i),
                                         None if p is None else [p])
                outs.append(_part(out[0], spec, group) if spec else out[0])
                parts.append(part)
        finally:
            _SHARDED.reset(token)
        return outs, {REPLICATED: _join_states(state[REPLICATED], parts, n)}

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
