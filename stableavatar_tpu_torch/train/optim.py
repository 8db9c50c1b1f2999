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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from stableavatar_tpu_torch.utils.tree import tree_map

class GradientTransformation(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (updates, state, params) -> (updates, state)


def _counter(params: Sequence[torch.Tensor]) -> torch.Tensor:
    device = params[0].device if len(params) else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves of sum(x^2), each
    leaf's sum in its own dtype."""
    total = 0
    for x in leaves:
        total = total + x.float().square().sum().to(x.dtype)
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
        return {"inner": inner.init(pick(params))}

    def update(updates, state, params=None):
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
