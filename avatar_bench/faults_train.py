"""Faults planted under a train cell's timed path, to show that `correct`
catches them: `readings.py`'s "fault:<name>" for a cell of the `train`
kind.  Each fault is a context manager that patches the port's modules
while it is open; none is reachable from `run.py`.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _optimizer(make_update):
    """Every step's optimizer chain with its update replaced by
    make_update(real_update)."""
    from stableavatar_tpu_torch.train import loop as loop_mod
    from stableavatar_tpu_torch.train import optim

    def make(real):
        def build(*a, **k):
            tx = real(*a, **k)
            return optim.GradientTransformation(tx.init, make_update(tx.update))
        return build

    return _patched(loop_mod, "make_optimizer", make)


def unchanged():
    """Every step computes its loss and gradients and returns the parameters
    and the optimizer state unchanged."""
    import torch

    def make_update(real):
        def update(grads, state, params=None):
            return [torch.zeros_like(g) for g in grads], state
        return update

    return _optimizer(make_update)


def stale_gradient():
    """The update uses the previous step's gradient (zeros at the first
    step: a buffer that starts empty)."""
    import torch

    def make_update(real):
        held = {}

        def update(grads, state, params=None):
            prev = held.get("g") or [torch.zeros_like(g) for g in grads]
            held["g"] = [g.clone() for g in grads]
            return real(prev, state, params)
        return update

    return _optimizer(make_update)


def zero_block_gradient():
    """The gradient of the last DiT block's leaves is zeroed before the
    update."""
    import torch

    from stableavatar_tpu_torch.train import loop as loop_mod
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    def make(real):
        def step(params, *a, **k):
            last = {id(p) for p in tree_leaves(params["blocks"][-1])}
            grad = torch.autograd.grad

            def zeroed(outputs, inputs, *ga, **gk):
                return tuple(torch.zeros_like(g) if id(p) in last else g
                             for g, p in zip(grad(outputs, inputs, *ga, **gk), inputs))
            torch.autograd.grad = zeroed
            try:
                return real(params, *a, **k)
            finally:
                torch.autograd.grad = grad
        return step

    return _patched(loop_mod, "train_step", make)


def no_face_lip():
    """The flow loss without its face and lip weighting (every element
    weighted 1)."""
    import torch

    from stableavatar_tpu_torch.train import trainer

    def make(real):
        def loss(pred, target, face, lip, flag, **k):
            return real(pred, target, torch.zeros_like(face), torch.zeros_like(lip),
                        torch.zeros_like(torch.as_tensor(flag)), **k)
        return loss

    return _patched(trainer, "masked_flow_loss", make)


def half_batch():
    """Half of the step's tokens left out of the loss: the mean taken over
    the first half of the latent frames (the batch holds one clip)."""
    from stableavatar_tpu_torch.train import trainer

    def make(real):
        def loss(pred, target, face, lip, flag, **k):
            h = pred.shape[2] // 2
            return real(pred[:, :, :h], target[:, :, :h], face[:, :, :h], lip[:, :, :h], flag,
                        **k)
        return loss

    return _patched(trainer, "masked_flow_loss", make)


def altered():
    """An answer altered where it is produced: the DiT's velocity for the
    first latent frame of the clip replaced by zeros."""
    import torch

    from stableavatar_tpu_torch.train import trainer

    def make(real):
        def forward(*a, **k):
            out = real(*a, **k)
            return torch.cat([torch.zeros_like(out[:, :, :1]), out[:, :, 1:]], 2)
        return forward

    return _patched(trainer, "dit_forward", make)


def posterior_mean():
    """An encode altered where it is produced: the VAE posterior's mean in
    place of a sample (the noise dropped) for the clip and the masked
    clip."""
    import torch

    from stableavatar_tpu_torch.train import loop as loop_mod

    def make(real):
        def encode(params, video, cfg, noise=None, generator=None, **k):
            out = real(params, video, cfg, noise=noise, generator=generator, **k)
            zero = torch.zeros_like(out if noise is None else noise)
            return real(params, video, cfg, noise=zero, **k)
        return encode

    return _patched(loop_mod, "encode_video_sample", make)


TRAIN = {"unchanged": unchanged, "posterior_mean": posterior_mean, "stale_gradient": stale_gradient,
         "zero_block_gradient": zero_block_gradient, "no_face_lip": no_face_lip,
         "half_batch": half_batch, "altered": altered}

