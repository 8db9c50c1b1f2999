"""Faults planted under a run's timed path, to show that `correct` catches
them (`avatar_bench/tests`, and on the card `readings.py`).  Each is a
context manager that patches the port's module while it is open; none is
reachable from `run.py`."""

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


def unchanged():
    """Every sweep computes as usual and returns its state unchanged."""
    from stableavatar_tpu_torch.pipelines import long as long_mod

    def make(real):
        def sweep(models, latents_all, *a, **k):
            _, residual = real(models, latents_all, *a, **k)
            return latents_all, residual
        return sweep

    return _patched(long_mod, "_sweep_step", make)


def half_batch():
    """The DiT's CFG batch loses its last row, and every row takes the mean
    over the rows left."""
    from stableavatar_tpu_torch.pipelines import long as long_mod

    def make(real):
        def forward(*a, **k):
            out = real(*a, **k)
            out[:] = out[:-1].mean(0)
            return out
        return forward

    return _patched(long_mod, "dit_forward", make)


def altered():
    """An answer altered where it is produced: the DiT's output for the
    first latent frame of every window is replaced by zeros."""
    from stableavatar_tpu_torch.pipelines import long as long_mod

    def make(real):
        def forward(*a, **k):
            out = real(*a, **k)
            out[:, :, 0] = 0.0
            return out
        return forward

    return _patched(long_mod, "dit_forward", make)


GEN = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
