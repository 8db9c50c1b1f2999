"""FlowMatch Euler schedule (port of `stableavatar_tpu/schedulers/flow_match.py`).

The sigma ladder is numpy, copied from the JAX package; it reproduces the
diffusers `FlowMatchEulerDiscreteScheduler.set_timesteps` construction,
including the second shift of the already-shifted training sigma_min.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


def _shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def _time_shift_exponential(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerSchedule:
    """`sigmas` has num_steps + 1 fp32 entries (terminal 0 appended);
    `timesteps` = sigmas[:-1] * num_train_timesteps."""

    sigmas: np.ndarray
    timesteps: np.ndarray
    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def flow_match_timesteps(
    num_inference_steps: int,
    shift: float = 5.0,
    num_train_timesteps: int = 1000,
    use_dynamic_shifting: bool = False,
    mu: Optional[float] = None,
    sigmas: Optional[Sequence[float]] = None,
) -> FlowMatchEulerSchedule:
    train_sigmas = np.linspace(1, num_train_timesteps, num_train_timesteps,
                               dtype=np.float32)[::-1] / num_train_timesteps
    if not use_dynamic_shifting:
        train_sigmas = _shift_sigmas(train_sigmas, shift)
    sigma_min = float(train_sigmas[-1])
    sigma_max = float(train_sigmas[0])

    if sigmas is None:
        ts = np.linspace(sigma_max * num_train_timesteps, sigma_min * num_train_timesteps,
                         num_inference_steps, dtype=np.float32)
        sig = ts / num_train_timesteps
    else:
        sig = np.asarray(sigmas, dtype=np.float32)

    if use_dynamic_shifting:
        if mu is None:
            raise ValueError("mu is required when use_dynamic_shifting=True")
        sig = _time_shift_exponential(mu, 1.0, sig)
    else:
        sig = _shift_sigmas(sig, shift)

    timesteps = sig * num_train_timesteps
    sig = np.concatenate([sig, [0.0]]).astype(np.float32)
    return FlowMatchEulerSchedule(sigmas=sig, timesteps=timesteps.astype(np.float32),
                                  num_train_timesteps=num_train_timesteps)
