"""Training losses and timestep sampling for flow-matching avatar training
(port of `stableavatar_tpu/train/losses.py`).

The random draws take a `torch.Generator` where the JAX package takes a
key; the two give different numbers from one seed, so the parity tests hand
both sides the same draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def sample_timestep_indices(generator: Optional[torch.Generator], batch_size: int,
                            num_train_timesteps: int = 1000, dp_rank: Optional[int] = None,
                            dp_size: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Uniform discrete timestep indices [B] int64; with (dp_rank, dp_size)
    each data-parallel group covers its own index interval (the reference's
    `DiscreteSampling` uniform mode)."""
    lo, hi = 0, num_train_timesteps
    if dp_rank is not None and dp_size:
        interval = num_train_timesteps // dp_size
        lo, hi = dp_rank * interval, dp_rank * interval + interval
    return torch.randint(lo, hi, (batch_size,), generator=generator, device=device)


def logit_normal_timestep_indices(generator, batch_size: int, num_train_timesteps: int = 1000,
                                  logit_mean: float = 0.0, logit_std: float = 1.0,
                                  device="cuda") -> torch.Tensor:
    """`compute_density_for_timestep_sampling(weighting_scheme='logit_normal')`."""
    u = torch.randn((batch_size,), generator=generator, device=device) * logit_std + logit_mean
    return (torch.sigmoid(u) * num_train_timesteps).to(torch.int32)


def density_timestep_indices(generator, batch_size: int, scheme: Optional[str],
                             num_train_timesteps: int = 1000, logit_mean: float = 0.0,
                             logit_std: float = 1.0, mode_scale: float = 1.29,
                             device="cuda") -> torch.Tensor:
    """diffusers `compute_density_for_timestep_sampling`, the reference's
    `uniform_sampling=False` branch."""
    if scheme == "logit_normal":
        return logit_normal_timestep_indices(generator, batch_size, num_train_timesteps,
                                             logit_mean, logit_std, device)
    u = torch.rand((batch_size,), generator=generator, device=device)
    return density_indices_from_uniform(u, scheme, num_train_timesteps, mode_scale)


def density_indices_from_uniform(u: torch.Tensor, scheme: Optional[str],
                                 num_train_timesteps: int = 1000,
                                 mode_scale: float = 1.29) -> torch.Tensor:
    """The deterministic part of `density_timestep_indices` for uniform
    draws u (schemes other than logit_normal)."""
    if scheme == "mode":
        u = 1 - u - mode_scale * (torch.cos(math.pi * u / 2) ** 2 - 1 + u)
    return (u * num_train_timesteps).to(torch.int32)


def loss_weighting(scheme: Optional[str], sigmas: torch.Tensor) -> torch.Tensor:
    """diffusers `compute_loss_weighting_for_sd3`."""
    if scheme == "sigma_sqrt":
        return (sigmas ** -2.0).float()
    if scheme == "cosmap":
        bot = 1 - 2 * sigmas + 2 * sigmas ** 2
        return 2 / (math.pi * bot)
    return torch.ones_like(sigmas)


def masked_flow_loss(noise_pred: torch.Tensor, target: torch.Tensor, face_masks: torch.Tensor,
                     lip_masks: torch.Tensor, mask_flag: torch.Tensor,
                     weighting: Optional[torch.Tensor] = None,
                     motion_sub_ratio: float = 0.0) -> torch.Tensor:
    """`custom_mse_loss` + the optional motion-sub loss.  mask_flag, a
    uniform draw in [0, 1), picks the weighting: [0.4, 0.5) face mask,
    >= 0.5 lip mask, else 1 + face + lip."""
    noise_pred = noise_pred.float()
    target = target.float()
    mse = (noise_pred - target).square()
    mask_flag = torch.as_tensor(mask_flag, device=mse.device)
    mask_w = torch.where((mask_flag >= 0.4) & (mask_flag < 0.5), face_masks,
                         torch.where(mask_flag >= 0.5, lip_masks, 1.0 + face_masks + lip_masks))
    mse = mse * mask_w
    if weighting is not None:
        mse = mse * weighting
    loss = mse.mean()
    if motion_sub_ratio > 0.0 and noise_pred.shape[1] > 2:
        # as in the reference, the diff runs over axis 1 -- the CHANNEL axis
        # of [B, C, F, H, W] -- despite the "motion" name
        gt_sub = noise_pred[:, 1:] - noise_pred[:, :-1]
        pre_sub = target[:, 1:] - target[:, :-1]
        sub_loss = (gt_sub - pre_sub).square().mean()
        loss = loss * (1 - motion_sub_ratio) + sub_loss * motion_sub_ratio
    return loss


def linear_decay(initial: float, final: float, total_steps: int, step) -> torch.Tensor:
    """Grad-norm bound decay (fp32, as the JAX package computes it)."""
    step = torch.as_tensor(step)
    frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0).float()
    return initial + (final - initial) * frac


def anomaly_aware_max_norm(grad_norm, max_grad_norm: float, initial_ratio: float,
                           decay_steps: int, step) -> torch.Tensor:
    """Anomaly-aware clipping bound: decays from max * ratio to max; if the
    observed norm exceeds 5x the bound after the decay window, the bound
    shrinks by up to 10x."""
    step = torch.as_tensor(step)
    grad_norm = torch.as_tensor(grad_norm, device=step.device)
    bound = linear_decay(max_grad_norm * initial_ratio, max_grad_norm, decay_steps, step)
    ratio = grad_norm / bound
    shrunk = bound / torch.clamp(ratio, max=10.0)
    anomalous = (ratio > 5.0) & (step > decay_steps)
    return torch.where(anomalous, shrunk, bound)
