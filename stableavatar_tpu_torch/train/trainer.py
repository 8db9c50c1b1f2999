"""The training step: flow-matching fine-tuning of the talking DiT (port of
`stableavatar_tpu/train/trainer.py`).

`train_step` draws noise, a timestep index and the mask flag, runs the
DiT forward and the masked flow loss under autograd (the DiT in bf16, block
by block under `torch.utils.checkpoint` when `remat`), and applies the
optimizer chain of `make_optimizer` to the parameters in place.  The chain
is functional (`train/optim.py`): anomaly-aware clipping, then AdamW /
8-bit Adam / CAME, then the LR-schedule multiplier, then the trainable mask,
then gradient accumulation, as the JAX package chains optax.

Under a ('dp', 'fsdp', 'sp') mesh (`parallel/mesh.py:mesh_context`) the
step computes the one-process step on the global batch, as the JAX step
does under GSPMD: the draws are made at the global batch's size on every
rank and sliced after; each dp replica runs its rows
(`parallel/distributed.py:replica_rows`); fsdp gathers and sp exchanges
carry their gradients (`parallel/mesh.py`), every rank's loss is divided by
the ranks that compute it (fsdp x sp) and weighted by its rows' share of
the batch, and the gradients are summed over the ranks that hold the same
tensor (`sync_gradients`).  The optimizer then updates each rank's slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from stableavatar_tpu_torch.models.dit import dit_forward
from stableavatar_tpu_torch.parallel.distributed import replica_rows
from stableavatar_tpu_torch.parallel.mesh import (
    all_reduce_coalesced,
    axis_group,
    axis_size,
    current_mesh,
)
from stableavatar_tpu_torch.parallel.sharding import leaf_specs
from stableavatar_tpu_torch.train import optim
from stableavatar_tpu_torch.train.losses import (
    anomaly_aware_max_norm,
    density_timestep_indices,
    loss_weighting,
    masked_flow_loss,
    sample_timestep_indices,
)
from stableavatar_tpu_torch.utils.tree import tree_leaves, tree_paths


# the DiT's activation dtype in training (`noisy.astype(bfloat16)` in the
# JAX step); the parity tests run the step in fp32 by patching it on both sides
DIT_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field-for-field copy of the JAX package's `TrainConfig`."""

    learning_rate: float = 2e-5
    weight_decay: float = 3e-2
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-10
    max_grad_norm: float = 0.05
    initial_grad_norm_ratio: float = 5.0
    abnormal_norm_clip_start: int = 1000
    motion_sub_loss: bool = False
    motion_sub_loss_ratio: float = 0.25
    weighting_scheme: Optional[str] = None
    uniform_sampling: bool = True
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    num_train_timesteps: int = 1000
    shift: float = 5.0
    remat: bool = True
    video_sample_n_frames: int = 81
    use_8bit_adam: bool = False
    use_came: bool = False
    gradient_accumulation_steps: int = 1
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    lr_total_steps: Optional[int] = None


def train_sigmas(num_train_timesteps: int = 1000, shift: float = 5.0, device="cuda"):
    """The training sigma table (diffusers FlowMatchEuler constructor), fp32."""
    s = np.linspace(1, num_train_timesteps, num_train_timesteps,
                    dtype=np.float32)[::-1] / num_train_timesteps
    s = shift * s / (1 + (shift - 1) * s)
    return torch.as_tensor(s.copy(), device=device)


def trainable_mask(params, train_all: bool = False):
    """Flat list of trainable flags, one per leaf (`tree_leaves` order).
    The default reproduces the reference's unfreeze rule: leaves whose path
    names "vocal", "audio", "attn" or "blocks" -- the block stack and the
    vocal projector; patch / text / time embeddings and head stay frozen."""
    return [train_all or any(s in path for s in ("vocal", "audio", "attn", "blocks"))
            for path, _ in tree_paths(params)]


def lr_multiplier_schedule(cfg: TrainConfig):
    """Relative LR multiplier over the optimizer step count (fp32), the
    diffusers `get_scheduler` shapes the reference trains with."""
    kind = cfg.lr_scheduler
    warm = max(int(cfg.lr_warmup_steps), 0)
    total = int(cfg.lr_total_steps or 0)

    def sched(count):
        c = torch.as_tensor(count).float()
        wu = torch.clamp(c / max(warm, 1), max=1.0) if warm > 0 else torch.ones_like(c)
        if kind == "constant":
            return torch.ones_like(c)
        if kind == "constant_with_warmup":
            return wu
        if total <= 0:
            raise ValueError(f"lr_scheduler={kind!r} needs lr_total_steps")
        prog = torch.clamp((c - warm) / max(total - warm, 1), 0.0, 1.0)
        if kind == "linear":
            return wu * (1.0 - prog)
        if kind == "cosine":  # diffusers num_cycles=0.5: half cosine to 0
            return wu * 0.5 * (1.0 + torch.cos(math.pi * prog))
        if kind == "cosine_with_restarts":  # diffusers num_cycles=1
            frac = (prog * 1.0) % 1.0
            return wu * torch.where(prog >= 1.0, torch.zeros_like(c),
                                    0.5 * (1.0 + torch.cos(math.pi * frac)))
        if kind == "polynomial":  # diffusers lr_end=1e-7, power=1.0
            lr_end_rel = 1e-7 / max(cfg.learning_rate, 1e-30)
            return wu * ((1.0 - lr_end_rel) * (1.0 - prog) + lr_end_rel)
        raise ValueError(f"unknown lr_scheduler {kind!r}")

    return sched


def anomaly_clip_transform(max_grad_norm: float, initial_ratio: float,
                           decay_steps: int) -> optim.GradientTransformation:
    """Anomaly-aware global-norm clipping as a chain transform: under
    accumulation it fires on the accumulated gradients, at the sync step.
    Its optimizer-step counter is part of the state (checkpointed)."""

    def init(params):
        device = params[0].device if len(params) else "cpu"
        return {"count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(updates, state, params=None):
        gnorm = optim.global_norm(updates)
        max_norm = anomaly_aware_max_norm(gnorm, max_grad_norm, initial_ratio, decay_steps,
                                          state["count"])
        scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
        # JAX promotes bf16 updates times this fp32 scalar to fp32 (torch
        # would keep bf16 for a 0-d factor): the chain runs in fp32 from here
        return ([g.to(torch.promote_types(g.dtype, scale.dtype)) * scale for g in updates],
                {"count": state["count"] + 1})

    return optim.GradientTransformation(init, update)


def make_optimizer(cfg: TrainConfig, mask=None) -> optim.GradientTransformation:
    """The JAX package's optax chain; `mask` is a list of trainable flags
    (`trainable_mask`)."""
    if cfg.use_came:
        from stableavatar_tpu_torch.train.came import came

        tx = came(cfg.learning_rate, betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16))
    elif cfg.use_8bit_adam:
        from stableavatar_tpu_torch.train.adam8bit import adamw8bit

        tx = adamw8bit(cfg.learning_rate, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps,
                       cfg.weight_decay)
    else:
        tx = optim.adamw(cfg.learning_rate, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps,
                         cfg.weight_decay)
    parts = [anomaly_clip_transform(cfg.max_grad_norm, cfg.initial_grad_norm_ratio,
                                    cfg.abnormal_norm_clip_start), tx]
    if cfg.lr_scheduler != "constant":  # diffusers "constant" has no warmup
        parts.append(optim.scale_by_schedule(lr_multiplier_schedule(cfg)))
    tx = optim.chain(*parts)
    if mask is not None:
        tx = optim.masked(tx, mask)
    if cfg.gradient_accumulation_steps > 1:
        tx = optim.multi_steps(tx, cfg.gradient_accumulation_steps)
    return tx


def sample_draws(generator: Optional[torch.Generator], latents_shape, train_cfg: TrainConfig,
                 device) -> dict:
    """The step's random draws: noise (like the latents, fp32), timestep
    indices [B] and the scalar mask flag, in the JAX step's order."""
    b = latents_shape[0]
    noise = torch.randn(latents_shape, generator=generator, device=device, dtype=torch.float32)
    if train_cfg.uniform_sampling:
        idx = sample_timestep_indices(generator, b, train_cfg.num_train_timesteps, device=device)
    else:
        idx = density_timestep_indices(
            generator, b, train_cfg.weighting_scheme, train_cfg.num_train_timesteps,
            train_cfg.logit_mean, train_cfg.logit_std, train_cfg.mode_scale, device=device)
        idx = torch.clamp(idx, 0, train_cfg.num_train_timesteps - 1)
    mask_flag = torch.rand((), generator=generator, device=device)
    return {"noise": noise, "idx": idx, "mask_flag": mask_flag}


def sync_gradients(grads, flags, mesh=None) -> None:
    """Sum each gradient in place over the ranks that hold the same tensor:
    a replicated leaf's over every axis, a slice of a split leaf (flag True;
    the gather's reduce-scatter already summed it over 'fsdp') over 'dp' and
    'sp'."""
    for axis in ("dp", "fsdp", "sp"):
        if axis_size(axis, mesh) > 1:
            picked = [g for g, f in zip(grads, flags) if not (f and axis == "fsdp")]
            all_reduce_coalesced(picked, axis_group(axis, mesh))


def train_step(params, opt_state, batch: dict, generator: Optional[torch.Generator],
               is_clip_level_modeling: bool = False, *, dit_cfg, train_cfg: TrainConfig,
               tx: optim.GradientTransformation, sigmas_table: torch.Tensor,
               draws: Optional[dict] = None, global_batch: Optional[int] = None):
    """One flow-matching training step; updates `params` in place.

    batch: latents [B, 16, F, H, W], inpaint_latents [B, 20, F, H, W],
    prompt_embeds [B, text_len, text_dim], clip_fea [B, 257, clip_dim],
    vocal_embeddings [B, La, 768], face_masks / lip_masks [B, 1, F, H, W].
    `draws` ({"noise", "idx", "mask_flag"}) replaces the draws from
    `generator` (the parity tests pass the JAX step's).  Under a mesh the
    batch holds this replica's rows of `global_batch` rows and `draws`, if
    given, are the global batch's.  Returns (params, opt_state, {"loss",
    "grad_norm"}) with the raw, pre-clip gradient norm; under a mesh both
    are the global batch's, equal on every rank."""
    latents = batch["latents"]
    b = latents.shape[0]
    mesh = current_mesh()
    rows, share = slice(0, b), 1.0
    if mesh is not None:
        global_batch = b if global_batch is None else global_batch
        rows, share = replica_rows(global_batch, mesh)
        if rows.stop - rows.start != b:
            raise ValueError(f"this replica's rows of {global_batch} are {rows}, the batch "
                             f"holds {b}")
    if draws is None:
        draws = sample_draws(generator, (global_batch or b, *latents.shape[1:]), train_cfg,
                             latents.device)
    noise, mask_flag = draws["noise"][rows], draws["mask_flag"]
    sigma = sigmas_table[draws["idx"][rows]].reshape(b, 1, 1, 1, 1)
    timesteps = sigma[:, 0, 0, 0, 0] * train_cfg.num_train_timesteps
    noisy = (1.0 - sigma) * latents.float() + sigma * noise
    target = noise - latents.float()

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            pred = dit_forward(
                params, dit_cfg, noisy.to(DIT_DTYPE), timesteps, batch["prompt_embeds"],
                batch["clip_fea"], batch["inpaint_latents"], batch["vocal_embeddings"],
                video_sample_n_frames=train_cfg.video_sample_n_frames,
                is_clip_level_modeling=is_clip_level_modeling, remat=train_cfg.remat)
            loss = masked_flow_loss(
                pred, target, batch["face_masks"], batch["lip_masks"], mask_flag,
                weighting=loss_weighting(train_cfg.weighting_scheme, sigma),
                motion_sub_ratio=(train_cfg.motion_sub_loss_ratio
                                  if train_cfg.motion_sub_loss else 0.0))
            if mesh is not None:
                # the fsdp x sp ranks of a replica compute the same loss
                copies = axis_size("fsdp", mesh) * axis_size("sp", mesh)
                grads = list(torch.autograd.grad(loss * (share / copies), leaves))
            else:
                grads = list(torch.autograd.grad(loss, leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    del pred
    loss = loss.detach()
    specs = leaf_specs(params) if mesh is not None else []
    if mesh is not None:
        sync_gradients(grads, [s is not None for s in specs], mesh)
        loss = loss * share
        if axis_size("dp", mesh) > 1:
            torch.distributed.all_reduce(loss, group=axis_group("dp", mesh))
    with optim.sharded_leaves(specs, axis_group("fsdp", mesh) if axis_size("fsdp", mesh) > 1
                              else None):
        gnorm = optim.global_norm(grads)
        updates, opt_state = tx.update(grads, opt_state, leaves)
    del grads
    optim.apply_updates(leaves, updates)
    return params, opt_state, {"loss": loss, "grad_norm": gnorm}
