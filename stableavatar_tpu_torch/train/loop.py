"""The training loop (port of `stableavatar_tpu/train/loop.py`): raw
batch -> encoders -> train step -> checkpoint rotation / resume / metrics.

Kept from the JAX package as built: `train` builds `make_optimizer` with no
mask, so every parameter trains; the VAE posterior is SAMPLED (inference
uses mu); the t2v and audio dropouts and the clip-level flag are host draws
from `rng`, in the same order.

Under a ('dp', 'fsdp', 'sp') mesh every rank reads the same seeded batch
stream and makes the same host draws; each dp replica encodes only its rows
(`parallel/distributed.py:replica_rows`), the draws that have one entry per
row made at the global batch's size and sliced.  Checkpoints hold full
tensors, gathered over 'fsdp' and written by rank 0, and are split again
on restore, so a checkpoint moves between meshes and one process.  Rank 0
alone writes metrics and validation output.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from stableavatar_tpu_torch.models.clip import clip_visual_forward, preprocess_reference_image
from stableavatar_tpu_torch.models.vae import encode_video_sample
from stableavatar_tpu_torch.models.wav2vec import normalize_waveform, wav2vec2_forward
from stableavatar_tpu_torch.parallel.distributed import replica_rows
from stableavatar_tpu_torch.parallel.mesh import axis_group, axis_size, current_mesh
from stableavatar_tpu_torch.parallel.sharding import leaf_specs, shard_like, shard_params, unshard
from stableavatar_tpu_torch.pipelines.common import WanModels, encode_prompt_ids, resolve_device
from stableavatar_tpu_torch.train import optim
from stableavatar_tpu_torch.train.trainer import (
    TrainConfig,
    lr_multiplier_schedule,
    make_optimizer,
    train_sigmas,
    train_step,
)
from stableavatar_tpu_torch.utils.metrics import MetricsLogger
from stableavatar_tpu_torch.utils.tree import tree_leaves, tree_map


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of `jax.image.resize(method="linear")` along one
    axis: half-pixel centres, a triangle kernel widened by the downscale
    factor (antialias), normalised columns, samples outside the input
    zeroed."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_linear(x: torch.Tensor, shape) -> torch.Tensor:
    """`jax.image.resize(x, shape, "linear")` (antialiased), axis by axis."""
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = torch.as_tensor(_resize_weights(n_in, n_out), device=x.device)
            x = torch.movedim(torch.tensordot(x, w.to(x.dtype), dims=([axis], [0])), -1, axis)
    return x


def _take_rows(batch: dict, rows: slice) -> dict:
    """Rows of every per-sample entry of a raw batch (arrays, tensors and
    lists along their first axis)."""
    return {k: v[rows] if isinstance(v, (np.ndarray, torch.Tensor, list)) else v
            for k, v in batch.items()}


def encode_batch(models: WanModels, batch: dict, rng: np.random.Generator,
                 audio_dropout_prob: float = 0.1, clip_level_prob: float = 0.3,
                 t2v_zero_prob: float = 0.90, train_mode: str = "inpaint",
                 vae_noise=None, rows: Optional[slice] = None) -> dict:
    """Raw pixel / audio batch -> DiT training inputs on `models.device`.

    Conditioning dropouts, drawn from `rng` in the JAX package's order: the
    t2v flag (samples whose pixel mask is all ones lose their inpaint
    latents with probability `t2v_zero_prob`, unless train_mode is
    "normal"), the audio dropout, the clip-level flag (returned as
    "is_clip_level_modeling").  The VAE posterior noise is drawn from a
    generator seeded by one `rng` draw, or taken from `vae_noise` (a pair:
    video, masked video).  With `models.tokenizer` set, `batch["text_prompt"]`
    is tokenised and umT5-encoded (`encode_prompt_ids`); otherwise
    `batch["prompt_embeds"]` is taken as it is.  `rows` encodes only those
    rows of the batch, with every draw made as for the whole batch."""
    device = resolve_device(models.device)
    b_global = len(batch["pixel_values"])
    rows = slice(0, b_global) if rows is None else rows
    batch = _take_rows(batch, rows)
    pixels = torch.as_tensor(batch["pixel_values"], device=device)  # [B, 3, F, H, W]
    b = pixels.shape[0]

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 31)))
    noise_lat, noise_msk = vae_noise if vae_noise is not None else (None, None)
    latents = encode_video_sample(models.vae_params, pixels, models.vae_cfg,
                                  noise=noise_lat, generator=gen, rows=(b_global, rows))
    masked = torch.as_tensor(batch["masked_pixel_values"], device=device)
    masked_latents = encode_video_sample(models.vae_params, masked, models.vae_cfg,
                                         noise=noise_msk, generator=gen, rows=(b_global, rows))

    # mask -> latent packing: first frame repeated 4x, grouped into 4-channel
    # latent-frame masks, inverted (1 where conditioning pixels are visible)
    # and resized to the latent grid
    raw_masks = np.asarray(batch["pixel_value_masks"])  # [B, F, 1, H, W]
    m = torch.as_tensor(raw_masks, device=device)[:, :, 0]
    lh, lw = latents.shape[-2:]
    hp, wp = m.shape[-2:]
    m = torch.cat([m[:, 0:1].repeat(1, 4, 1, 1), m[:, 1:]], dim=1)
    m = m.reshape(b, m.shape[1] // 4, 4, hp, wp).transpose(1, 2)
    m = resize_linear(1.0 - m, (*m.shape[:3], lh, lw))
    inpaint_latents = torch.cat([m.to(latents.dtype), masked_latents], dim=1)

    if train_mode != "normal":
        all_ones = raw_masks.reshape(b, -1).min(axis=1) >= 1.0
        t2v_flag = np.where(all_ones & (rng.random(b_global)[rows] < t2v_zero_prob), 0.0, 1.0)
        inpaint_latents = inpaint_latents * torch.as_tensor(
            t2v_flag, dtype=inpaint_latents.dtype, device=device)[:, None, None, None, None]

    ref = torch.as_tensor(batch["reference_image"], device=device)[:, :, 0]  # [B, 3, H, W]
    clip_fea = clip_visual_forward(models.clip_params, models.clip_cfg,
                                   preprocess_reference_image(ref, models.clip_cfg))

    wav = torch.as_tensor(batch["vocal_input_values"], device=device)  # [B, S]
    if models.wav2vec_cfg.do_normalize:
        wav = normalize_waveform(wav)
    vocal = wav2vec2_forward(models.wav2vec_params, models.wav2vec_cfg, wav)
    if rng.random() < audio_dropout_prob:
        vocal = torch.zeros_like(vocal)
    is_clip_level = bool(rng.random() < clip_level_prob)

    if models.tokenizer is not None:
        ids, mask = zip(*(models.tokenizer(p) for p in batch["text_prompt"]))
        with torch.no_grad():
            prompt_embeds = encode_prompt_ids(models, np.stack(ids), np.stack(mask))
    else:
        prompt_embeds = torch.as_tensor(batch["prompt_embeds"], device=device)

    def latent_masks(key):
        mm = torch.as_tensor(batch[key], device=device)[:, 0].float()  # [B, F, H, W]
        return resize_linear(mm, (b, latents.shape[2], lh, lw))[:, None]

    return {
        "latents": latents,
        "inpaint_latents": inpaint_latents,
        "prompt_embeds": prompt_embeds,
        "clip_fea": clip_fea,
        "vocal_embeddings": vocal,
        "face_masks": latent_masks("tgt_face_masks"),
        "lip_masks": latent_masks("tgt_lip_masks"),
        "is_clip_level_modeling": is_clip_level,
    }


def _finished_ckpts(output_dir: str):
    """checkpoint-<step> directories, without unfinished `tmp` ones, so a run
    killed mid-write never resumes from a partial checkpoint."""
    return sorted((d for d in os.listdir(output_dir)
                   if d.startswith("checkpoint-") and "tmp" not in d),
                  key=lambda d: int(d.split("-")[1]))


def _to_host(x):
    return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x


def _per_leaf(state, leaves) -> bool:
    """Whether a list of an optimizer state has one entry per parameter
    leaf: a tensor of the leaf's shape (Adam's moments, the accumulator) or
    a dict of tensors that holds one (8-bit Adam's second moment, CAME's
    leaves)."""
    def entry(x, p):
        if torch.is_tensor(x):
            return x.shape == p.shape
        return (isinstance(x, dict) and all(torch.is_tensor(v) for v in x.values())
                and any(v.shape == p.shape for v in x.values()))

    return len(state) == len(leaves) and all(entry(x, p) for x, p in zip(state, leaves))


def map_leaf_lists(state, leaves, specs, fn, other=lambda x: x):
    """`fn(x, spec)` on every tensor of an optimizer state's per-leaf lists
    -- the lists with one entry per parameter leaf, whose tensors have the
    layout of `leaves` -- with `spec` the tensor's `Shard` over 'fsdp'
    where its leaf's is `specs[i]` (`optim.field_spec`; None where every
    rank holds the same tensor), and `other` on the rest."""
    if isinstance(state, dict):
        return {k: map_leaf_lists(v, leaves, specs, fn, other) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        if _per_leaf(state, leaves):
            return [fn(x, specs[i]) if torch.is_tensor(x) else
                    {k: fn(v, optim.field_spec(k, v, leaves[i].shape, specs[i]))
                     for k, v in x.items()}
                    for i, x in enumerate(state)]
        return type(state)(map_leaf_lists(v, leaves, specs, fn, other) for v in state)
    return other(state)


def host_state(params, opt_state, mesh=None, keep: bool = True):
    """Host copies of (params, opt_state) with every fsdp slice gathered to
    its full tensor: a collective of the fsdp group, which holds one
    gathered tensor on the device at a time.  A tensor that every rank
    holds the same is copied as it is.  With keep=False (a rank that does
    not write) the gathers run and nothing is copied."""
    host = _to_host if keep else (lambda x: None)
    full = tree_map(lambda x: host(unshard(x, mesh)), params)
    state = map_leaf_lists(opt_state, tree_leaves(params), leaf_specs(params),
                           lambda x, spec: host(unshard(x, mesh, spec=spec)), host)
    return full, state


def shard_state(params, opt_state, mesh):
    """(params, opt_state) of full tensors split for `mesh`: this rank's
    slices of the parameters that the fsdp rule splits, and of the state's
    tensors that keep a split axis (the inverse of `host_state`'s
    gathers); the rest as it is."""
    sharded = shard_params(params, mesh)
    state = map_leaf_lists(opt_state, tree_leaves(params), leaf_specs(sharded),
                           lambda x, spec: shard_like(x, spec, mesh))
    return sharded, state


@dataclasses.dataclass
class CheckpointManager:
    """Save + rotation + latest-resume of {params, opt_state, step}.

    A checkpoint is `checkpoint-<step>/state.pt` (`torch.save`), written
    into a `checkpoint-<step>.tmp-<ns>` directory and renamed when complete.
    `save(wait=False)` copies the state to host memory synchronously (the
    step then updates the device parameters in place) and writes it on a
    thread; the next save or `wait()` joins it.  Under a mesh every rank
    calls `save` (the fsdp slices are gathered to full tensors) and only the
    `writer` (rank 0) writes and rotates."""

    output_dir: str
    total_limit: Optional[int] = None
    writer: bool = True
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def save(self, step: int, params, opt_state, wait: bool = True) -> str:
        if self.writer:
            self._join()
            self._rotate(keep_latest=True)
        params, opt_state = host_state(params, opt_state, keep=self.writer)
        path = os.path.join(self.output_dir, f"checkpoint-{step}")
        if not self.writer:
            return path
        state = {"params": params, "opt_state": opt_state, "step": int(step)}
        if wait:
            self._write(path, state)
            self._rotate()
        else:
            self._thread = threading.Thread(target=self._write_async, args=(path, state),
                                            daemon=True)
            self._thread.start()
        return path

    def _write(self, path: str, state: dict) -> None:
        tmp = f"{path}.tmp-{time.time_ns()}"
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    def _write_async(self, path: str, state: dict) -> None:
        try:
            self._write(path, state)
        except BaseException as e:  # re-raised by the next join
            self._error = e

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        self._join()
        self._rotate()

    def _rotate(self, keep_latest: bool = False) -> None:
        if not self.writer or self.total_limit is None or not os.path.isdir(self.output_dir):
            return
        ckpts = _finished_ckpts(self.output_dir)
        # before an async save the newest finished checkpoint survives until
        # the new one is complete
        limit = self.total_limit if not keep_latest else max(self.total_limit, 1)
        while len(ckpts) > limit:
            shutil.rmtree(os.path.join(self.output_dir, ckpts.pop(0)))

    def latest(self) -> Optional[str]:
        if not os.path.isdir(self.output_dir):
            return None
        ckpts = _finished_ckpts(self.output_dir)
        return os.path.join(self.output_dir, ckpts[-1]) if ckpts else None

    def restore(self, device="cuda") -> Optional[dict]:
        """The latest complete checkpoint, tensors on `device`, or None
        (full tensors: `shard_state` splits them for a mesh)."""
        path = self.latest()
        if path is None:
            return None
        state = torch.load(os.path.join(path, "state.pt"), map_location=device,
                           weights_only=True)
        return state


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def log_validation(models: WanModels, validation_cfg: dict, output_dir: str, step: int):
    """In-training validation: one clip of the single-clip pipeline, saved as
    `validation_step{step}.mp4` (a PNG frame directory without ffmpeg);
    returns the path written.  In a process group every rank generates (the
    mesh's collectives) and rank 0 alone writes; the others return None."""
    from stableavatar_tpu_torch.pipelines.single_clip import generate_single_clip
    from stableavatar_tpu_torch.utils.video_io import save_videos_grid

    out = generate_single_clip(
        models,
        ref_image=validation_cfg["ref_image"],
        vocal_waveform=validation_cfg["vocal_waveform"],
        prompt_ids=validation_cfg.get("prompt_ids"),
        negative_prompt_ids=validation_cfg.get("negative_prompt_ids"),
        text_ctx=validation_cfg.get("text_ctx"),
        num_inference_steps=validation_cfg.get("num_inference_steps", 20),
        clip_length=validation_cfg.get("clip_length", 81),
        seed=validation_cfg.get("seed", 42),
    )
    if not _is_writer():
        return None
    path = os.path.join(output_dir, f"validation_step{step}.mp4")
    # a PNG frame directory without an ffmpeg backend or imageio
    return save_videos_grid(out.videos, path, fps=validation_cfg.get("fps", 25)) or path


def train(models: WanModels, batches: Iterable[dict], train_cfg: TrainConfig, *,
          output_dir: str = "train_output", max_train_steps: int = 1000,
          checkpointing_steps: int = 500, checkpoints_total_limit: Optional[int] = 3,
          resume_from_checkpoint: Optional[str] = "latest", log_every: int = 10,
          seed: int = 42, validation_steps: Optional[int] = None,
          validation_cfg: Optional[dict] = None, async_checkpointing: bool = True,
          preemption_signals: tuple = None, train_mode: str = "inpaint",
          step_callback=None):
    """Main loop.  Checkpoints are written asynchronously while training
    continues, and a preemption signal (SIGTERM by default) triggers a
    synchronous save and a clean return, so `resume_from_checkpoint="latest"`
    continues from the exact step.  `step_callback(step, params, metrics)`
    runs after every step (metrics: loss, grad_norm, is_clip_level_modeling).
    Under a mesh (`parallel/mesh.py:mesh_context`; the parameters split with
    `shard_params`) every rank runs the loop on the same batch stream (the
    module docstring).  Returns (params, opt_state, history); the parameters
    are updated in place on `models.device` and left in `models.dit_params`."""
    device = resolve_device(models.device)
    mesh = current_mesh()
    writer = _is_writer()
    os.makedirs(output_dir, exist_ok=True)
    tx = make_optimizer(train_cfg)
    params = models.dit_params
    # under fsdp the optimizer state is made at this rank's slices
    with optim.sharded_leaves(leaf_specs(params) if mesh is not None else (),
                              axis_group("fsdp") if axis_size("fsdp") > 1 else None):
        opt_state = tx.init(tree_leaves(params))
    step = 0

    cm = CheckpointManager(output_dir, checkpoints_total_limit, writer=writer)
    if resume_from_checkpoint == "latest":
        restored = cm.restore(device)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            if mesh is not None:
                params, opt_state = shard_state(params, opt_state, mesh)
            step = int(restored["step"])

    sigmas = train_sigmas(train_cfg.num_train_timesteps, train_cfg.shift, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    history = []
    logger = MetricsLogger(output_dir) if writer else None

    # preemption-safe exit: a handled signal sets the flag; the loop saves a
    # synchronous checkpoint and returns (handlers attach on the main thread)
    preempted = {"flag": False, "signum": None}
    if preemption_signals is None:
        preemption_signals = (signal.SIGTERM,)
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _on_preempt(signum, frame):
            preempted["flag"] = True
            preempted["signum"] = signum

        for sig in preemption_signals:
            old_handlers[sig] = signal.signal(sig, _on_preempt)

    def stop_now() -> bool:
        if mesh is None:
            return preempted["flag"]
        # every rank saves at the same step, or the gathers would not meet
        flag = torch.tensor(int(preempted["flag"]), device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag)

    t0 = time.time()
    try:
        for batch in batches:
            if step >= max_train_steps:
                break
            b_global = len(batch["pixel_values"])
            rows = replica_rows(b_global, mesh)[0] if mesh is not None else None
            enc = encode_batch(models, batch, rng, train_mode=train_mode, rows=rows)
            is_clip_level = enc.pop("is_clip_level_modeling", False)
            params, opt_state, metrics = train_step(
                params, opt_state, enc, gen, is_clip_level, dit_cfg=models.dit_cfg,
                train_cfg=train_cfg, tx=tx, sigmas_table=sigmas, global_batch=b_global)
            step += 1
            if step_callback is not None:
                step_callback(step, params, dict(metrics, is_clip_level_modeling=is_clip_level))
            if step % log_every == 0:
                loss = float(metrics["loss"])
                lr_now = train_cfg.learning_rate
                if train_cfg.lr_scheduler != "constant":
                    lr_now *= float(lr_multiplier_schedule(train_cfg)(
                        step // max(train_cfg.gradient_accumulation_steps, 1)))
                history.append({"step": step, "loss": loss, "time": time.time() - t0})
                if writer:
                    logger.log(step, {"train_loss": loss,
                                      "grad_norm": float(metrics["grad_norm"]), "lr": lr_now})
                    print(f"step {step} loss {loss:.5f} "
                          f"gnorm {float(metrics['grad_norm']):.4f} lr {lr_now:.2e}")
            if stop_now():
                cm.save(step, params, opt_state, wait=True)
                if writer:
                    print(f"[train] preemption signal {preempted['signum']} - saved "
                          f"checkpoint-{step} and exiting for clean resume")
                break
            if step % checkpointing_steps == 0:
                cm.save(step, params, opt_state, wait=not async_checkpointing)
            if validation_steps and validation_cfg and step % validation_steps == 0:
                models.dit_params = params
                log_validation(models, validation_cfg, output_dir, step)
    finally:
        cm.wait()  # join any in-flight async save
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        if logger is not None:
            logger.close()

    models.dit_params = params
    return params, opt_state, history
