"""The training loop (port of `stableavatar_tpu/train/loop.py`): raw
batch -> encoders -> train step -> checkpoint rotation / resume / metrics.

Kept from the JAX package as built: `train` builds `make_optimizer` with no
mask, so every parameter trains; the VAE posterior is SAMPLED (inference
uses mu); the t2v and audio dropouts and the clip-level flag are host draws
from `rng`, in the same order.
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

from stableavatar_tpu_torch.models.clip import clip_visual_forward, preprocess_reference_image
from stableavatar_tpu_torch.models.vae import encode_video_sample
from stableavatar_tpu_torch.models.wav2vec import normalize_waveform, wav2vec2_forward
from stableavatar_tpu_torch.pipelines.common import WanModels, encode_prompt_ids, resolve_device
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


def encode_batch(models: WanModels, batch: dict, rng: np.random.Generator,
                 audio_dropout_prob: float = 0.1, clip_level_prob: float = 0.3,
                 t2v_zero_prob: float = 0.90, train_mode: str = "inpaint",
                 vae_noise=None) -> dict:
    """Raw pixel / audio batch -> DiT training inputs on `models.device`.

    Conditioning dropouts, drawn from `rng` in the JAX package's order: the
    t2v flag (samples whose pixel mask is all ones lose their inpaint
    latents with probability `t2v_zero_prob`, unless train_mode is
    "normal"), the audio dropout, the clip-level flag (returned as
    "is_clip_level_modeling").  The VAE posterior noise is drawn from a
    generator seeded by one `rng` draw, or taken from `vae_noise` (a pair:
    video, masked video).  With `models.tokenizer` set, `batch["text_prompt"]`
    is tokenised and umT5-encoded (`encode_prompt_ids`); otherwise
    `batch["prompt_embeds"]` is taken as it is."""
    device = resolve_device(models.device)
    pixels = torch.as_tensor(batch["pixel_values"], device=device)  # [B, 3, F, H, W]
    b = pixels.shape[0]

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 31)))
    noise_lat, noise_msk = vae_noise if vae_noise is not None else (None, None)
    latents = encode_video_sample(models.vae_params, pixels, models.vae_cfg,
                                  noise=noise_lat, generator=gen)
    masked = torch.as_tensor(batch["masked_pixel_values"], device=device)
    masked_latents = encode_video_sample(models.vae_params, masked, models.vae_cfg,
                                         noise=noise_msk, generator=gen)

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
        t2v_flag = np.where(all_ones & (rng.random(b) < t2v_zero_prob), 0.0, 1.0)
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


@dataclasses.dataclass
class CheckpointManager:
    """Save + rotation + latest-resume of {params, opt_state, step}.

    A checkpoint is `checkpoint-<step>/state.pt` (`torch.save`), written
    into a `checkpoint-<step>.tmp-<ns>` directory and renamed when complete.
    `save(wait=False)` copies the state to host memory synchronously (the
    step then updates the device parameters in place) and writes it on a
    thread; the next save or `wait()` joins it."""

    output_dir: str
    total_limit: Optional[int] = None
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def save(self, step: int, params, opt_state, wait: bool = True) -> str:
        self._join()
        self._rotate(keep_latest=True)
        path = os.path.join(self.output_dir, f"checkpoint-{step}")
        state = {"params": tree_map(_to_host, params),
                 "opt_state": tree_map(_to_host, opt_state), "step": int(step)}
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
        if self.total_limit is None or not os.path.isdir(self.output_dir):
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
        """The latest complete checkpoint, tensors on `device`, or None."""
        path = self.latest()
        if path is None:
            return None
        state = torch.load(os.path.join(path, "state.pt"), map_location=device,
                           weights_only=True)
        return state


def log_validation(models: WanModels, validation_cfg: dict, output_dir: str, step: int):
    """In-training validation: one clip of the single-clip pipeline, saved as
    `validation_step{step}.mp4` (a PNG frame directory without ffmpeg);
    returns the path written."""
    from stableavatar_tpu_torch.pipelines.single_clip import generate_single_clip
    from stableavatar_tpu_torch.utils.video_io import save_videos_grid, to_uint8

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
    path = os.path.join(output_dir, f"validation_step{step}.mp4")
    try:
        import imageio  # noqa: F401  (save_videos_grid's writer)
    except ImportError:
        # a host without imageio: the PNG frames save_videos_grid writes
        # without an ffmpeg backend, through PIL
        from PIL import Image

        stem = os.path.splitext(path)[0]
        os.makedirs(stem, exist_ok=True)
        for i, frame in enumerate(to_uint8(out.videos)):
            Image.fromarray(frame).save(os.path.join(stem, f"frame_{i:06d}.png"))
        print(f"[stableavatar] no imageio - wrote the validation frames to {stem}/")
        return stem
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
    Returns (params, opt_state, history); the parameters are updated in
    place on `models.device` and left in `models.dit_params`."""
    device = resolve_device(models.device)
    os.makedirs(output_dir, exist_ok=True)
    tx = make_optimizer(train_cfg)
    params = models.dit_params
    opt_state = tx.init(tree_leaves(params))
    step = 0

    cm = CheckpointManager(output_dir, checkpoints_total_limit)
    if resume_from_checkpoint == "latest":
        restored = cm.restore(device)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            step = int(restored["step"])

    sigmas = train_sigmas(train_cfg.num_train_timesteps, train_cfg.shift, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    history = []
    logger = MetricsLogger(output_dir)

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

    t0 = time.time()
    try:
        for batch in batches:
            if step >= max_train_steps:
                break
            enc = encode_batch(models, batch, rng, train_mode=train_mode)
            is_clip_level = enc.pop("is_clip_level_modeling", False)
            params, opt_state, metrics = train_step(
                params, opt_state, enc, gen, is_clip_level, dit_cfg=models.dit_cfg,
                train_cfg=train_cfg, tx=tx, sigmas_table=sigmas)
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
                logger.log(step, {"train_loss": loss, "grad_norm": float(metrics["grad_norm"]),
                                  "lr": lr_now})
                print(f"step {step} loss {loss:.5f} "
                      f"gnorm {float(metrics['grad_norm']):.4f} lr {lr_now:.2e}")
            if preempted["flag"]:
                cm.save(step, params, opt_state, wait=True)
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
        logger.close()

    models.dit_params = params
    return params, opt_state, history
