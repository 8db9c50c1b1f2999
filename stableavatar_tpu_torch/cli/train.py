"""Training CLI of the port (port of `stableavatar_tpu/cli/train.py`).

One entry point for the reference's five trainers (`train_1B_square.py`,
`train_1B_rec_vec.py`, `train_1B_rec_vec_lora.py`, `train_14B.py`,
`train_14B_lora.py`): `--model_family`, the rec + vec interleave
(`--train_data_rec_meta` with `--train_data_vec_meta`) and `--lora` cover
them.  The same flags, defaults and choices as the JAX package's CLI,
mapped onto PyTorch, one process per card:

- the models come from the inference CLI's `load_models` (checkpoint files
  under --pretrained_model_name_or_path, else random from fixed seeds);
  umT5-xxl stays on the card in bf16 and encodes each batch's prompt, or
  with `--low_vram` stays on the host in fp32 and encodes there;
- clips are read from disk by `data/dataset.py` (a decode thread pool of
  `--dataloader_num_workers` and `--prefetch_depth` batches ahead);
- `--dp` x `--fsdp` x `--sp` ranks form the ('dp', 'fsdp', 'sp') mesh: the
  global batch split over 'dp', the DiT and its AdamW state split over
  'fsdp', the tokens over 'sp' (Ulysses); the step equals the one-process
  step (`train/trainer.py`).  The ranks come from torchrun's environment or
  from `--coordinator_address` / `--num_processes` / `--process_id`:

      torchrun --nproc_per_node 8 -m stableavatar_tpu_torch.cli.train \\
          --fsdp 8 --train_data_meta index.txt ...

- `--validation_steps` with `--validation_reference_path` and
  `--validation_driven_audio_path` runs one clip of the single-clip
  pipeline every so many steps (`train/loop.py:log_validation`).
  `--lora` is parsed and drives nothing, as in the JAX package
  (`utils/lora.py` holds the adapters).

Run on the card:  python -m stableavatar_tpu_torch.cli.train --help
`STABLEAVATAR_TINY=1` selects miniature configs (plumbing runs).
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from stableavatar_tpu_torch.cli.inference import load_models
from stableavatar_tpu_torch.data.dataset import PROMPTS, InterleavedDataset, TalkingVideoDataset
from stableavatar_tpu_torch.parallel.distributed import initialize_distributed, make_multihost_mesh
from stableavatar_tpu_torch.parallel.mesh import mesh_context
from stableavatar_tpu_torch.parallel.sharding import shard_params
from stableavatar_tpu_torch.train.loop import train
from stableavatar_tpu_torch.train.trainer import TrainConfig

# bytes a parameter holds while it trains: the bf16 weight and gradient and
# AdamW's two fp32 moments (fp32 once the anomaly clip has scaled them)
TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("stableavatar train (PyTorch/CUDA)")
    # data (the reference trainers' flag names)
    p.add_argument("--train_data_dir", type=str, required=False)
    p.add_argument("--train_data_meta", type=str, required=False,
                   help="index txt listing clip dirs")
    p.add_argument("--train_data_rec_meta", type=str, default=None)
    p.add_argument("--train_data_vec_meta", type=str, default=None)
    p.add_argument("--video_sample_size", type=int, default=512)
    p.add_argument("--video_sample_n_frames", type=int, default=81)
    # the frame stride of a sample's window
    p.add_argument("--sample_frame_rate", type=int, default=1)
    p.add_argument("--audio_sample_rate", type=int, default=16000)
    # decode threads, and batches prefetched by a background thread
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--prefetch_depth", type=int, default=2)
    p.add_argument("--fps", type=int, default=25)
    # model
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None)
    p.add_argument("--transformer_path", type=str, default=None)
    p.add_argument("--pretrained_wav2vec_path", type=str, default=None)
    p.add_argument("--model_family", type=str, default="1.3B", choices=["1.3B", "14B"])
    # optimization
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--adam_weight_decay", type=float, default=3e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-10)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine", "cosine_with_restarts", "polynomial"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale LR by accum * batch * dp degree")
    p.add_argument("--max_grad_norm", type=float, default=0.05)
    p.add_argument("--initial_grad_norm_ratio", type=float, default=5.0)
    p.add_argument("--abnormal_norm_clip_start", type=int, default=1000)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=10000)
    p.add_argument("--gradient_checkpointing", action="store_true", default=True)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="AdamW with an int8 second moment (train/adam8bit.py)")
    p.add_argument("--use_came", action="store_true",
                   help="CAME optimizer (train/came.py)")
    p.add_argument("--uniform_sampling", action=argparse.BooleanOptionalAction, default=True,
                   help="stratified-uniform timestep sampling; --no-uniform_sampling "
                        "switches to density sampling per --weighting_scheme")
    p.add_argument("--weighting_scheme", type=str, default=None,
                   choices=[None, "sigma_sqrt", "cosmap", "logit_normal", "mode"])
    p.add_argument("--logit_mean", type=float, default=0.0)
    p.add_argument("--logit_std", type=float, default=1.0)
    p.add_argument("--mode_scale", type=float, default=1.29)
    p.add_argument("--train_sampling_steps", type=int, default=1000)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--train_mode", type=str, default="inpaint", choices=["inpaint", "normal"])
    p.add_argument("--tokenizer_max_length", type=int, default=226)
    p.add_argument("--vae_mini_batch", type=int, default=1,
                   help="accepted for parity; the VAE encodes the whole batch in chunks")
    p.add_argument("--num_train_epochs", type=int, default=None,
                   help="accepted for parity; the loop is step-based (--max_train_steps)")
    p.add_argument("--motion_sub_loss", action="store_true")
    p.add_argument("--motion_sub_loss_ratio", type=float, default=0.25)
    # lora
    p.add_argument("--lora", action="store_true")
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--network_alpha", type=int, default=64)
    # checkpointing
    p.add_argument("--output_dir", type=str, default="train_output")
    p.add_argument("--log_every", type=int, default=10,
                   help="metrics JSONL/TensorBoard cadence in steps")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=3)
    p.add_argument("--resume_from_checkpoint", type=str, default="latest")
    p.add_argument("--validation_steps", type=int, default=None)
    p.add_argument("--validation_reference_path", type=str, default=None)
    p.add_argument("--validation_driven_audio_path", type=str, default=None)
    # parallelism: one process per card (parallel/distributed.py)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--low_vram", action="store_true",
                   help="keep umT5-xxl in host memory (fp32) and encode the prompts there")
    return p


def train_config(args) -> TrainConfig:
    """The TrainConfig of the flags (after --scale_lr)."""
    return TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.adam_weight_decay,
        adam_eps=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        initial_grad_norm_ratio=args.initial_grad_norm_ratio,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_total_steps=args.max_train_steps,
        abnormal_norm_clip_start=args.abnormal_norm_clip_start,
        motion_sub_loss=args.motion_sub_loss,
        motion_sub_loss_ratio=args.motion_sub_loss_ratio,
        weighting_scheme=args.weighting_scheme,
        uniform_sampling=args.uniform_sampling,
        logit_mean=args.logit_mean,
        logit_std=args.logit_std,
        mode_scale=args.mode_scale,
        num_train_timesteps=args.train_sampling_steps,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        remat=args.gradient_checkpointing,
        video_sample_n_frames=args.video_sample_n_frames,
        use_8bit_adam=args.use_8bit_adam,
        use_came=args.use_came,
    )


def build_batches(args):
    """The batch stream: one TalkingVideoDataset, or the rec (480x832) + vec
    (832x480) interleave when both metas are given."""
    if args.train_data_rec_meta and args.train_data_vec_meta:
        ds = InterleavedDataset(
            [TalkingVideoDataset(meta, args.train_data_dir or "", sample_size=size,
                                 clip_length=args.video_sample_n_frames,
                                 sample_frame_rate=args.sample_frame_rate)
             for meta, size in ((args.train_data_rec_meta, (480, 832)),
                                (args.train_data_vec_meta, (832, 480)))],
            seed=args.seed)
    else:
        ds = TalkingVideoDataset(
            args.train_data_meta, args.train_data_dir or "",
            sample_size=(args.video_sample_size, args.video_sample_size),
            clip_length=args.video_sample_n_frames, sample_frame_rate=args.sample_frame_rate,
            fps=args.fps, sr=args.audio_sample_rate, seed=args.seed)
    return ds.batches(args.train_batch_size, num_workers=args.dataloader_num_workers,
                      prefetch_depth=args.prefetch_depth)


def build_mesh(args, device):
    """The ('dp', 'fsdp', 'sp') mesh of the flags, or None when all are 1;
    above 1 it needs a process group of dp x fsdp x sp ranks."""
    n = args.dp * args.fsdp * args.sp
    if n == 1:
        return None
    if not dist.is_initialized():
        raise ValueError(f"--dp x --fsdp x --sp = {n} needs {n} processes (torchrun, or "
                         "--coordinator_address / --num_processes / --process_id)")
    return make_multihost_mesh(dp=args.dp, fsdp=args.fsdp, sp=args.sp,
                               device_type=torch.device(device).type)


def validation_config(args, models):
    """The validation clip's inputs: the reference image at the training
    size, the first 4 s of the driving audio, and the CFG prompts (the
    dataset's "speech" prompt and an empty negative, tokenised; the JAX CLI
    passes none, and its single-clip pipeline cannot run without)."""
    from stableavatar_tpu_torch.utils.media import load_image, load_wav

    if not args.validation_driven_audio_path:
        raise ValueError("--validation_reference_path needs --validation_driven_audio_path")
    size = (args.video_sample_size, args.video_sample_size)
    wav, _ = load_wav(args.validation_driven_audio_path, args.audio_sample_rate)
    return {"ref_image": load_image(args.validation_reference_path, size),
            "vocal_waveform": wav[: args.audio_sample_rate * 4],
            "prompt_ids": models.tokenizer(PROMPTS["speech"]),
            "negative_prompt_ids": models.tokenizer("")}


def _check_fits(params, fsdp: int, device) -> None:
    """Refuse a DiT whose weights, gradients and AdamW state would not fit
    the card (14B on one card) before the first step runs out of memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    need = TRAIN_BYTES_PER_PARAM * sum(p.numel() for p in tree_leaves(params)) / fsdp
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(f"training this DiT needs {need / 2**30:.1f} GiB a card for weights, "
                         f"gradients and AdamW state at --fsdp {fsdp}, the card has "
                         f"{have / 2**30:.1f} GiB: raise --fsdp")


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    running = dist.is_initialized()
    initialize_distributed(args.coordinator_address, args.num_processes, args.process_id,
                           device=device)
    try:
        run(args, device)
    finally:
        if dist.is_initialized() and not running:
            dist.destroy_process_group()
    return 0


def run(args, device) -> None:
    # --low_vram: umT5-xxl stays in host memory; encode_prompt_ids routes by
    # the parameters' device
    args.t5_cpu = bool(args.low_vram)
    mesh = build_mesh(args, device)
    models = load_models(args, device)
    _check_fits(models.dit_params, args.fsdp, device)

    if args.scale_lr:
        args.learning_rate = (args.learning_rate * args.gradient_accumulation_steps
                              * args.train_batch_size * args.dp)
    batches = build_batches(args)
    validation_cfg = None
    if args.validation_steps and args.validation_reference_path:
        validation_cfg = validation_config(args, models)

    with mesh_context(mesh):
        if mesh is not None:
            models.dit_params = shard_params(models.dit_params, mesh)
        train(models, batches, train_config(args), output_dir=args.output_dir,
              max_train_steps=args.max_train_steps,
              checkpointing_steps=args.checkpointing_steps,
              checkpoints_total_limit=args.checkpoints_total_limit,
              resume_from_checkpoint=args.resume_from_checkpoint, seed=args.seed,
              train_mode=args.train_mode, log_every=args.log_every,
              validation_steps=args.validation_steps, validation_cfg=validation_cfg)


if __name__ == "__main__":
    sys.exit(main())
