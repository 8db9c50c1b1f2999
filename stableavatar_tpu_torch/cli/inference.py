"""Inference CLI of the port (port of `stableavatar_tpu/cli/inference.py`).

The same flags, defaults and choices as the JAX package's CLI, mapped onto
PyTorch, one process per card:

- `--GPU_memory_mode model_full_load` keeps umT5-xxl (bf16, 11.4 GB) on the
  card; every other mode (and `--offload_model`) encodes the prompts on the
  card first, then releases T5 before the DiT loads; `--t5_cpu` keeps fp32
  T5 on the host and encodes there;
- `--fast_path` prepares the DiT for the inference fast path (split-pair
  rope, int8 attention, W8A8 linears); `model_cpu_offload_and_qfloat8`
  stores the block weights in int8 with bf16 compute;
- TeaCache flags build the host-side controller;
- `--ulysses_degree` x `--ring_degree` ranks form the sequence-parallel 'sp'
  axis (one ring over all of them when `--ring_degree` > 1, Ulysses
  otherwise), `--fsdp_dit` shards the DiT over world // sp ranks when the
  world holds at least two sp groups, the remaining ranks replicate
  (`parallel/`); every rank runs the same sweep and rank 0 alone writes the
  video.  The ranks come from torchrun's environment or from
  `--coordinator_address` / `--num_processes` / `--process_id`:

      torchrun --nproc_per_node 4 -m stableavatar_tpu_torch.cli.inference \
          --ulysses_degree 4 ...

Checkpoints load as in the JAX CLI, from the same files under
--pretrained_model_name_or_path (umT5-xxl, the DiT, the VAE, CLIP), with
--transformer_path merged over the DiT and the HF wav2vec2 directory of
--pretrained_wav2vec_path (`utils/checkpoint.py`); each model without a
file is random, drawn from a fixed seed, and the tokenizer is a byte-level
fallback unless `google/umt5-xxl` is under the root.  `--model_family 14B`
selects WAN_14B; `--GPU_memory_mode sequential_cpu_offload` keeps the DiT's
blocks in pinned host memory and streams them through the card
(`models/streaming.py`).

Run on the card:  python -m stableavatar_tpu_torch.cli.inference --help
`STABLEAVATAR_TINY=1` selects miniature configs (plumbing runs).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from stableavatar_tpu_torch import config
from stableavatar_tpu_torch.models.clip import init_clip_visual
from stableavatar_tpu_torch.models.dit import init_dit
from stableavatar_tpu_torch.models.streaming import StreamedDiT
from stableavatar_tpu_torch.models.t5 import init_t5
from stableavatar_tpu_torch.models.teacache import TeaCache, get_teacache_coefficients
from stableavatar_tpu_torch.models.vae import init_vae
from stableavatar_tpu_torch.models.wav2vec import init_wav2vec2
from stableavatar_tpu_torch.parallel.distributed import initialize_distributed, make_multihost_mesh
from stableavatar_tpu_torch.parallel.mesh import mesh_context
from stableavatar_tpu_torch.parallel.sharding import shard_params
from stableavatar_tpu_torch.pipelines.common import WanModels, encode_prompts, resolve_device
from stableavatar_tpu_torch.pipelines.long import generate_long
from stableavatar_tpu_torch.utils import checkpoint as ckpt
from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

# the checkpoint files of the JAX CLI, under --pretrained_model_name_or_path
T5_FILE = "models_t5_umt5-xxl-enc-bf16.pth"
DIT_FILE = "diffusion_pytorch_model.safetensors"
VAE_FILE = "Wan2.1_VAE.pth"
CLIP_FILE = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("stableavatar inference (PyTorch/CUDA)")
    # I/O (the reference inference.py flag names)
    p.add_argument("--config_path", type=str, default=None)
    p.add_argument("--pretrained_model_name_or_path", type=str, required=False)
    p.add_argument("--transformer_path", type=str, default=None)
    p.add_argument("--pretrained_wav2vec_path", type=str, default=None)
    p.add_argument("--validation_reference_path", type=str, required=False)
    p.add_argument("--validation_driven_audio_path", type=str, required=False)
    p.add_argument("--validation_prompts", type=str, default="")
    p.add_argument("--negative_prompts", type=str, default="")
    p.add_argument("--output_dir", type=str, default="outputs")
    # generation
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--text_guide_scale", "--sample_text_guide_scale", type=float, default=3.0)
    p.add_argument("--audio_guide_scale", "--sample_audio_guide_scale", type=float, default=5.0)
    p.add_argument("--sample_shift", type=float, default=None,
                   help="flow-matching sigma shift; None keeps 5.0")
    p.add_argument("--clip_sample_n_frames", type=int, default=81)
    p.add_argument("--overlap_window_length", type=int, default=15)
    p.add_argument("--overlapping_weight_scheme", type=str, default="uniform",
                   choices=["uniform", "log"])
    p.add_argument("--sample_solver", type=str, default="euler",
                   choices=["euler", "dpm++", "unipc"])
    p.add_argument("--solver_order", type=int, default=2, choices=[1, 2, 3])
    p.add_argument("--color_correction_strength", type=float, default=0.0,
                   help="LAB colour match of the decoded video to the reference image "
                        "(0 disables)")
    p.add_argument("--solver_type", type=str, default=None,
                   choices=["midpoint", "heun", "bh1", "bh2"],
                   help="dpm++: midpoint (default) | heun; unipc: bh2 (default) | bh1")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--motion_frame", type=int, default=25)  # accepted, unused
    # RIFLEx rope extrapolation, opt-in
    p.add_argument("--enable_riflex", action="store_true")
    p.add_argument("--riflex_k", type=int, default=6)
    p.add_argument("--riflex_L_test", type=int, default=66)
    p.add_argument("--riflex_scale", type=float, default=4.886)
    # parsed only, as in the reference
    p.add_argument("--input_perturbation", type=float, default=0)
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--variant", type=str, default=None)
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--validation_epochs", type=int, default=1)
    p.add_argument("--offload_model", action="store_true",
                   help="encode the prompts, then release T5 (as any offload mode)")
    # model family
    p.add_argument("--model_family", type=str, default="1.3B", choices=["1.3B", "14B"])
    # memory / speed
    p.add_argument("--GPU_memory_mode", type=str, default="model_cpu_offload",
                   choices=["model_full_load", "model_cpu_offload",
                            "model_cpu_offload_and_qfloat8", "sequential_cpu_offload"])
    p.add_argument("--enable_teacache", action="store_true")
    p.add_argument("--teacache_threshold", type=float, default=0.1)
    p.add_argument("--num_skip_start_steps", type=int, default=5)
    p.add_argument("--teacache_offload", action="store_true")  # parsed only
    # inference fast path: "qk" int8 self-attention, "linears" also W8A8 linears
    p.add_argument("--fast_path", type=str, default="off",
                   choices=["off", "rope", "qk", "linears"])
    p.add_argument("--reference_attn_numerics", action="store_true",
                   help="drop the vocal k_lens padding masks in cross-attention, as the "
                        "shipped reference's SDPA path does")
    p.add_argument("--stream_output", action="store_true",
                   help="stream decoded segments to the video writer (host memory "
                        "O(segment))")
    # parallelism
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--ulysses_degree", type=int, default=1)
    p.add_argument("--ring_degree", type=int, default=1)
    p.add_argument("--fsdp_dit", action="store_true",
                   help="shard the DiT over world // sp ranks (when world >= 2 sp)")
    p.add_argument("--t5_fsdp", action="store_true")  # parsed only, as in the reference
    p.add_argument("--t5_cpu", action="store_true")
    return p


def resolve_fast_path(args):
    """--fast_path x --GPU_memory_mode -> (prepare, quant, rope_split,
    attn_quant): `model_cpu_offload_and_qfloat8` stores int8 weights with
    bf16 compute (quant="store"); int8 compute is --fast_path's opt-in."""
    fast = getattr(args, "fast_path", "off")
    quant_store = getattr(args, "GPU_memory_mode", "") == "model_cpu_offload_and_qfloat8"
    prepare = fast != "off" or quant_store
    if fast == "linears":
        quant = True
    elif quant_store:
        quant = "store"
    else:
        quant = False
    attn_quant = "qk" if fast in ("qk", "linears") else "none"
    return prepare, quant, prepare, attn_quant


def build_tokenizer(args, root, t5_cfg):
    """The umT5 tokenizer when present on disk, else a deterministic
    byte-level fallback (random-weight runs)."""
    tok_dir = root and os.path.join(root, "google/umt5-xxl")
    if tok_dir and os.path.isdir(tok_dir):
        from transformers import AutoTokenizer

        hf_tok = AutoTokenizer.from_pretrained(tok_dir)
        tok_len = int(getattr(args, "tokenizer_max_length", 0) or t5_cfg.text_len)

        def tokenizer(text):
            out = hf_tok(text, padding="max_length", max_length=tok_len, truncation=True,
                         add_special_tokens=True, return_tensors="np")
            ids = out["input_ids"][0]
            mask = out["attention_mask"][0]
            if tok_len < t5_cfg.text_len:  # re-pad to the model context
                pad = t5_cfg.text_len - tok_len
                ids = np.pad(ids, (0, pad))
                mask = np.pad(mask, (0, pad))
            return ids, mask
    else:
        print("[stableavatar] no umt5 tokenizer found - using the byte-level fallback "
              "(outputs are not meaningful without checkpoints)")

        def tokenizer(text):
            ids = np.zeros(t5_cfg.text_len, dtype=np.int32)
            toks = [b % (t5_cfg.vocab - 2) + 2 for b in text.encode()][: t5_cfg.text_len - 1]
            ids[: len(toks)] = toks
            ids[len(toks)] = 1  # eos
            mask = np.zeros(t5_cfg.text_len, dtype=np.int32)
            mask[: len(toks) + 1] = 1
            return ids, mask

    return tokenizer


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _gib(device) -> str:
    if device.type != "cuda":
        return "host"
    return f"{torch.cuda.memory_allocated(device) / 2 ** 30:.2f} GiB allocated"


def _wav2vec(args, cfg, device, gen):
    """wav2vec2 from --pretrained_wav2vec_path (its preprocessor's
    normalisation, the first *.bin / *.safetensors with the "wav2vec2."
    prefix stripped), else random; fp32."""
    w2v = args.pretrained_wav2vec_path
    if not (w2v and os.path.isdir(w2v)):
        return init_wav2vec2(gen, cfg, device, torch.float32), cfg
    pc = os.path.join(w2v, "preprocessor_config.json")
    if os.path.exists(pc):
        with open(pc) as f:
            cfg = dataclasses.replace(cfg, do_normalize=bool(json.load(f).get("do_normalize", True)))
    files = glob.glob(os.path.join(w2v, "*.bin")) + glob.glob(os.path.join(w2v, "*.safetensors"))
    if not files:
        return init_wav2vec2(gen, cfg, device, torch.float32), cfg
    sd = {k.removeprefix("wav2vec2."): v for k, v in ckpt.load_torch_state_dict(files[0]).items()}
    return ckpt.to_device(ckpt.convert_wav2vec2(sd, cfg), device, torch.float32), cfg


def load_models(args, device="cuda", timer=None, keep_t5: bool = False) -> WanModels:
    """The model bundle on `device` (the card unless the caller asks for the
    CPU): each model from its checkpoint file when there is one (converted
    on the host, each leaf copied to the device once in its dtype), else
    random from a fixed seed.  T5 loads first: unless --GPU_memory_mode is
    model_full_load or --t5_cpu is set, the prompts are encoded right away
    (inside `timer`'s "text_encode" phase) and T5 is released before the
    DiT loads.  `keep_t5` keeps it loaded under every mode, for a caller
    that encodes prompts later (the serving app: each request brings its
    own): bf16 on the card, or fp32 on the host with --t5_cpu.  Under sequential_cpu_offload the DiT's blocks go to pinned
    host memory (`models/streaming.py:StreamedDiT`) and `dit_params` is None."""
    device = resolve_device(device)
    tiny = None
    if os.environ.get("STABLEAVATAR_TINY") == "1":
        tiny = config.tiny_debug_configs()
        print("[stableavatar] STABLEAVATAR_TINY=1 - tiny debug models (plumbing only)")
    dit_cfg, vae_cfg, t5_cfg, clip_cfg, w2v_cfg = tiny or (
        config.WAN_14B if args.model_family == "14B" else config.WAN_1_3B, config.VAEConfig(),
        config.T5Config(), config.CLIPConfig(), config.Wav2Vec2Config())
    if tiny and args.model_family == "14B":
        # a tiny DiT of 14B's structure: the two-stage audio projection
        dit_cfg = dataclasses.replace(dit_cfg, audio_proj_hidden=2 * dit_cfg.audio_proj_dim)
    if getattr(args, "enable_riflex", False):
        dit_cfg = dataclasses.replace(dit_cfg, riflex_k=args.riflex_k,
                                      riflex_L_test=args.riflex_L_test,
                                      riflex_scale=args.riflex_scale)
    bf16 = torch.bfloat16
    root = args.pretrained_model_name_or_path

    def found(name):
        path = root and os.path.join(root, name)
        return path if path and os.path.exists(path) else None

    # umT5-xxl: bf16 on the card, or fp32 on the host when the caller asks
    # (--t5_cpu; the train CLI's --low_vram).  The flags that only the
    # inference parser has are read with the JAX CLI's defaults, so the
    # train CLI's namespace loads T5 on the card and keeps it there.
    t5_cpu = getattr(args, "t5_cpu", False)
    t5_dev = torch.device("cpu") if t5_cpu else device
    t5_dtype = torch.float32 if t5_cpu else bf16
    if found(T5_FILE):
        t5_params = ckpt.to_device(ckpt.convert_t5(ckpt.load_torch_state_dict(found(T5_FILE)),
                                                   t5_cfg), t5_dev, t5_dtype)
    else:
        t5_params = init_t5(_gen(t5_dev, 2), t5_cfg, t5_dev, t5_dtype)
    tokenizer = build_tokenizer(args, root, t5_cfg)
    text_ctx = None
    memory_mode = getattr(args, "GPU_memory_mode", "model_full_load")
    if not (t5_cpu or keep_t5) and (getattr(args, "offload_model", False)
                                    or memory_mode != "model_full_load"):
        phase = (timer.follow(device).phase if timer is not None
                 else (lambda name: contextlib.nullcontext()))
        with phase("text_encode"):
            text_ctx = encode_prompts(
                WanModels(dit_params=None, dit_cfg=dit_cfg, vae_params=None,
                          t5_params=t5_params, t5_cfg=t5_cfg, tokenizer=tokenizer,
                          device=device),
                args.validation_prompts, getattr(args, "negative_prompts", "") or "")
        before = _gib(device)
        t5_params = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[stableavatar] prompts encoded; T5 released ({before} -> {_gib(device)})")

    override = None
    if args.transformer_path and os.path.exists(args.transformer_path):
        override = ckpt.load_torch_state_dict(args.transformer_path)
    if found(DIT_FILE):
        sd = ckpt.load_torch_state_dict(found(DIT_FILE))
        if override is not None:
            # keys the base file lacks (the Wan2.1 base has no vocal
            # projector or vocal k / v) come from the fine-tuned file, which
            # the merge below lays over the base anyway
            sd.update({k: v for k, v in override.items() if k not in sd})
        dit = ckpt.convert_dit(sd, dit_cfg)
        del sd
    else:
        dit = init_dit(_gen(device, 0), dit_cfg, device, bf16)
    if override is not None:
        # a fine-tuned .pt: non-strict, size-filtered merge
        dit = ckpt.merge_pt_override(dit, override, dit_cfg)
        del override
    sequential = memory_mode == "sequential_cpu_offload"
    if not sequential:
        dit = ckpt.to_device(dit, device, bf16)

    vae = (ckpt.to_device(ckpt.convert_vae(ckpt.load_torch_state_dict(found(VAE_FILE)), vae_cfg),
                          device, bf16)
           if found(VAE_FILE) else init_vae(_gen(device, 1), vae_cfg, device, bf16))
    clip = (ckpt.to_device(ckpt.convert_clip_visual(ckpt.load_torch_state_dict(found(CLIP_FILE)),
                                                    clip_cfg), device, bf16)
            if found(CLIP_FILE) else init_clip_visual(_gen(device, 3), clip_cfg, device, bf16))
    w2v, w2v_cfg = _wav2vec(args, w2v_cfg, device, _gen(device, 4))

    teacache = None
    if getattr(args, "enable_teacache", False):
        teacache = TeaCache(get_teacache_coefficients(f"wan2.1-t2v-{args.model_family.lower()}"),
                            args.sample_steps, rel_l1_thresh=args.teacache_threshold,
                            num_skip_start_steps=args.num_skip_start_steps)

    prep, quant, rope_split, attn_quant = resolve_fast_path(args)
    if sequential and prep:
        # the memory modes exclude one another: the prepared tree is what
        # sequential offload exists not to hold on the device
        print("[stableavatar] sequential_cpu_offload: skipping the fast-path preparation "
              "(bf16 host-streamed blocks)")
        prep, quant, rope_split, attn_quant = False, False, False, "none"
    if prep:
        dit = prepare_fast_params(dit, dit_cfg, quant=quant)
    # ring_degree > 1 makes the whole sp axis one ring (JAX CLI, :427-429)
    attn_impl = "ring" if getattr(args, "ring_degree", 1) > 1 else "ulysses"
    streamed = None
    if sequential:
        streamed = StreamedDiT(dit, dit_cfg, rope_split=rope_split, attn_quant=attn_quant,
                               attn_impl=attn_impl,
                               honor_vocal_k_lens=not getattr(args, "reference_attn_numerics", False),
                               device=device, dtype=bf16)
        dit = None  # the blocks live in pinned host memory now
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[stableavatar] sequential_cpu_offload: {streamed.num_layers} DiT blocks in host "
              f"memory, streamed two at a time ({_gib(device)})")

    return WanModels(
        dit_params=dit, dit_cfg=dit_cfg, vae_params=vae, vae_cfg=vae_cfg,
        t5_params=t5_params, t5_cfg=t5_cfg, clip_params=clip, clip_cfg=clip_cfg,
        wav2vec_params=w2v, wav2vec_cfg=w2v_cfg, tokenizer=tokenizer, teacache=teacache,
        rope_split=rope_split, attn_quant=attn_quant,
        honor_vocal_k_lens=not getattr(args, "reference_attn_numerics", False), attn_impl=attn_impl,
        device=device, text_ctx=text_ctx, streamed_dit=streamed)


def run_generation(args, models: WanModels, ref_image, waveform, text_ctx=None,
                   frame_sink=None, timer=None):
    """generate_long with the CLI's arguments: the call `main` makes, shared
    with chip_smoke.py."""
    return generate_long(
        models,
        ref_image=ref_image,
        vocal_waveform=waveform,
        text_ctx=text_ctx,
        prompt=args.validation_prompts,
        negative_prompt=args.negative_prompts,
        num_inference_steps=args.sample_steps,
        text_guide_scale=args.text_guide_scale,
        audio_guide_scale=args.audio_guide_scale,
        clip_length=args.clip_sample_n_frames,
        overlap_window_length=args.overlap_window_length,
        overlapping_weight_scheme=args.overlapping_weight_scheme,
        scheduler=args.sample_solver,
        solver_order=args.solver_order,
        solver_type=args.solver_type,
        fps=args.fps,
        sr=args.sample_rate,
        seed=args.seed,
        shift=args.sample_shift if args.sample_shift is not None else 5.0,
        color_correction_strength=args.color_correction_strength,
        frame_sink=frame_sink,
        timer=timer,
    )


def build_mesh(args, device):
    """The ('dp', 'fsdp', 'sp') mesh of the JAX CLI (:495-501): sp =
    ulysses x ring, fsdp = world // sp under --fsdp_dit when world >= 2 sp;
    None when both are 1.  The process group must be running for sp or
    fsdp above 1."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    sp = args.ulysses_degree * args.ring_degree
    fsdp = world // sp if args.fsdp_dit and world >= 2 * sp else 1
    if sp == 1 and fsdp == 1:
        return None
    if not dist.is_initialized():
        raise ValueError(f"--ulysses_degree x --ring_degree = {sp} needs {sp} processes "
                         "(torchrun, or --coordinator_address / --num_processes / --process_id)")
    return make_multihost_mesh(fsdp=fsdp, sp=sp, device_type=torch.device(device).type)


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    for path, what in [(args.validation_reference_path, "reference image"),
                       (args.validation_driven_audio_path, "driving audio")]:
        if not path or not os.path.exists(path):
            print(f"error: {what} not found: {path!r}", file=sys.stderr)
            return 2
    running = dist.is_initialized()
    initialize_distributed(args.coordinator_address, args.num_processes, args.process_id,
                           device=device)
    try:
        return _generate_and_write(args, device)
    finally:
        if dist.is_initialized() and not running:
            dist.destroy_process_group()


def _generate_and_write(args, device) -> int:
    from stableavatar_tpu_torch.utils.media import ffmpeg_available, load_image, load_wav, mux_audio
    from stableavatar_tpu_torch.utils.video_io import StreamingVideoWriter, save_videos_grid

    mesh = build_mesh(args, device)
    writer = not dist.is_initialized() or dist.get_rank() == 0
    t0 = time.time()
    models = load_models(args, device)
    print(f"[stableavatar] models loaded ({time.time() - t0:.0f}s)", flush=True)
    ref = load_image(args.validation_reference_path, (args.width, args.height))
    wav, _ = load_wav(args.validation_driven_audio_path, args.sample_rate)

    text_ctx = models.text_ctx  # encoded by the loader, T5 released
    if text_ctx is None and models.tokenizer is not None:
        text_ctx = encode_prompts(models, args.validation_prompts, args.negative_prompts)
        print(f"[stableavatar] prompt encoded ({time.time() - t0:.0f}s)", flush=True)

    out_path = os.path.join(args.output_dir, f"video_seed{args.seed}.mp4")
    sink_writer = None
    if writer:
        os.makedirs(args.output_dir, exist_ok=True)
        if args.stream_output:
            sink_writer = StreamingVideoWriter(out_path, fps=args.fps,
                                               audio_path=args.validation_driven_audio_path)
    with mesh_context(mesh):
        if mesh is not None:
            models.dit_params = shard_params(models.dit_params, mesh)
        out = run_generation(args, models, ref, wav, text_ctx,
                             frame_sink=sink_writer.append if sink_writer is not None else None)
    print(f"[stableavatar] generation done ({time.time() - t0:.0f}s)", flush=True)
    if not writer:
        return 0  # rank 0 writes the video

    if sink_writer is not None:
        out_path = sink_writer.close()
    else:
        out_path = save_videos_grid(out.videos, out_path, fps=args.fps) or out_path
    if sink_writer is not None and sink_writer.audio_muxed:
        pass  # ffmpeg muxed the audio while streaming
    elif not out_path.endswith(".mp4"):
        print("audio mux skipped: output is a frame directory, not an mp4")
    elif ffmpeg_available():
        try:
            muxed = out_path[: -len(".mp4")] + "_audio.mp4"
            mux_audio(out_path, args.validation_driven_audio_path, muxed)
            out_path = muxed
        except Exception as e:  # the video stands without audio
            print(f"audio mux skipped: {e}")
    print(f"saved {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
