"""Where the time of one Euler step, or of one train step, goes: the port's
generate_long or train_step on one H100.

Run from the repository root on a machine with one NVIDIA H100:

    python3 profile_window.py          # generate_long, fast and bf16 paths
    python3 profile_window.py train    # train_step, 1.3B / 512x512 / 81 frames
    python3 profile_window.py kernels  # the flash forward kernels, S3 and K5 alone
    python3 profile_window.py probes   # the GEMM probe (S1 / S2) beside cuBLAS
    python3 profile_window.py backward # the flash backward (K4) alone
    python3 profile_window.py forward  # the bf16 flash forward (K1, K1-LSE) alone
    python3 profile_window.py rope     # K1-rope, K1-rope-LSE and K4-rope
    python3 profile_window.py vae      # the VAE's bf16 decode and fp32 train encode
    python3 profile_window.py qkpv     # generate_long with attn_quant="qkpv" (K2v-qkpv)

It builds the random 1.3B / ViT-H / wav2vec2-base / VAE stack of
`chip_smoke.py` and runs `generate_long` on chip_smoke's inputs (512x512,
overlap 15, 2 windows of 21 latent frames, Euler, 6 steps, latents out, no
VAE decode) twice: on the fast path (W8A8 linears, int8-QK self-attention
K2, fused cross-attention K5) and on the bf16 path (unprepared params,
attn_quant="none": K1 for self- and cross-attention).  Per path it prints

- the wall seconds of each denoise step (synchronised `StepTimer`); steps
  0-3 run without the profiler, step 4 is its warm-up, step 5 is profiled;
- for the profiled step: its wall seconds, the summed device time of its
  kernels, and the device idle share bounded as 1 - kernel time / wall (the
  port launches on one stream, so its kernels do not overlap);
- the device time by kind of kernel (one JSON line) and the top device ops.

`train` runs 6 train steps (the train CLI's defaults: batch 1, remat,
AdamW) of the bf16 1.3B DiT on one batch of chip_smoke's synthetic 512x512,
81-frame data, encoded once before the timed steps; steps 0-3 unprofiled,
step 4 the profiler's warm-up, step 5 profiled; it also prints the peak
device memory of the steps.

`kernels` times the int8 flash kernels -- K2 ("qk"), K2v ("qkv", "qkpv" on
its default key block), K3 ("qk", "qkv") and K2-LSE ("qk", "qkv", "qkpv" on
the block of 1024) -- at the DiT self-attention shape [3, 21504, 12, 128]
(K2-LSE at one sample's [1, 21504, 12, 128]) on the same roped, prepared
operands, beside K1 and one SDPA call on the bf16 operands; the S3 dots
probe on the same operands laid out [36, 21504, 128] (bf16, and int8 on the
prepared q8 / k8); and K5 at [3, 21504, 12, 128] x (512, 257), and with
the image context cut to 256 keys (its ragged last tile's cost), beside
K1's text and image calls and two SDPA calls and their add: the median of
20 CUDA-event timings each, after a warm-up, as one JSON line.  It uses only wrapper arguments that every
version of the kernels takes, so the same file compares two checkouts in
one call (copy it into each and run it from there, in turns).

`probes` times `mm_probe` (S1 / S2: each epilogue) at the scripts'
[21504, 1536] . [1536, 1536] and the DiT's linears [21504, 1536] . [1536,
8960] and [21504, 8960] . [8960, 1536], beside `torch.matmul` (bf16) and
`torch._int_mm` (int8) given B column-major as cuBLAS takes it, and given
the same row-major B with the transpose inside the timed call: medians of
20 CUDA-event timings, one JSON line, comparable across two checkouts.

`backward` times the flash backward at the training shapes [1, 21504, 12,
128] with Lk 21504, 512 and 257 (self, text and image attention): the
whole `_flash_bwd_cuda` call (delta, buffers and casts included) and its
kernels alone -- the fused K4 where the checkout has it (`sa_flash_bwd`),
else K4a and K4b -- beside SDPA's backward: medians of 20 CUDA-event
timings, one JSON line.  It too
compares two checkouts in one call.

`forward` times K1 at [3, 21504, 12, 128] and K1-LSE at [1, 21504, 12,
128] against Lk 21504, 512 and 257 (self, text and image attention of
inference and training) through `_flash_fwd_cuda`, each beside one SDPA
call on the same inputs: medians of 20 CUDA-event timings, one JSON line,
comparable across two checkouts in one call.

`rope` times `flash_attention(rope=)` at [3, 21504, 12, 128] (K1-rope)
beside the dispatch `ops/attention.py` keeps (`rope_apply_split` and a cast
for q and k, then K1) and K1 alone, and at [1, 21504, 12, 128]
`flash_attention_with_stats(rope=)` (K1-rope-LSE) and one autograd step of
`flash_attention(rope=)` (K1-rope-LSE + K4-rope; K4-rope is the step less
K1-rope-LSE); where the checkout has the rotation pass
(`_rope_rotate_cuda`), that too: medians of 20 CUDA-event timings (10 for
the step), one JSON line.  Only the public entry points are timed, so the
same file compares two checkouts in one call.

`qkpv` profiles generate_long as the default run does, on the fast path
with attn_quant="qkpv" (K2v-qkpv for self-attention): the path of
chip_smoke's int8-variants phase.

`vae` times the pipelines' bf16 segmented VAE decode to uint8 frames
(`decode_video_segmented`, random bf16 weights) of chip_smoke's video -- 27
latent frames of 64x64 into 105 frames of 512x512 -- and a train step's
two fp32 encodes (`encode_video_sample`) of an 81-frame 512x512 clip: the
wall seconds of 4 synchronised runs each, one JSON line, comparable across
two checkouts.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

STEPS, WAIT, WARMUP = 6, 4, 1

# kernel name -> kind; first match wins
KINDS = (
    # the wgmma / TMA forward <D, QK, VM>: K1 (QK 0), K2 / K2-LSE (1), K3 (2);
    # V bf16 (VM 0, or no VM in older checkouts), widened V8 (1), s8 P.V (2)
    ("K2v / K2-LSE qkv, qkpv / K3-qkv flash_fwd (wgmma)",
     re.compile(r"ffwd::flash_fwd_kernel<\d+, [12], [12]>")),
    ("K2 / K2-LSE qk / K3-qk flash_fwd (wgmma)",
     re.compile(r"ffwd::flash_fwd_kernel<\d+, [12](, 0)?>")),
    ("K1 flash_fwd_bf16 (with or without LSE)",
     re.compile(r"flash_fwd_bf16_kernel|ffwd::flash_fwd_kernel<\d+, 0(, 0)?>")),
    # S3's dots: the template's QK 3 (bf16) and 4 (int8)
    ("S3 dots_probe (wgmma)", re.compile(r"ffwd::flash_fwd_kernel<\d+, [34], 0>")),
    # the mma.sync template of older checkouts: K2v / K3-qkv (and K2 / K3-qk)
    ("K2 / K2v / K2-LSE / K3 flash_fwd_int8 (mma.sync)",
     re.compile(r"flash_fwd_int8v?_kernel")),
    ("K4 flash_bwd (fused)", re.compile(r"flash_bwd_fused_kernel")),
    # K1-rope's and K4-rope's passes (rope.cu)
    ("rope_rotate (K1-rope, K4-rope)", re.compile(r"rope_rotate_kernel")),
    ("rope_finalize_bwd (K4-rope)", re.compile(r"rope_finalize_bwd_kernel")),
    # the mma.sync kernels of older checkouts: K4a / K4b and their rope branch
    ("K4a flash_bwd_dkdv", re.compile(r"flash_bwd_dkdv")),
    ("K4b flash_bwd_dq", re.compile(r"flash_bwd_dq")),
    # k5::dual_context_kernel<D> (wgmma), or the mma.sync kernel of older checkouts
    ("K5 dual_context", re.compile(r"dual_context_kernel")),
    ("SDPA (VAE attention)", re.compile(r"fmha|pytorch_flash|flash_fwd_kernel|attention", re.I)),
    ("GEMM (cuBLAS: bf16 and _int_mm)", re.compile(r"gemm|cutlass|xmma|nvjet|cublas", re.I)),
    ("memcpy / memset", re.compile(r"memcpy|memset", re.I)),
    ("PyTorch native (elementwise, reductions, copies)", re.compile(r"at::native|at::")),
)


def device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_path(tag, models):
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke
    from stableavatar_tpu_torch.pipelines.long import generate_long
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=WAIT, warmup=WARMUP, active=1, repeat=1)) as prof:
        # the timer has synchronised before the callback, so each profiler
        # step holds exactly one denoise step (step 0 also the conditioning)
        generate_long(models, num_inference_steps=STEPS, output_type="latent", timer=timer,
                      step_callback=lambda i, lat: prof.step(), **chip_smoke.pipeline_inputs(models))
    steps_s = timer.history["denoise_step"]
    print(f"{tag}: step seconds (2 windows) {steps_s}; unprofiled step 3: "
          f"{steps_s[3] / chip_smoke.N_WINDOWS} s per window-step", flush=True)
    report(tag, prof, steps_s[WAIT + WARMUP])


def profile_train(models, dit_bf16):
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke
    from stableavatar_tpu_torch.train.loop import encode_batch
    from stableavatar_tpu_torch.train.trainer import (
        TrainConfig, make_optimizer, train_sigmas, train_step)
    from stableavatar_tpu_torch.utils.profiling import StepTimer
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    cfg, tc = models.dit_cfg, TrainConfig()
    tmodels = dataclasses.replace(models, dit_params=dit_bf16, rope_split=False, attn_quant="none")
    enc = encode_batch(tmodels, next(chip_smoke.train_batches(1, cfg)),
                       np.random.default_rng(chip_smoke.TRAIN_SEED))
    clip_level = enc.pop("is_clip_level_modeling")
    tx = make_optimizer(tc)
    state = tx.init(tree_leaves(dit_bf16))
    gen = torch.Generator(device="cuda").manual_seed(0)
    sigmas = train_sigmas(device="cuda")
    timer = StepTimer("cuda")
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=WAIT, warmup=WARMUP, active=1, repeat=1)) as prof:
        for _ in range(STEPS):
            with timer.phase("train_step"):
                _, state, m = train_step(dit_bf16, state, enc, gen, clip_level, dit_cfg=cfg,
                                         train_cfg=tc, tx=tx, sigmas_table=sigmas)
            prof.step()
    steps_s = timer.history["train_step"]
    tag = f"train step (clip-level {clip_level})"
    print(f"{tag}: step seconds {steps_s}; loss {float(m['loss'])}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30} GiB", flush=True)
    report(tag, prof, steps_s[WAIT + WARMUP])


def report(tag, prof, wall):
    """Device time of the profiled step by kind of kernel, and the idle-share
    bound 1 - kernel time / wall."""
    from torch.autograd import DeviceType

    # the step's own annotation spans the device timeline too; it is no kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    busy = sum(device_us(e) for e in kernels) / 1e6
    kinds = {}
    for e in kernels:
        kind = next((k for k, rx in KINDS if rx.search(e.key)), "other")
        s, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (s + device_us(e) / 1e6, n + e.count)
    print(f"{tag}: profiled step wall {wall} s, device kernel time {busy} s, "
          f"device idle share at most {1 - busy / wall}", flush=True)
    print(json.dumps({"path": tag, "profiled_wall_s": wall, "kernel_s": busy,
                      "by_kind": {k: {"s": s, "launches": n} for k, (s, n) in
                                  sorted(kinds.items(), key=lambda kv: -kv[1][0])}}), flush=True)
    top = sorted(kernels, key=device_us, reverse=True)[:15]
    for e in top:
        print(f"  {device_us(e) / 1e6:9.4f} s {e.count:6d}x  {e.key[:110]}", flush=True)


def time_kernels():
    import torch

    import chip_smoke
    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops import probes
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, n, d = 3, 21504, 12, 128
    q, k, v = (torch.randn((b, l, n, d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    q8, k8, sqk = fa.prepare_int8(q, k, rope, d ** -0.5)
    v8, sv = fa.quantize_v(v)
    mstat = fa.static_bound(q8, k8, sqk)
    q8s, k8s, vs, sqks = q8[:1].contiguous(), k8[:1].contiguous(), v[:1].contiguous(), sqk[:n]
    v8s, svs = v8[:1].contiguous(), sv[:1].contiguous()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs = {
        "K2 qk": lambda: fa._flash_int8_cuda(q8, k8, v, sqk, None),
        "K2v qkv": lambda: fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant="qkv", sv=sv),
        "K2v qkpv": lambda: fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant="qkpv", sv=sv),
        "K3 qk": lambda: fa._flash_int8_cuda(q8, k8, v, sqk, None, mstat=mstat),
        "K3 qkv": lambda: fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant="qkv", sv=sv,
                                              mstat=mstat),
        "K2-LSE qk [1]": lambda: fa._flash_int8_cuda(q8s, k8s, vs, sqks, None, with_lse=True),
        "K2-LSE qkv [1]": lambda: fa._flash_int8_cuda(q8s, k8s, v8s, sqks, None, quant="qkv",
                                                      sv=svs, with_lse=True),
        "K2-LSE qkpv [1]": lambda: fa._flash_int8_cuda(q8s, k8s, v8s, sqks, None, quant="qkpv",
                                                       sv=svs, with_lse=True,
                                                       pv_block=fa.STATS_BLOCK_K),
        "K1": lambda: fa._flash_fwd_cuda(q, k, v, None, d ** -0.5),
        "SDPA": lambda: sdpa(qt, kt, vt),
    }
    # S3 (the dots probe) on the same work, [36, 21504, 128]: each kernel's
    # time less S3's is its softmax's share
    qd, kd, vd = (x.transpose(1, 2).reshape(b * n, l, d).contiguous() for x in (q, k, v))
    q8d, k8d = (x.transpose(1, 2).reshape(b * n, l, d).contiguous() for x in (q8, k8))
    runs["S3 bf16"] = lambda: probes.dots_probe(qd, kd, vd)
    runs["S3 int8"] = lambda: probes.dots_probe(q8d, k8d, vd, int8=True)
    # K5 at the DiT cross-attention shape, beside K1's text and image calls
    # and two SDPA calls and their add
    k1, v1, k2, v2 = (torch.randn((b, lk, n, d), generator=gen, device="cuda").bfloat16()
                      for lk in (512, 512, 257, 257))
    runs["K5"] = lambda: ca._dual_cuda(q, k1, v1, k2, v2, d ** -0.5)
    # the image context's ragged last tile (257 = 2 x 128 + 1): K5 on its
    # first 256 keys
    k2w, v2w = k2[:, :256].contiguous(), v2[:, :256].contiguous()
    runs["K5, image 256 keys"] = lambda: ca._dual_cuda(q, k1, v1, k2w, v2w, d ** -0.5)
    runs["K1 text"] = lambda: fa._flash_fwd_cuda(q, k1, v1, None, d ** -0.5)
    runs["K1 image"] = lambda: fa._flash_fwd_cuda(q, k2, v2, None, d ** -0.5)
    c1, c2 = ((x.transpose(1, 2), y.transpose(1, 2)) for x, y in ((k1, v1), (k2, v2)))
    runs["SDPA text + image + add"] = lambda: sdpa(qt, *c1) + sdpa(qt, *c2)
    print(json.dumps({name: round(chip_smoke.time_ms(fn, 20), 3) for name, fn in runs.items()}),
          flush=True)


def time_probes():
    import torch

    import chip_smoke
    from stableavatar_tpu_torch.ops import probes

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for m, k, n in ((21504, 1536, 1536), (21504, 1536, 8960), (21504, 8960, 1536)):
        a16 = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b16 = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        a8, b8 = ((x.float() * 10).to(torch.int8) for x in (a16, b16))
        b8_cm = b8.t().contiguous().t()  # column-major, as cuBLAS's int8 product takes it
        row = {f"mm_probe_{epi}_ms": chip_smoke.time_ms(
            lambda: probes.mm_probe(*((a16, b16) if epi == "bf16" else (a8, b8)), epi), 20)
            for epi in probes.EPILOGUES}
        row["matmul_bf16_ms"] = chip_smoke.time_ms(lambda: torch.matmul(a16, b16), 20)
        row["int_mm_ms"] = chip_smoke.time_ms(lambda: torch._int_mm(a8, b8_cm), 20)
        row["int_mm_with_transpose_ms"] = chip_smoke.time_ms(
            lambda: torch._int_mm(a8, b8.t().contiguous().t()), 20)
        res[f"[{m}, {k}] . [{k}, {n}]"] = row
        del a16, b16, a8, b8, b8_cm
    print(json.dumps(res), flush=True)


def time_backward():
    import torch

    import chip_smoke
    from stableavatar_tpu_torch.ops import cuda_lib
    from stableavatar_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    fused = "sa_flash_bwd" in cuda_lib.SIGNATURES
    res = {"k4": "fused" if fused else "K4a + K4b"}
    lq, n, d = 21504, 12, 128
    scale = d ** -0.5
    for lk in (21504, 512, 257):
        q, g = rand(1, lq, n, d), rand(1, lq, n, d)
        k, v = rand(1, lk, n, d), rand(1, lk, n, d)
        out, lse = fa._flash_fwd_cuda(q, k, v, None, scale, with_lse=True)
        row = {"whole_ms": chip_smoke.time_ms(
            lambda: fa._flash_bwd_cuda(q, k, v, None, out, lse, g, scale), 20)}
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), None]
        scales = (float(scale), float(scale * fa.LOG2E))
        if fused:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits = fa.bwd_splits(n, lq, lk, sms)
            acc = torch.zeros((1, lq, n, d), dtype=torch.float32, device="cuda")
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            part = [torch.empty((splits, 1, lk, n, d), dtype=torch.float32, device="cuda")
                    for _ in range(2)] if splits > 1 else None
            outs = ([None, None, part[0].data_ptr(), part[1].data_ptr()] if part else
                    [dk.data_ptr(), dv.data_ptr(), None, None])
            row["k4_ms"] = chip_smoke.time_ms(lambda: cuda_lib.launch(
                "sa_flash_bwd", *args, acc.data_ptr(), *outs, 1, lq, lk, n, d, splits,
                *scales), 20)
            row["query_splits"] = splits
        else:
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            dims = (1, lq, lk, n, d, *scales)
            row["k4a_ms"] = chip_smoke.time_ms(lambda: cuda_lib.launch(
                "sa_flash_bwd_dkdv", *args, dk.data_ptr(), dv.data_ptr(), *dims), 20)
            row["k4b_ms"] = chip_smoke.time_ms(lambda: cuda_lib.launch(
                "sa_flash_bwd_dq", *args, dq.data_ptr(), *dims), 20)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        gt = g.transpose(1, 2)
        row["sdpa_bwd_ms"] = chip_smoke.time_ms(
            lambda: torch.autograd.grad(o, (qt, kt, vt), gt, retain_graph=True), 20)
        res[f"lk_{lk}"] = row
        del q, g, k, v, out, lse, delta, qt, kt, vt, o
    print(json.dumps(res), flush=True)


def time_forward():
    import torch

    import chip_smoke
    from stableavatar_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    lq, n, d = 21504, 12, 128
    scale = d ** -0.5
    res = {}
    for name, b, with_lse in (("K1", 3, False), ("K1-LSE", 1, True)):
        for lk in (21504, 512, 257):
            q, k, v = rand(b, lq, n, d), rand(b, lk, n, d), rand(b, lk, n, d)
            row = {"ms": chip_smoke.time_ms(
                lambda: fa._flash_fwd_cuda(q, k, v, None, scale, with_lse=with_lse), 20)}
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["sdpa_ms"] = chip_smoke.time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 20)
            res[f"{name} [{b}, {lq}, {n}, {d}] x Lk {lk}"] = row
            del q, k, v, qt, kt, vt
    print(json.dumps(res), flush=True)


def time_rope():
    import torch

    import chip_smoke
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_apply_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    lq, n, d = 21504, 12, 128
    scale = d ** -0.5
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    rotate = getattr(fa, "_rope_rotate_cuda", None)
    res = {}
    with torch.no_grad():
        q, k, v = rand(3, lq, n, d), rand(3, lq, n, d), rand(3, lq, n, d)
        tag = f"[3, {lq}, {n}, {d}]"
        res[f"K1-rope {tag}"] = chip_smoke.time_ms(
            lambda: fa.flash_attention(q, k, v, rope=rope), 20)
        res[f"rope_apply_split x 2 + K1 {tag}"] = chip_smoke.time_ms(
            lambda: fa._flash_fwd_cuda(rope_apply_split(q, rope).to(bf16),
                                       rope_apply_split(k, rope).to(bf16), v, None, scale), 20)
        res[f"K1 {tag}"] = chip_smoke.time_ms(
            lambda: fa._flash_fwd_cuda(q, k, v, None, scale), 20)
        if rotate is not None:
            res[f"rope_rotate {tag}"] = chip_smoke.time_ms(lambda: rotate(q, k, rope), 20)
        del q, k, v
        q, k, v, g = (rand(1, lq, n, d) for _ in range(4))
        tag = f"[1, {lq}, {n}, {d}]"
        res[f"K1-rope-LSE {tag}"] = chip_smoke.time_ms(
            lambda: fa.flash_attention_with_stats(q, k, v, rope=rope), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def step():
        torch.autograd.grad(fa.flash_attention(qg, kg, vg, rope=rope), (qg, kg, vg), g)

    res[f"K1-rope-LSE + K4-rope, autograd {tag}"] = chip_smoke.time_ms(step, 10)
    res[f"K4-rope {tag} (the step less K1-rope-LSE)"] = (
        res[f"K1-rope-LSE + K4-rope, autograd {tag}"] - res[f"K1-rope-LSE {tag}"])
    print(json.dumps(res), flush=True)


def time_vae():
    import torch

    from stableavatar_tpu_torch.config import VAEConfig
    from stableavatar_tpu_torch.models.vae import (
        decode_video_segmented, encode_video_sample, init_vae)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = VAEConfig()
    params = init_vae(gen, cfg, "cuda", torch.bfloat16)

    def walls(fn, reps=4):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    # chip_smoke's 2 windows at 512x512: 27 latent frames into 105 frames
    z = torch.randn((1, cfg.z_dim, 27, 64, 64), generator=gen, device="cuda").bfloat16()
    res = {"decode_bf16_s": walls(lambda: decode_video_segmented(params, z, cfg, out_uint8=True))}
    del z
    # a train step's two encodes of an 81-frame 512x512 clip (fp32 pixels)
    video = torch.rand((1, 3, 81, 512, 512), generator=gen, device="cuda") * 2 - 1
    res["train_encode_fp32_s"] = walls(lambda: [encode_video_sample(
        params, video, cfg, generator=gen) for _ in range(2)])
    print(json.dumps(res), flush=True)


def main() -> int:
    try:
        import torch

        import chip_smoke
    except ImportError as e:
        print(f"profile_window: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("profile_window: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if sys.argv[1:] == ["kernels"]:
        time_kernels()
        return 0
    if sys.argv[1:] == ["probes"]:
        time_probes()
        return 0
    if sys.argv[1:] == ["backward"]:
        time_backward()
        return 0
    if sys.argv[1:] == ["forward"]:
        time_forward()
        return 0
    if sys.argv[1:] == ["vae"]:
        time_vae()
        return 0
    if sys.argv[1:] == ["rope"]:
        time_rope()
        return 0
    models, dit_bf16 = chip_smoke.build_models("cuda")
    if sys.argv[1:] == ["qkpv"]:
        profile_path("qkpv (W8A8 + K2v-qkpv + K5)",
                     dataclasses.replace(models, attn_quant="qkpv"))
        return 0
    if sys.argv[1:] == ["train"]:
        profile_train(models, dit_bf16)
        return 0
    profile_path("fast (W8A8 + K2 + K5)", models)
    profile_path("bf16 (K1)", dataclasses.replace(
        models, dit_params=dit_bf16, rope_split=False, attn_quant="none"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
