"""Where the time of one Euler step goes: the port's generate_long on one H100.

Run from the repository root on a machine with one NVIDIA H100:

    python3 profile_window.py

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
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys

STEPS, WAIT, WARMUP = 6, 4, 1

# kernel name -> kind; first match wins
KINDS = (
    ("K2 flash_fwd_int8_qk", re.compile(r"flash_fwd_int8_qk_kernel")),
    ("K1 flash_fwd_bf16", re.compile(r"flash_fwd_bf16_kernel")),
    ("K5 dual_context", re.compile(r"dual_context_kernel")),
    ("SDPA (short-query attention)", re.compile(r"fmha|pytorch_flash|flash_fwd_kernel|attention", re.I)),
    ("GEMM (cuBLAS: bf16 and _int_mm)", re.compile(r"gemm|cutlass|xmma|nvjet|cublas", re.I)),
    ("memcpy / memset", re.compile(r"memcpy|memset", re.I)),
    ("PyTorch native (elementwise, reductions, copies)", re.compile(r"at::native|at::")),
)


def device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_path(tag, models):
    import torch
    from torch.autograd import DeviceType
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
    wall = steps_s[WAIT + WARMUP]
    # the step's own annotation spans the device timeline too; it is no kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    busy = sum(device_us(e) for e in kernels) / 1e6
    kinds = {}
    for e in kernels:
        kind = next((k for k, rx in KINDS if rx.search(e.key)), "other")
        s, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (s + device_us(e) / 1e6, n + e.count)
    print(f"{tag}: step seconds (2 windows) {steps_s}; unprofiled step 3: "
          f"{steps_s[3] / chip_smoke.N_WINDOWS} s per window-step", flush=True)
    print(f"{tag}: profiled step wall {wall} s, device kernel time {busy} s, "
          f"device idle share at most {1 - busy / wall}", flush=True)
    print(json.dumps({"path": tag, "profiled_wall_s": wall, "kernel_s": busy,
                      "by_kind": {k: {"s": s, "launches": n} for k, (s, n) in
                                  sorted(kinds.items(), key=lambda kv: -kv[1][0])}}), flush=True)
    top = sorted(kernels, key=device_us, reverse=True)[:15]
    for e in top:
        print(f"  {device_us(e) / 1e6:9.4f} s {e.count:6d}x  {e.key[:110]}", flush=True)


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
    models, dit_bf16 = chip_smoke.build_models("cuda")
    profile_path("fast (W8A8 + K2 + K5)", models)
    profile_path("bf16 (K1)", dataclasses.replace(
        models, dit_params=dit_bf16, rope_split=False, attn_quant="none"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
