"""Chip smoke test of the PyTorch/CUDA port (`stableavatar_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check raises and the script
exits non-zero):

1. device   -- require CUDA, print the card's name and power limit, build the
               hand-written kernels from csrc/, print the build seconds and
               ptxas's report (registers, spills, warnings), and fail on a
               spill in any wgmma forward, K5 or fused K4 instance or in
               the rope and GELU passes;
2. kernels  -- K1 (bf16 flash), K2 (int8-QK flash), K2v (int8 V: "qkv",
               "qkpv"), K3 (static-bound softmax, "qk" and "qkv", with its
               LSE and the count of rows whose sum underflows), K5
               (dual-context cross-attention, beside K1's text and image
               calls and two SDPA calls and their add, and at its tile
               edges at D 64 and 128), K1 with its LSE output and
               the fused K4 backward (dQ, dK, dV in one pass) against their plain
               PyTorch versions at the main-path shapes (K1, K1-LSE and K4
               also at the cross-attention shapes, Lk 512 and 257) and on
               small ragged cases (every int8 instance -- K2, K2v qkv /
               qkpv, K2-LSE, K3 -- also at the wgmma kernel's tile edges:
               Lq and Lk apart and no multiples of 128, k_lens inside a
               tile and 0, D 64 and 128, qkpv also on key blocks of 64 and
               192 that split its tiles), with
               times, the least time the card could take (bound) and, where
               one PyTorch call computes the same function, that call's
               time;
3. reference -- the fast-path DiT (2 blocks, full width) on a small window:
               the card's output against the CPU's (plain versions);
4. train reference -- one train step of the bf16 DiT (2 blocks, full width)
               on a small window: the card's loss and gradients against the
               CPU's;
5. pipeline -- the port's generate_long at the full width of WAN_1_3B,
               512x512, Euler, overlap 15, 2 windows, 2 steps, random seeded
               weights on the W8A8 / int8-QK fast path; checks the video and
               the K2/K5 launch counts;
6. bf16     -- one dit_forward window on unprepared bf16 params
               (attn_quant="none"): 90 K1 launches, and one launch of the
               FFN's GELU pass (`sa_gelu_tanh`) for each of the 30 blocks,
               the text embedding and the 2 vocal projector blocks;
7. cli      -- the inference CLI's path: real flags through `build_parser`
               (--fast_path linears, DPM++ order 2, TeaCache), `load_models`
               with umT5-xxl at full width on the card (prompts encoded,
               then T5 released), and the CLI's own `run_generation` at
               512x512 over 2 windows with the static-bound softmax on
               (K3): the text context, the video, the TeaCache skips and the
               exact K3 / K5 launch counts (file I/O left out);
8. int8 variants -- generate_long with attn_quant="qkpv" and UniPC (K2v-qkpv,
               120 launches), and one dit_forward window each with "qkv" (K2v)
               and "qkv" + the static bound (K3), each against the same run on
               K1;
9. train    -- the port's train() for 3 steps at the full width of WAN_1_3B,
               512x512, 81 frames, batch 1, remat, AdamW (the train CLI's
               defaults), one step in clip-level mode; checks finite losses,
               changed parameters, a checkpoint written and resumed at step
               3, the train step time, the exact K1-LSE / K4 launch counts
               and at least two GELU passes (`sa_gelu_tanh`, forward and
               remat) and one GELU backward a block a step;
9b. optimizers -- the same train() route for 3 steps with 8-bit Adam, then 3
               with CAME: phase 9's checks, each step's launches equal to
               AdamW's, the peak device memory beside AdamW's and beside
               `cli/train.py:train_bytes`, the checkpoint at step 3
               restored on the card bit for bit (parameters and optimizer
               state); a tiny-config fp32 train step of each, card against
               CPU (TF32 off, rel-L2 1e-5); the optimizer update alone
               (`tx.update`, CUDA events) of AdamW, 8-bit Adam and CAME at
               1.3B;
10. ring    -- multi-GPU inference's pieces that one card holds: K2-LSE (the
               int8 kernels' LSE output, "qk", "qkv", "qkpv") against its
               plain version at the DiT self-attention shape and at the
               4-rank ring slice, K2v-qkpv on the JAX package's key blocks of
               1536 and 1024, the ring's merge of 4 K1-LSE / K2-LSE partials
               of query slice 0 against K1 / K2 over all 21,504 keys, and the
               multi-GPU path itself on one rank: `initialize_distributed`
               (NCCL) + `make_mesh` + `ring_attention` in each V mode, which
               launches K2-LSE.  Collectives between ranks need two cards
               (NCCL puts one rank on a card); the CPU tests hold them with
               gloo (tests/test_torch_parallel.py).

11. remaining -- the entry points of the last kernels: K1-rope (with and
               without its LSE) and K4-rope against their plain versions
               and, bit for bit, against the same functions with the
               rotation or the inverse rotation done by PyTorch; the rope
               passes (`rope_rotate`, `rope_finalize_bwd`) exactly against
               their plain versions, with their byte bounds;
               the probes S1-S3 (`ops/probes.py`: the GEMM's four epilogues
               at the scripts' shape and the DiT's linears, int8 outputs
               exactly, with torch.matmul / torch._int_mm as yardsticks,
               _int_mm also with B turned inside the call, and the dots
               probes beside K1 / K2 / K2v: each kernel's time beyond its
               two products); the FFN's tanh-GELU pass and its
               backward (`sa_gelu_tanh`, `sa_gelu_tanh_bwd`,
               csrc/elementwise.cu) exactly against the composition and
               autograd through it at the fc1 products of 1.3B and 14B,
               timed beside the byte bound, the composition and PyTorch's
               one-pass `F.gelu(approximate="tanh")`; then
               `flash_attention(rope=)` forward, with stats and under
               autograd, and each probe script's `main` with its own CH
               (`stableavatar_tpu_torch/scripts/`), each with exact launch
               counts.

12. single_clip -- generate_single_clip at WAN_1_3B, 512x512, 81 frames,
               random seeded weights: the fast path with 2 Euler steps (K2
               and K5 30 launches a step), one bf16 step (90 K1), and the
               training loop's log_validation (one bf16 step, the clip
               written to a temp dir); the videos (1, 3, 81, 512, 512),
               finite, in [0, 1];
13. checkpoints -- the random 1.3B DiT written in Wan's layout as an fp32
               `diffusion_pytorch_model.safetensors`, a StableAvatar `.pt`
               override and an HF wav2vec2 directory (the port's exporters,
               a temp dir deleted afterwards), read back with their GB/s,
               then `load_models` with --pretrained_model_name_or_path,
               --transformer_path and --pretrained_wav2vec_path: the loaded
               trees equal the written ones bit for bit, and one Euler
               window-step of generate_long on them equals the same step on
               the in-memory trees bit for bit;
14. 14B     -- K1, K2 and K5 against their plain versions at WAN_14B's
               [3, 21504, 40, 128] (time, bound, SDPA for K1); `load_models`
               with --model_family 14B (umT5-xxl encoded on the card and
               released before the DiT loads), one window-step with
               --fast_path linears (40 K2, 40 K5) and one bf16 (120 K1), with
               their peak device memory;
15. sequential -- the same 14B bf16 window-step with --GPU_memory_mode
               sequential_cpu_offload (the 40 blocks in pinned host memory,
               streamed two at a time): its latents equal phase 14's bit for
               bit, its peak device memory beside the resident run's and far
               below it, the blocks' H2D GB/s, and whether the copies hide
               behind compute.
16. train CLI -- `cli/train.py:main` at WAN_1_3B, 512x512, 81 frames,
               batch 1, AdamW and remat, random seeded weights, umT5-xxl
               resident on the card: 3 steps from a clip directory that the
               phase writes (81 PNGs, face and lip masks, a 16 kHz wav) read
               by 2 decode threads, a checkpoint at step 3, a validation clip
               (20 bf16 steps, PNG frames); finite losses and gradient norms,
               moved parameters, the files, exact K1-LSE / K4 / K1 launch
               counts, and the load, step, loader-wait, memory, checkpoint and
               validation times.  Runs after phase 13, before 14.
17. app     -- the serving app (`cli/app.py`) at WAN_1_3B, 512x512, random
               seeded weights: `build_app_parser` flags (--fast_path
               linears), `load_models` with umT5-xxl kept on the card,
               `AvatarService`, `build_ui` and `launch` on 127.0.0.1; over
               HTTP the page, /mcp/tools, request A (POST /api/Generate 生成:
               euler, 2 steps, seed 7, 2 windows at clip 81 / overlap 15)
               and the Separate tab (its HPSS tier here); request B through
               `AvatarService.generate` (unipc, 2 steps, TeaCache 0.1,
               streamed); each request's wall, window-step and exact K2 / K5
               launches, the videos (1, 3, 105, 512, 512) read back, the
               seeds and the peak memory with umT5-xxl resident;
18. tools   -- the ONNX runner with a graph of MDX-Net's topology at
               Kim_Vocal_2's geometry (seeded random weights) through
               `mdx_separate_waveform` on a 30 s stereo track, card against
               CPU; `device_trace` around one fast window-step (the trace
               names the flash and dual-context kernels); the host scripts'
               mains: `bench_decode_overlap` (monolithic against overlapped,
               frames equal), `bench_dit_step base full`,
               `profile_step_parts` and `quality_curves --small` (depth
               QUALITY_LAYERS), with exact launch counts.  Run last.

Phases 5-6, 7, 8, 9, 9b, 10's one-rank ring, 11's entry points and 12-18 drive
the paths: the launch counts are set to 0 just before each and read just
after.  The line before the last is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# relative L2 and max-abs error limits of a kernel against its plain version
# (bf16 outputs; the two differ by summation order and bf16 rounding of P)
REL_TOL = 1e-2
ABS_TOL = 6e-2
# K1's LSE (fp32 row statistics): max-abs limit against the plain version
LSE_TOL = 1e-3
# K4's gradients: rel-L2 only (dS mixes signs, so max-abs scales with |dO|)
GRAD_REL_TOL = 1e-2
# int8 ring partials against one int8 attention over all keys: each chunk
# is quantised on its own slab scales, so the two differ at the int8 level;
# K2's own tolerance (relative error 2e-2, tests/test_fastpath.py:115)
RING_INT8_REL_TOL = 2e-2

# published dense peaks of one H100 SXM at 700 W, and its memory rate
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_S = 3.35e12

KERNEL_SOURCES = {
    "flash_fwd_bf16": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                       "stableavatar_tpu/ops/flash_attention.py:217"),
    "flash_fwd_int8_qk": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                          "stableavatar_tpu/ops/flash_attention.py:548"),
    "dual_context": ("stableavatar_tpu_torch/csrc/cross_attention.cu",
                     "stableavatar_tpu/ops/cross_attention.py:112"),
    "flash_fwd_bf16_lse": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                           "stableavatar_tpu/ops/flash_attention.py:217"),
    # the fused K4: both Pallas calls of _flash_bwd_impl (:905 dK/dV, :941 dQ)
    "flash_bwd": ("stableavatar_tpu_torch/csrc/flash_attention_bwd.cu",
                  "stableavatar_tpu/ops/flash_attention.py:905"),
    "flash_fwd_int8_qkv": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                           "stableavatar_tpu/ops/flash_attention.py:382"),
    "flash_fwd_int8_qkpv": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                            "stableavatar_tpu/ops/flash_attention.py:369"),
    "flash_fwd_int8_static_qk": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                                 "stableavatar_tpu/ops/flash_attention.py:416"),
    "flash_fwd_int8_static_qkv": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                                  "stableavatar_tpu/ops/flash_attention.py:416"),
    # K2-LSE: _flash_int8_impl(with_lse=True), reached from
    # flash_attention_with_stats
    "flash_fwd_int8_qk_lse": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                              "stableavatar_tpu/ops/flash_attention.py:1073"),
    "flash_fwd_int8_qkv_lse": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                               "stableavatar_tpu/ops/flash_attention.py:1073"),
    "flash_fwd_int8_qkpv_lse": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                                "stableavatar_tpu/ops/flash_attention.py:1073"),
    # K1-rope: `_fwd_body`'s rope branch (`_rot` at :142-143), reached from
    # flash_attention(rope=) / flash_attention_with_stats(rope=): the
    # rotation pass, then K1 on the rotated copies (its row's source)
    "flash_fwd_bf16_rope": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                            "stableavatar_tpu/ops/flash_attention.py:142"),
    "flash_fwd_bf16_rope_lse": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                                "stableavatar_tpu/ops/flash_attention.py:142"),
    # K4-rope: the rope branches of both backward bodies (`_rot` at :731 /
    # :804, `_rot_inv` at :771 / :837): the fused K4, then the finalize pass
    "flash_bwd_rope": ("stableavatar_tpu_torch/csrc/flash_attention_bwd.cu",
                       "stableavatar_tpu/ops/flash_attention.py:731"),
    # the two passes of rope.cu: `_rot` (:87) and `_rot_inv` (:96)
    "rope_rotate": ("stableavatar_tpu_torch/csrc/rope.cu",
                    "stableavatar_tpu/ops/flash_attention.py:87"),
    "rope_finalize_bwd": ("stableavatar_tpu_torch/csrc/rope.cu",
                          "stableavatar_tpu/ops/flash_attention.py:96"),
    # S1-S3, the probe scripts' Pallas kernels
    "mm_probe_bf16": ("stableavatar_tpu_torch/csrc/probes.cu",
                      "scripts/microbench_pallas_int8.py:19"),
    "mm_probe_int8": ("stableavatar_tpu_torch/csrc/probes.cu",
                      "scripts/microbench_pallas_int8.py:19"),
    "mm_probe_requant": ("stableavatar_tpu_torch/csrc/probes.cu",
                         "scripts/microbench_pallas_int8_variants.py:55"),
    "mm_probe_scaled": ("stableavatar_tpu_torch/csrc/probes.cu",
                        "scripts/microbench_pallas_int8_variants.py:64"),
    # S3: two instances of the forward template
    "dots_probe_bf16": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                        "scripts/bench_attn_blocks.py:61"),
    "dots_probe_int8": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                        "scripts/bench_attn_blocks.py:119"),
    # the FFN's tanh-GELU pass and its backward: no TPU kernel (XLA fuses the chain)
    "gelu_tanh": ("stableavatar_tpu_torch/csrc/elementwise.cu", "—"),
    "gelu_tanh_bwd": ("stableavatar_tpu_torch/csrc/elementwise.cu", "—"),
}
# the kernels whose ptxas report must show no spill
NO_SPILL_KERNELS = ("flash_fwd_kernel", "dual_context_kernel", "flash_bwd_fused_kernel",
                    "rope_rotate_kernel", "rope_finalize_bwd_kernel", "gelu_tanh_kernel",
                    "gelu_tanh_bwd_kernel")
INFERENCE_KERNELS = ("flash_fwd_bf16", "flash_fwd_int8_qk", "dual_context")
CLI_KERNELS = ("flash_fwd_int8_static_qk",)
VARIANT_KERNELS = ("flash_fwd_int8_qkv", "flash_fwd_int8_qkpv", "flash_fwd_int8_static_qkv")
TRAIN_KERNELS = ("flash_fwd_bf16_lse", "flash_bwd")
RING_KERNELS = ("flash_fwd_int8_qk_lse", "flash_fwd_int8_qkv_lse", "flash_fwd_int8_qkpv_lse")


def bound_ms(ops_bf16: float, nbytes: float, ops_int8: float = 0.0):
    """The least time the card could take: the larger of the operations over
    the dense peaks and the bytes (each input read once, each output written
    once) over the memory rate.  Returns (ms, "operations" or "bytes")."""
    t_ops = ops_bf16 / PEAK_BF16 + ops_int8 / PEAK_INT8
    t_bytes = nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def compare(name: str, got, want, rel_tol: float = REL_TOL) -> float:
    """Raise unless rel-L2 <= rel_tol and max-abs <= ABS_TOL; return max-abs."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    mx = float((g - w).abs().max())
    log(f"  {name}: rel_l2={rel:.3e} max_abs={mx:.3e}")
    if not (rel <= rel_tol and mx <= ABS_TOL):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(rel_l2 {rel:.3e} > {rel_tol} or max_abs {mx:.3e} > {ABS_TOL})"
        )
    return mx


CARD = ["unknown"]  # the card's name and power limit, as nvidia-smi reports them


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port has no CPU run here")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # name, power limit: exactly as nvidia-smi prints them
    CARD[0] = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from stableavatar_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {path}")
    spilled, function = [], ""
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Function properties for" in line:
            function = line.split("for", 1)[1].strip()
            log(f"  ptxas: {function[:60]}")
        elif "registers" in line or "spill" in line or "warning" in line:
            log(f"  ptxas:   {line.replace('ptxas info    :', '').strip()}")
            if (any(k in function for k in NO_SPILL_KERNELS)
                    and " 0 bytes spill stores, 0 bytes spill loads" not in line
                    and "spill" in line):
                spilled.append(function)
    if spilled:
        raise AssertionError(f"ptxas spilled in the wgmma kernels: {spilled}")


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def fwd_shape_entry(q, k, v, with_lse: bool, library_ms: float) -> dict:
    """K1 (or K1-LSE) at a cross-attention shape, timed beside its plain
    version: an entry of the kernel's "shapes", with the query rows a block
    owns and the key tiles it sweeps (Lk 257 pads to three tiles of 128)."""
    from stableavatar_tpu_torch.ops import flash_attention as fa

    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5
    ms = time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale, with_lse=with_lse), 5)
    plain = time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, scale, with_lse=with_lse), 3)
    # q, k, v in and out, bf16; the fp32 LSE out
    bound = bound_ms(4.0 * b * n * lq * lk * d,
                     2.0 * b * n * d * (2 * lq + 2 * lk) + (4.0 * b * n * lq if with_lse else 0))
    tiles = -(-lk // fa.FWD_BLOCK_KEYS)
    name = "flash_fwd_bf16_lse" if with_lse else "flash_fwd_bf16"
    log(f"  {name} [{b},{lq},{n},{d}] x Lk {lk}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"bound {bound[0]:.3f} ms ({bound[1]}), library {library_ms:.3f} ms "
        f"({fa.FWD_BLOCK_Q} query rows a block, {tiles} key tiles)")
    return dict(shape=[b, lq, lk, n, d], ms=ms, plain_ms=plain, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms, query_rows_per_block=fa.FWD_BLOCK_Q,
                key_tiles=tiles)


def phase_kernels(results):
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def record(name, shape_tag, err, ms, plain_ms, bound=None, library_ms=None):
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if ms is not None:
            entry["ms"], entry["plain_ms"] = ms, plain_ms
            entry["bound_ms"], entry["bound_by"] = bound
            entry["library_ms"] = library_ms
            lib = ", library —" if library_ms is None else f", library {library_ms:.3f} ms"
            log(f"  {name} {shape_tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"bound {bound[0]:.3f} ms ({bound[1]}){lib}")


    def sdpa_ms(q, k, v, backward=False):
        """The yardstick: one PyTorch SDPA call on [B, N, L, D] views of the
        same inputs (forward, or its autograd backward)."""
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if not backward:
            return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 5)
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        g = torch.ones_like(out)
        return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True), 5)

    # K2 and K1 at the DiT self-attention shape: [3, 21504, 12, 128]
    b, l, n, d = 3, 21 * 32 * 32, 12, 128
    fwd_ops = 4.0 * b * n * l * l * d
    io_bytes = 2.0 * 4 * b * l * n * d  # q, k, v in, out, bf16
    q, k, v = (_rand(gen, (b, l, n, d), bf16) for _ in range(3))
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    scale = d ** -0.5
    q8, k8, sqk = fa.prepare_int8(q, k, rope, scale)
    got = fa._flash_int8_cuda(q8, k8, v, sqk, None)
    want = fa._flash_int8_plain(q8, k8, v, sqk)
    err = compare("flash_fwd_int8_qk [3,21504,12,128] rope", got, want)
    record("flash_fwd_int8_qk", "main", err,
           time_ms(lambda: fa._flash_int8_cuda(q8, k8, v, sqk, None), 5),
           time_ms(lambda: fa._flash_int8_plain(q8, k8, v, sqk), 3),
           # int8 Q.K^T, bf16 P.V; q8/k8 1 byte, v/out 2 bytes
           bound_ms(fwd_ops / 2, b * l * n * d * (1 + 1 + 2 + 2.0), ops_int8=fwd_ops / 2))
    phase_kernels_int8(record, q8, k8, v, sqk, (b, l, n, d), fwd_ops)
    del got, want

    got = fa._flash_fwd_cuda(q, k, v, None, scale)
    want = fa._flash_fwd_plain(q, k, v, None, scale)
    err = compare("flash_fwd_bf16 [3,21504,12,128]", got, want)
    record("flash_fwd_bf16", "main", err,
           time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale), 5),
           time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, scale), 3),
           bound_ms(fwd_ops, io_bytes), sdpa_ms(q, k, v))
    del got, want
    log_softmax_shares(results, q, k, v, q8, k8)
    del q8, k8
    # K1 at the DiT cross-attention shapes: text 512 and image 257 keys
    for lk in (512, 257):
        kc, vc = (_rand(gen, (b, lk, n, d), bf16) for _ in range(2))
        tag = f"[3,21504,12,128] x Lk {lk}"
        record("flash_fwd_bf16", tag, compare(
            f"flash_fwd_bf16 {tag}", fa._flash_fwd_cuda(q, kc, vc, None, scale),
            fa._flash_fwd_plain(q, kc, vc, None, scale)), None, None)
        results["flash_fwd_bf16"].setdefault("shapes", []).append(
            fwd_shape_entry(q, kc, vc, False, sdpa_ms(q, kc, vc)))
        del kc, vc

    phase_k5_main(record, results, q, scale)
    del q, k, v

    phase_kernels_train(record, sdpa_ms, gen, results)

    # small ragged cases: Lq, Lk not tile multiples, per-batch k_lens,
    # both head dims the kernels take
    for (b, lq, n, d) in ((2, 3000, 2, 128), (1, 2100, 3, 64)):
        q, k, v = (_rand(gen, (b, lq, n, d), bf16) for _ in range(3))
        k_lens = torch.tensor([2500, 3000][:b], dtype=torch.int32, device="cuda").clamp(max=lq)
        tag = f"[{b},{lq},{n},{d}] k_lens={k_lens.tolist()}"
        scale = d ** -0.5
        q8, k8, sqk = fa.prepare_int8(q, k, None, scale)
        record("flash_fwd_int8_qk", tag, compare(
            f"flash_fwd_int8_qk {tag}", fa._flash_int8_cuda(q8, k8, v, sqk, k_lens),
            fa._flash_int8_plain(q8, k8, v, sqk, k_lens)), None, None)
        record("flash_fwd_bf16", tag, compare(
            f"flash_fwd_bf16 {tag}", fa._flash_fwd_cuda(q, k, v, k_lens, scale),
            fa._flash_fwd_plain(q, k, v, k_lens, scale)), None, None)
        v8, sv = fa.quantize_v(v)
        for name, quant, static in INT8_VARIANTS:
            err = check_int8(name, quant, static, q8, k8, v, v8, sv, sqk, k_lens, tag)[0]
            record(name, tag, err, None, None)
    phase_k5_edges(record, gen)
    phase_int8_qk_edges(record, gen)
    torch.cuda.synchronize()


def log_softmax_shares(results, q, k, v, q8, k8):
    """S3 (the forward template's two products with no softmax) on the
    operands K1, K2 and K2v were timed on, [B * N, L, D]: each kernel's time
    less S3's is its softmax's (and V path's) share."""
    from stableavatar_tpu_torch.ops import probes

    b, l, n, d = q.shape
    qd, kd, vd, q8d, k8d = (x.transpose(1, 2).reshape(b * n, l, d).contiguous()
                            for x in (q, k, v, q8, k8))
    s3 = {False: time_ms(lambda: probes.dots_probe(qd, kd, vd), 5),
          True: time_ms(lambda: probes.dots_probe(q8d, k8d, vd, int8=True), 5)}
    for name, int8 in (("flash_fwd_bf16", False), ("flash_fwd_int8_qk", True),
                       ("flash_fwd_int8_qkv", True), ("flash_fwd_int8_qkpv", True)):
        ms = results[name]["ms"]
        log(f"  {name} {ms:.3f} ms - S3 {'int8' if int8 else 'bf16'} {s3[int8]:.3f} ms on its "
            f"operands = {ms - s3[int8]:.3f} ms ({(ms - s3[int8]) / ms:.1%} of the kernel) "
            "beyond its two products")


def phase_k5_main(record, results, q, scale):
    """K5 at the DiT cross-attention shape (q [3, 21504, 12, 128], text 512
    and image 257 keys) against its plain version, beside K1's text and
    image calls on the same inputs and the two-SDPA yardstick (two calls and
    their add: no single PyTorch call computes K5's function)."""
    import torch

    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)
    b, l, n, d = q.shape
    k1, v1 = (_rand(gen, (b, 512, n, d), torch.bfloat16) for _ in range(2))
    k2, v2 = (_rand(gen, (b, 257, n, d), torch.bfloat16) for _ in range(2))
    tag = f"[{b},{l},{n},{d}] x (512, 257)"
    err = compare(f"dual_context {tag}", ca._dual_cuda(q, k1, v1, k2, v2, scale),
                  ca._dual_plain(q, k1, v1, k2, v2, scale))
    k5 = time_ms(lambda: ca._dual_cuda(q, k1, v1, k2, v2, scale), 5)
    tile = ca.KERNEL_BLOCK_K  # a segment's last tile is computed whole
    keys = sum(-(-lk // tile) * tile for lk in (512, 257))
    record("dual_context", "main", err, k5,
           time_ms(lambda: ca._dual_plain(q, k1, v1, k2, v2, scale), 3),
           bound_ms(4.0 * b * n * l * (512 + 257) * d,
                    2.0 * b * n * d * (2 * l + 2 * (512 + 257))))
    k1_ms = [time_ms(lambda: fa._flash_fwd_cuda(q, kc, vc, None, scale), 5)
             for kc, vc in ((k1, v1), (k2, v2))]
    qt, k1t, v1t, k2t, v2t = (x.transpose(1, 2) for x in (q, k1, v1, k2, v2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    two_sdpa = time_ms(lambda: sdpa(qt, k1t, v1t) + sdpa(qt, k2t, v2t), 5)
    results["dual_context"].update(k1_text_ms=k1_ms[0], k1_image_ms=k1_ms[1],
                                   sdpa_two_calls_and_add_ms=two_sdpa)
    log(f"  dual_context {tag}: {k5:.3f} ms ({keys} key columns a row for 769 keys); K1 text + "
        f"image {k1_ms[0]:.3f} + {k1_ms[1]:.3f} = {sum(k1_ms):.3f} ms; two SDPA calls and "
        f"their add {two_sdpa:.3f} ms")
    del k1, v1, k2, v2


# K5's tile edges (128 query rows, 128-key tiles, a segment's last tile
# masked) -- (B, Lq, L1, L2, N, scale of k2): last tiles of 77 and 33 keys;
# the image context's 257 keys (a 1-key last tile) after 160 text keys; a
# 1-key segment; the DiT's 512 + 257 keys at a ragged Lq 200; B * N = 9
# with last tiles of 2 and 65 keys; image logits 30x the text ones
K5_EDGES = ((2, 3000, 77, 33, 2, 1.0), (1, 2100, 160, 257, 2, 1.0), (1, 2100, 96, 1, 2, 1.0),
            (1, 200, 512, 257, 2, 1.0), (3, 1000, 130, 65, 3, 1.0), (2, 700, 512, 257, 2, 30.0))


def phase_k5_edges(record, gen):
    """K5 at K5_EDGES, D 64 and 128, against its plain version."""
    import torch

    from stableavatar_tpu_torch.ops import cross_attention as ca

    for b, lq, l1, l2, n, k2_scale in K5_EDGES:
        for d in (128, 64):
            q = _rand(gen, (b, lq, n, d), torch.bfloat16)
            k1, v1 = (_rand(gen, (b, l1, n, d), torch.bfloat16) for _ in range(2))
            k2 = (_rand(gen, (b, l2, n, d), torch.float32) * k2_scale).bfloat16()
            v2 = _rand(gen, (b, l2, n, d), torch.bfloat16)
            tag = f"[{b},{lq},{n},{d}] x ({l1}, {l2}) k2 x {k2_scale}"
            record("dual_context", tag, compare(
                f"dual_context {tag}", ca._dual_cuda(q, k1, v1, k2, v2, d ** -0.5),
                ca._dual_plain(q, k1, v1, k2, v2, d ** -0.5)), None, None)


# the int8 wgmma kernel's tile edges (128 query rows, 128-key tiles): Lq
# and Lk apart and no multiples of 128, k_lens inside a tile and 0, D 64 and
# 128 -- (B, Lq, Lk, N, D, k_lens)
INT8_QK_EDGES = ((2, 200, 130, 2, 64, [77, 0]), (2, 200, 257, 2, 128, [0, 200]),
                 (2, 3000, 2900, 2, 64, [2500, 2900]))
# each instance held there: (launch-count name, quant, static bound, LSE)
INT8_EDGE_INSTANCES = (("flash_fwd_int8_qk", "qk", False, False),
                       ("flash_fwd_int8_qk_lse", "qk", False, True),
                       ("flash_fwd_int8_static_qk", "qk", True, True),
                       ("flash_fwd_int8_qkv", "qkv", False, False),
                       ("flash_fwd_int8_qkv_lse", "qkv", False, True),
                       ("flash_fwd_int8_static_qkv", "qkv", True, True),
                       ("flash_fwd_int8_qkpv", "qkpv", False, False),
                       ("flash_fwd_int8_qkpv_lse", "qkpv", False, True))
# qkpv's key blocks that split the kernel's 128-key tiles
QKPV_SPLIT_BLOCKS = (64, 192)


def phase_int8_qk_edges(record, gen):
    """Every int8 instance -- K2, K2v qkv / qkpv (on `flash_attention`'s JAX
    key block, and on blocks of 64 and 192 keys), K2-LSE and K3 (with its
    LSE) -- at INT8_QK_EDGES against its plain version; a batch with no
    valid key is zero rows."""
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa

    for b, lq, lk, n, d, lens in INT8_QK_EDGES:
        q = _rand(gen, (b, lq, n, d), torch.bfloat16)
        k, v = (_rand(gen, (b, lk, n, d), torch.bfloat16) for _ in range(2))
        k_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q8, k8, sqk = fa.prepare_int8(q, k, None, d ** -0.5)
        v8, sv = fa.quantize_v(v)
        mstat = fa.static_bound(q8, k8, sqk)
        tag = f"[{b},{lq},{n},{d}] x Lk {lk} k_lens={lens}"
        jax_block = fa.jax_key_block(lk, fa.INT8_BLOCK_K)
        cases = [(*inst, jax_block) for inst in INT8_EDGE_INSTANCES]
        cases += [("flash_fwd_int8_qkpv_lse", "qkpv", False, True, blk)
                  for blk in QKPV_SPLIT_BLOCKS]
        for name, quant, static, with_lse, block in cases:
            vin, svin = (v, None) if quant == "qk" else (v8, sv)
            got = fa._flash_int8_cuda(q8, k8, vin, sqk, k_lens, quant=quant, sv=svin,
                                      mstat=mstat if static else None, with_lse=with_lse,
                                      pv_block=block)
            if static:
                want = fa._flash_int8_static_plain(q8, k8, vin, sqk, k_lens, quant=quant,
                                                   sv=svin, out_dtype=torch.bfloat16,
                                                   with_lse=with_lse)
            else:
                want = fa._flash_int8_plain(q8, k8, vin, sqk, k_lens, quant=quant, sv=svin,
                                            block_k=block, out_dtype=torch.bfloat16,
                                            with_lse=with_lse)
            if with_lse:
                (got, lse), (want, want_lse) = got, want
            case = f"{name} {tag}" + (f" key block {block}" if quant == "qkpv" else "")
            err = compare(case, got, want)
            if with_lse:
                err = max(err, compare_lse(case, lse, want_lse))
            if 0 in lens and got[lens.index(0)].any():
                raise AssertionError(f"{case}: a batch without keys is not zero rows")
            record(name, tag, err, None, None)


# the new int8 kernels: (launch-count name, quant, static bound)
INT8_VARIANTS = (("flash_fwd_int8_qkv", "qkv", False), ("flash_fwd_int8_qkpv", "qkpv", False),
                 ("flash_fwd_int8_static_qk", "qk", True),
                 ("flash_fwd_int8_static_qkv", "qkv", True))


def int8_plain(q8, k8, v, sqk, k_lens, quant, sv, static):
    """The plain version of one int8 kernel on the same prepared operands:
    K2v-qkpv on `flash_attention`'s JAX key block (its result depends on the
    block; the kernel takes the same), K3 at the kernel's query block of 64
    with its LSE."""
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa

    if static:
        return fa._flash_int8_static_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv,
                                           out_dtype=torch.bfloat16, with_lse=True)
    return fa._flash_int8_plain(q8, k8, v, sqk, k_lens, quant=quant, sv=sv,
                                block_k=fa.jax_key_block(k8.shape[1], fa.INT8_BLOCK_K),
                                out_dtype=torch.bfloat16)


def check_int8(name, quant, static, q8, k8, v, v8, sv, sqk, k_lens, tag):
    """One K2v / K3 kernel against its plain version on the same prepared
    operands, K3 on its LSE too.  Returns (max-abs error, the V operand,
    K3's bound and LSE, or None)."""
    from stableavatar_tpu_torch.ops import flash_attention as fa

    vin = v if quant == "qk" else v8
    mstat = fa.static_bound(q8, k8, sqk) if static else None
    got = fa._flash_int8_cuda(q8, k8, vin, sqk, k_lens, quant=quant, sv=sv, mstat=mstat,
                              with_lse=static)
    want = int8_plain(q8, k8, vin, sqk, k_lens, quant, sv, static)
    lse = None
    if static:
        (got, lse), (want, want_lse) = got, want
    err = compare(f"{name} {tag}", got, want)
    if static:
        err = max(err, compare_lse(f"{name} {tag}", lse, want_lse))
    return err, vin, mstat, lse


def phase_kernels_int8(record, q8, k8, v, sqk, shape, fwd_ops):
    """K2v and K3 at the DiT self-attention shape on K2's roped operands:
    each against its plain version, timed on prepared operands (as K2 is),
    with its bound; K3's LSE and the rows whose whole sum underflows its
    static bound (l clamped to 1e-30); the plain-torch preps timed apart."""
    import math

    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa

    b, l, n, d = shape
    v8, sv = fa.quantize_v(v)
    tag = f"[{b},{l},{n},{d}] rope"
    log(f"  prep {tag}, plain torch, not in the kernels' ms: static_bound (K3) "
        f"{time_ms(lambda: fa.static_bound(q8, k8, sqk), 5):.3f} ms, quantize_v (K2v) "
        f"{time_ms(lambda: fa.quantize_v(v), 5):.3f} ms")
    for name, quant, static in INT8_VARIANTS:
        err, vin, mstat, lse = check_int8(name, quant, static, q8, k8, v, v8, sv, sqk, None, tag)
        if static:
            # rows whose sum l underflowed: log(l) = lse - M ln 2 at log(1e-30)
            m = mstat.reshape(b, n, -1).repeat_interleave(fa.KERNEL_BLOCK_Q, dim=2)[:, :, :l]
            log_l = lse - m * fa.LN2
            under = int((log_l <= math.log(1e-30) + 1e-3).sum())
            log(f"  {name} {tag}: {under} of {b * n * l} rows underflow the static bound "
                f"(l clamped to 1e-30); least log(l) {float(log_l.min()):.3f}, median "
                f"{float(log_l.median()):.3f}")
            del m, log_l
        # Q.K^T on the s8 tensor cores; P.V in bf16, or s8 for qkpv.  Bytes:
        # q8, k8 and int8 v one byte each (bf16 v two), bf16 out two; K3's
        # bound is a few KB
        vbytes = 2.0 if quant == "qk" else 1.0
        ops_int8 = fwd_ops if quant == "qkpv" else fwd_ops / 2
        record(name, "main", err,
               time_ms(lambda: fa._flash_int8_cuda(q8, k8, vin, sqk, None, quant=quant, sv=sv,
                                                   mstat=mstat), 5),
               time_ms(lambda: int8_plain(q8, k8, vin, sqk, None, quant, sv, static), 3),
               bound_ms(fwd_ops - ops_int8, b * l * n * d * (1 + 1 + vbytes + 2.0),
                        ops_int8=ops_int8))
    torch.cuda.synchronize()


def compare_lse(name: str, got, want) -> float:
    """Raise unless an LSE (K1's or K3's) is finite and within LSE_TOL of
    the plain one."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite LSE")
    mx = float((got - want).abs().max())
    log(f"  {name} lse: max_abs={mx:.3e}")
    if mx > LSE_TOL:
        raise AssertionError(f"{name}: LSE differs from the plain version by {mx:.3e} > {LSE_TOL}")
    return mx


def compare_grad(name: str, got, want) -> float:
    """Raise unless rel-L2 <= GRAD_REL_TOL; return max-abs."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    mx = float((g - w).abs().max())
    log(f"  {name}: rel_l2={rel:.3e} max_abs={mx:.3e}")
    if rel > GRAD_REL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(rel_l2 {rel:.3e} > {GRAD_REL_TOL})")
    return mx


def phase_kernels_train(record, sdpa_ms, gen, results):
    """K1 with LSE and the fused K4 backward at the training shapes: the DiT
    self-attention of one 512x512, 81-frame sample [1, 21504, 12, 128], the
    text / image cross-attention (Lk 512, 257; their K1-LSE and K4 times go
    to the entries' "shapes", each with SDPA's forward or backward) and the
    ragged cases."""
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    cases = [((1, 21504, 21504, 12, 128), None), ((1, 21504, 512, 12, 128), None),
             ((1, 21504, 257, 12, 128), None), ((2, 3000, 3000, 2, 128), [2500, 3000]),
             ((1, 2100, 2100, 3, 64), None)]
    for (b, lq, lk, n, d), k_lens in cases:
        q = _rand(gen, (b, lq, n, d), bf16)
        k, v = _rand(gen, (b, lk, n, d), bf16), _rand(gen, (b, lk, n, d), bf16)
        do = _rand(gen, (b, lq, n, d), bf16)
        kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
        tag = f"[{b},{lq},{n},{d}] x Lk {lk}" + ("" if k_lens is None else f" k_lens={k_lens}")
        scale = d ** -0.5
        out, lse = fa._flash_fwd_cuda(q, k, v, kl, scale, with_lse=True)
        want_out, want_lse = fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True)
        err = max(compare(f"flash_fwd_bf16_lse {tag}", out, want_out),
                  compare_lse(f"flash_fwd_bf16_lse {tag}", lse, want_lse))
        grads = fa._flash_bwd_cuda(q, k, v, kl, out, lse, do, scale)
        want = fa._flash_bwd_plain(q, k, v, kl, out, lse, do, scale)
        errs = [compare_grad(f"flash_bwd {name} {tag}", g, w)
                for name, g, w in zip(("dq", "dk", "dv"), grads, want)]
        del grads, want, want_out, want_lse
        if k_lens is not None or d != 128:
            for name, e in (("flash_fwd_bf16_lse", err), ("flash_bwd", max(errs))):
                record(name, tag, e, None, None)
            continue
        # keys never masked here: the work is the full Lq x Lk per head
        prod = 2.0 * b * n * lq * lk * d  # flops of one Lq x Lk x D product
        stats = 4.0 * b * n * lq * 2  # lse and delta, fp32
        # q, dO in and dq out (Lq rows), k, v in and dk, dv out (Lk rows), bf16
        grad_bytes = 2.0 * b * n * d * (3 * lq + 4 * lk) + stats
        library = sdpa_ms(q, k, v, backward=True)
        if lk == lq:
            record("flash_fwd_bf16_lse", tag, err,
                   time_ms(lambda: fa._flash_fwd_cuda(q, k, v, kl, scale, with_lse=True), 5),
                   time_ms(lambda: fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True), 3),
                   bound_ms(2 * prod, 2.0 * b * n * d * (2 * lq + 2 * lk) + stats / 2),
                   sdpa_ms(q, k, v))
        else:
            record("flash_fwd_bf16_lse", tag, err, None, None)
            results["flash_fwd_bf16_lse"].setdefault("shapes", []).append(
                fwd_shape_entry(q, k, v, True, sdpa_ms(q, k, v)))
        # K4: S, dP, dV, dK, dQ -- five products
        ms = time_ms(lambda: fa._flash_bwd_cuda(q, k, v, kl, out, lse, do, scale), 5)
        plain = time_ms(lambda: fa._flash_bwd_plain(q, k, v, kl, out, lse, do, scale), 3)
        bound = bound_ms(5 * prod, grad_bytes)
        if lk == lq:
            record("flash_bwd", tag, max(errs), ms, plain, bound, library)
        else:
            # the cross-attention shapes: beside the main entry, in "shapes"
            splits = fa.bwd_splits(b * n, lq, lk,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"  flash_bwd {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
                f"{bound[0]:.3f} ms ({bound[1]}), library {library:.3f} ms "
                f"(query splits {splits})")
            record("flash_bwd", tag, max(errs), None, None)
            results["flash_bwd"].setdefault("shapes", []).append(dict(
                shape=[b, lq, lk, n, d], ms=ms, plain_ms=plain, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library, query_splits=splits))
        del q, k, v, do, out, lse
    torch.cuda.synchronize()


def build_models(device):
    """Random 1.3B stack on the card from a seeded generator: DiT (bf16, plus
    its W8A8 fast-path preparation), VAE and CLIP (bf16), wav2vec (fp32).
    The zero-initialised DiT head and vocal k/v are replaced by small random
    weights (as the parity tests do) so the velocity is not identically 0."""
    import torch

    from stableavatar_tpu_torch.config import CLIPConfig, VAEConfig, WAN_1_3B, Wav2Vec2Config
    from stableavatar_tpu_torch.models.clip import init_clip_visual
    from stableavatar_tpu_torch.models.dit import init_dit
    from stableavatar_tpu_torch.models.vae import init_vae
    from stableavatar_tpu_torch.models.wav2vec import init_wav2vec2
    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    cfg = WAN_1_3B
    dit = init_dit(gen, cfg, device, bf16)
    head = dit["head"]["head"]
    head["w"] = (torch.randn(head["w"].shape, generator=gen, device=device) * 0.01).to(bf16)
    for bp in dit["blocks"]:
        for name in ("k_vocal", "v_vocal"):
            w = bp["cross_attn"][name]["w"]
            bp["cross_attn"][name]["w"] = (
                torch.randn(w.shape, generator=gen, device=device) * 0.02).to(bf16)
    models = WanModels(
        dit_params=prepare_fast_params(dit, cfg, quant=True), dit_cfg=cfg,
        vae_params=init_vae(gen, VAEConfig(), device, bf16), vae_cfg=VAEConfig(),
        clip_params=init_clip_visual(gen, CLIPConfig(), device, bf16), clip_cfg=CLIPConfig(),
        wav2vec_params=init_wav2vec2(gen, Wav2Vec2Config(), device, torch.float32),
        wav2vec_cfg=Wav2Vec2Config(), rope_split=True, attn_quant="qk", device=device)
    return models, dit


def to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu() if torch.is_tensor(tree) else tree


def phase_reference(models):
    """The fast-path DiT (2 of the 30 blocks, full width) on a small window
    with 2,304 tokens, so self-attention takes K2 and cross-attention K5: the
    card's output against the same forward on the CPU (plain versions)."""
    import torch

    from stableavatar_tpu_torch.models.dit import dit_forward

    cfg = models.dit_cfg
    params = dict(models.dit_params, blocks=models.dit_params["blocks"][:2])
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((3, 16, 9, 32, 32), generator=gen, device="cuda").bfloat16()
    y = torch.randn((3, 20, 9, 32, 32), generator=gen, device="cuda").bfloat16()
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").bfloat16()
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").bfloat16()
    voc = torch.randn((1, 66, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 900.0, device="cuda")
    args = (x, t, text, clip, y, voc)
    kw = dict(video_sample_n_frames=33, vocal_cfg_tile=True, rope_split=True, attn_quant="qk")
    with torch.no_grad():
        got = dit_forward(params, cfg, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = dit_forward(to_cpu(params), cfg, *(a.cpu() for a in args), **kw)
        log(f"  CPU reference forward {time.perf_counter() - t0:.1f} s")
    g, w = got.float().cpu(), want.float()
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    log(f"  dit_forward 2 blocks, [3,16,9,32,32]: card vs CPU rel_l2={rel:.3e} "
        f"(|out| rms {float(w.square().mean().sqrt()):.3e})")
    # bf16 on both sides, rounded at different places, plus W8A8 rounding flips
    if not (torch.isfinite(g).all() and rel < 5e-2):
        raise AssertionError(f"card and CPU forwards disagree: rel_l2 {rel:.3e} >= 5e-2")


def phase_train_reference(dit_params, cfg):
    """One train step of the bf16 DiT (2 of the 30 blocks, full width) on a
    9-latent-frame 256x256 window (2,304 tokens, so every long-query
    attention takes K1 with LSE and K4 on the card; remat on): its loss and
    gradients against the same step on the CPU (plain versions), with the
    same draws.  bf16 on both sides, rounded at other places."""
    import torch

    from stableavatar_tpu_torch.train import optim
    from stableavatar_tpu_torch.train.trainer import TrainConfig, train_sigmas, train_step
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    params = dict(dit_params, blocks=dit_params["blocks"][:2])
    gen = torch.Generator(device="cuda").manual_seed(3)
    f, h, w = 9, 32, 32
    batch = {
        "latents": torch.randn((1, 16, f, h, w), generator=gen, device="cuda"),
        "inpaint_latents": torch.randn((1, 20, f, h, w), generator=gen, device="cuda"),
        "prompt_embeds": torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen, device="cuda"),
        "clip_fea": torch.randn((1, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda"),
        "vocal_embeddings": torch.randn((1, 66, cfg.audio_in_dim), generator=gen, device="cuda"),
        "face_masks": torch.rand((1, 1, f, h, w), generator=gen, device="cuda"),
        "lip_masks": torch.rand((1, 1, f, h, w), generator=gen, device="cuda"),
    }
    draws = {"noise": torch.randn((1, 16, f, h, w), generator=gen, device="cuda"),
             "idx": torch.tensor([600], device="cuda"), "mask_flag": torch.tensor(0.3, device="cuda")}
    runs = {}
    for device in ("cuda", "cpu"):
        captured = {}

        def keep(grads, state, p=None, captured=captured):
            captured["g"] = [g.float().cpu() for g in grads]
            return [torch.zeros_like(g) for g in grads], state

        move = (lambda x: x) if device == "cuda" else to_cpu
        t0 = time.perf_counter()
        _, _, m = train_step(
            move(params), {}, move(batch), None, False, dit_cfg=cfg,
            # remat on the card (the training path); the CPU skips the recompute
            train_cfg=TrainConfig(video_sample_n_frames=33, remat=device == "cuda"),
            tx=optim.GradientTransformation(lambda p: {}, keep),
            sigmas_table=train_sigmas(device=device), draws=move(draws))
        loss = float(m["loss"])
        log(f"  train step on {device}: loss {loss:.6f}, grad norm {float(m['grad_norm']):.6f}, "
            f"{time.perf_counter() - t0:.1f} s")
        runs[device] = (loss, torch.cat([g.reshape(-1) for g in captured["g"]]))
    (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    grad_rel = float(torch.linalg.vector_norm(gc - gp) / torch.linalg.vector_norm(gp))
    log(f"  card vs CPU: loss rel {loss_rel:.3e}, gradients rel_l2 {grad_rel:.3e} "
        f"over {len(tree_leaves(params))} leaves")
    # measured on an NVIDIA H100 80GB HBM3 at 700 W: loss 2.6e-5, gradients 2.0e-3
    if not (torch.isfinite(gc).all() and loss_rel < 1e-3 and grad_rel < 1e-2):
        raise AssertionError(f"card and CPU train steps disagree: loss rel {loss_rel:.3e} "
                             f"(limit 1e-3), gradients rel_l2 {grad_rel:.3e} (limit 1e-2)")


OVERLAP, N_WINDOWS = 15, 2


def pipeline_inputs(models):
    """Seeded inputs of generate_long at 512x512 whose audio makes N_WINDOWS
    windows of 21 latent frames (infer_length 27 for 2): a reference image,
    a 16 kHz waveform and a pre-encoded text context [3, 512, 4096]."""
    import numpy as np
    import torch

    infer_length = 21 + (21 - OVERLAP) * (N_WINDOWS - 1)
    n_samples = ((infer_length - 1) * 4 + 1) * (16000 // 25)
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((1, 3, 512, 512)).astype(np.float32) * 0.2
    wav = rng.standard_normal(n_samples).astype(np.float32) * 0.05
    text_ctx = torch.as_tensor(
        rng.standard_normal((3, models.dit_cfg.text_len, models.dit_cfg.text_dim)),
        dtype=torch.bfloat16, device="cuda")
    return dict(ref_image=ref, vocal_waveform=wav, text_ctx=text_ctx,
                overlap_window_length=OVERLAP, seed=42)


def phase_pipeline(models):
    """generate_long at 512x512, 2 windows (infer_length 27), 2 Euler steps."""
    import numpy as np
    import torch

    from stableavatar_tpu_torch.pipelines.long import generate_long
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    steps, n_windows = 2, N_WINDOWS
    timer = StepTimer("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = generate_long(models, num_inference_steps=steps, timer=timer, **pipeline_inputs(models))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name, s in timer.summary().items():
        log(f"  phase {name}: {s['total_s']:.3f} s over {s['count']}")
    steps_s = timer.history["denoise_step"]
    log(f"  wall {wall:.2f} s; denoise steps {[round(s, 3) for s in steps_s]} s; last step "
        f"{steps_s[-1] / n_windows:.3f} s per window-step; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    video = out.videos
    if video.shape != (1, 3, 105, 512, 512):
        raise AssertionError(f"video shape {video.shape} != (1, 3, 105, 512, 512)")
    if not (np.isfinite(video).all() and video.min() >= 0.0 and video.max() <= 1.0):
        raise AssertionError("video values are not finite values in [0, 1]")
    lat = out.latents
    if not torch.isfinite(lat).all():
        raise AssertionError("latents are not finite")
    log(f"  video {video.shape} mean {video.mean():.4f} std {video.std():.4f}; "
        f"latents std {float(lat.std()):.4f}")
    return steps * n_windows


def phase_bf16(dit_params, cfg):
    """One dit_forward window at 1.3B / 512x512 on unprepared bf16 params with
    attn_quant="none": the CLI-default path, self- and cross-attention on K1."""
    import torch

    from stableavatar_tpu_torch.models.dit import dit_forward
    from stableavatar_tpu_torch.ops import activations as act

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    x = torch.randn((3, 16, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    y = torch.randn((3, 20, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").to(bf16)
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").to(bf16)
    voc = torch.randn((1, 161, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 999.0, device="cuda")
    before = act.launch_counts["gelu_tanh"]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dit_forward(dit_params, cfg, x, t, text, clip, y, voc, video_sample_n_frames=81,
                          vocal_cfg_tile=True, attn_quant="none")
        torch.cuda.synchronize()
    log(f"  bf16 dit_forward window: {time.perf_counter() - t0:.3f} s, out {tuple(out.shape)}")
    if tuple(out.shape) != (3, 16, 21, 64, 64) or not torch.isfinite(out).all():
        raise AssertionError("bf16 dit_forward output has the wrong shape or non-finite values")
    # one GELU pass for each block, the text embedding and each vocal block
    gelu = act.launch_counts["gelu_tanh"] - before
    log(f"  gelu_tanh launches: {gelu}")
    if gelu != cfg.num_layers + 1 + cfg.vocal_num_layers:
        raise AssertionError(f"expected {cfg.num_layers + 1 + cfg.vocal_num_layers} "
                             f"gelu_tanh launches, got {gelu}")
    return gelu


# the CLI's flags in the cli phase: --sample_steps 5 because the TeaCache
# counter advances once per window call and wraps every 5 calls, so with 2
# windows steps 1 and 3 pair two skippable calls (with 3 or 4 steps every
# step pairs one with a forced compute and nothing can be skipped); the
# rescaled distance never exceeds 0.254, so a threshold of 0.3 skips both
CLI_ARGV = ["--fast_path", "linears", "--sample_solver", "dpm++", "--solver_order", "2",
            "--enable_teacache", "--num_skip_start_steps", "1", "--teacache_threshold", "0.3",
            "--sample_steps", "5", "--validation_prompts", "A person is talking to the camera",
            "--negative_prompts", "blurry, distorted"]


def phase_cli(reset_counts, counts):
    """The inference CLI's path at 1.3B / 512x512 over 2 windows: flags
    through build_parser, load_models (umT5-xxl encodes on the card, then is
    released), the CLI's run_generation with K3 on (STATIC_MAX).  Returns
    its launch counts; the models are released afterwards."""
    import numpy as np
    import torch

    from stableavatar_tpu_torch.cli.inference import build_parser, load_models, run_generation
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.pipelines import long as long_mod
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    args = build_parser().parse_args(CLI_ARGV)
    timer = StepTimer("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = load_models(args, "cuda", timer=timer)
    torch.cuda.synchronize()
    log(f"  load_models: {time.perf_counter() - t0:.2f} s; device memory above the resident "
        f"models: peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB (umT5-xxl "
        f"loaded), after T5's release {(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB")
    ctx, t5_cfg = models.text_ctx, models.t5_cfg
    want_ctx = (3, t5_cfg.text_len, t5_cfg.dim)  # [3, 512, 4096] for umT5-xxl
    if models.t5_params is not None or ctx is None or tuple(ctx.shape) != want_ctx \
            or not torch.isfinite(ctx).all():
        raise AssertionError(f"text context {None if ctx is None else tuple(ctx.shape)} is not "
                             f"a finite {want_ctx} with T5 released")
    log(f"  text_ctx {tuple(ctx.shape)} {ctx.dtype}, rms {float(ctx.float().square().mean().sqrt()):.4f}")

    inputs = pipeline_inputs(models)
    skips = [0]
    skip_fn = long_mod.dit_forward_skip

    def counted_skip(*a, **k):
        skips[0] += 1
        return skip_fn(*a, **k)

    fa.STATIC_MAX, long_mod.dit_forward_skip = True, counted_skip
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = run_generation(args, models, inputs["ref_image"], inputs["vocal_waveform"], ctx,
                             timer=timer)
        torch.cuda.synchronize()
        launches = counts()
    finally:
        fa.STATIC_MAX, long_mod.dit_forward_skip = False, skip_fn
    wall = time.perf_counter() - t0
    for name, st in timer.summary().items():
        log(f"  phase {name}: {st['total_s']:.3f} s over {st['count']}")
    tc = models.teacache
    n_calls = args.sample_steps * N_WINDOWS
    computed = n_calls - tc.skipped_calls
    log(f"  run_generation {wall:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; TeaCache skipped "
        f"{tc.skipped_calls} of {n_calls} window calls (dit_forward_skip ran {skips[0]} times); "
        f"launches {launches}")
    video, want_shape = out.videos, (1, 3, 105, *inputs["ref_image"].shape[-2:])
    if video.shape != want_shape or not (
            np.isfinite(video).all() and video.min() >= 0.0 and video.max() <= 1.0):
        raise AssertionError(f"video {video.shape} is not finite [0, 1] of {want_shape}")
    if tc.skipped_calls < 1 or skips[0] != tc.skipped_calls:
        raise AssertionError(f"TeaCache skipped {tc.skipped_calls}, skip path ran {skips[0]}")
    layers = models.dit_cfg.num_layers
    want = {"flash_fwd_int8_static_qk": layers * computed, "dual_context": layers * computed,
            "flash_fwd_int8_qk": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"cli launch counts {launches} != {want}")
    del models, out
    torch.cuda.empty_cache()
    return launches


def phase_variants(models, reset_counts, counts):
    """K2v-qkpv through generate_long (UniPC, 2 windows x 2 steps), and K2v-qkv
    and K3-qkv through one dit_forward window each; every output against
    the same run on K1 (attn_quant="none" on the same parameters).  The
    counts are set to 0 just before each of the three runs and read just
    after it; returns each run's count of its own kernel."""
    import dataclasses

    import torch

    from stableavatar_tpu_torch.models.dit import dit_forward
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.pipelines.long import generate_long

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.float() - b.float())
                     / torch.linalg.vector_norm(b.float()))

    kw = dict(num_inference_steps=2, scheduler="unipc", output_type="latent",
              **pipeline_inputs(models))
    reset_counts()
    t0 = time.perf_counter()
    qkpv = generate_long(dataclasses.replace(models, attn_quant="qkpv"), **kw)
    torch.cuda.synchronize()
    launches = counts()
    log(f"  generate_long qkpv, UniPC, 2 windows x 2 steps: {time.perf_counter() - t0:.2f} s, "
        f"launches {launches}")
    ref = generate_long(dataclasses.replace(models, attn_quant="none"), **kw)
    if not torch.isfinite(qkpv.latents).all():
        raise AssertionError("qkpv latents are not finite")
    log(f"  qkpv latents against the same run on K1: rel_l2 {rel(qkpv.latents, ref.latents):.4e}")
    want = models.dit_cfg.num_layers * 2 * N_WINDOWS
    if launches["flash_fwd_int8_qkpv"] != want:
        raise AssertionError(f"expected {want} K2v-qkpv launches, got {launches}")

    cfg = models.dit_cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((3, cfg.out_dim, 21, 64, 64), generator=gen, device="cuda").bfloat16()
    y = torch.randn((3, cfg.in_dim - cfg.out_dim, 21, 64, 64), generator=gen,
                    device="cuda").bfloat16()
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").bfloat16()
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").bfloat16()
    voc = torch.randn((1, 161, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 700.0, device="cuda")

    def window(quant, static):
        fa.STATIC_MAX = static
        try:
            with torch.no_grad():
                return dit_forward(models.dit_params, cfg, x, t, text, clip, y, voc,
                                   video_sample_n_frames=81, vocal_cfg_tile=True,
                                   rope_split=True, attn_quant=quant)
        finally:
            fa.STATIC_MAX = False

    outs = {}
    for name, other, static in (("flash_fwd_int8_qkv", "flash_fwd_int8_static_qkv", False),
                                ("flash_fwd_int8_static_qkv", "flash_fwd_int8_qkv", True)):
        reset_counts()
        out = window("qkv", static)
        torch.cuda.synchronize()
        c = counts()
        if c[name] != cfg.num_layers or c[other] != 0 or not torch.isfinite(out).all():
            raise AssertionError(f"{name} window: launches {c} (want {cfg.num_layers} of "
                                 f"{name}, 0 of {other}) or non-finite output")
        launches[name], outs[name] = c[name], out
    k1 = window("none", False)
    for name, out in outs.items():
        log(f"  dit_forward window {name}: {launches[name]} launches; against the same window "
            f"on K1: rel_l2 {rel(out, k1):.4e}")
    return launches


# host-draw seed of train(): with batch 1 its third step takes the
# clip-level branch (encode_batch's draws from numpy's default_rng)
TRAIN_SEED, TRAIN_STEPS = 6, 3


def train_batches(n, cfg):
    """Synthetic batches with the dataset's keys at the train CLI's defaults
    (512x512, 81 frames, batch 1): pixels in [-1, 1], the first frame
    visible, face and lip masks, 16 kHz audio for 81 frames at 25 fps and a
    pre-encoded prompt (the models carry no tokenizer here, so encode_batch
    takes `prompt_embeds`)."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(4)
    frames, size = 81, 512
    masks = np.ones((1, frames, 1, size, size), np.float32)
    masks[:, 0] = 0.0
    face = rng.uniform(0, 1, (1, 1, frames, size, size)).astype(np.float32)
    for _ in range(n):
        pixels = torch.rand((1, 3, frames, size, size), generator=gen, device="cuda") * 2 - 1
        masked = pixels * (1 - torch.as_tensor(masks, device="cuda").transpose(1, 2))
        yield {
            "pixel_values": pixels, "masked_pixel_values": masked, "pixel_value_masks": masks,
            "reference_image": pixels[:, :, 0:1], "tgt_face_masks": face,
            "tgt_lip_masks": (face > 0.7).astype(np.float32),
            "vocal_input_values": torch.randn((1, frames * 640), generator=gen,
                                              device="cuda") * 0.1,
            "prompt_embeds": torch.randn((1, cfg.text_len, cfg.text_dim), generator=gen,
                                         device="cuda"),
        }


def train_run(tmodels, train_cfg, out_dir, reset_counts, counts):
    """train() at 1.3B / 512x512 / 81 frames for TRAIN_STEPS steps on
    `tmodels` with `train_cfg`, a checkpoint at the last step: each step's
    wall, loss, gradient norm, parameter delta, clip-level flag, peak
    device memory and launches logged; the launch counts set to 0 just
    before train() and read just after.  Fails unless the losses, gradient
    norms and deltas are finite, every step moved the parameters, one step
    took the clip-level branch and the K1-LSE / K4 launches are exact.
    Returns (launches, steps, params, opt_state)."""
    import torch

    from stableavatar_tpu_torch.ops import activations as act
    from stableavatar_tpu_torch.train.loop import train
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    cfg = tmodels.dit_cfg
    leaves = tree_leaves(tmodels.dit_params)
    before = [p.clone() for p in leaves]
    start = [p.clone() for p in leaves[:4]]
    steps = []
    last = {"t": time.perf_counter(), "c": {}}

    def on_step(step, params, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        delta = torch.sqrt(sum(((p.float() - b.float()) ** 2).sum() for p, b in zip(leaves, before)))
        for p, b in zip(leaves, before):
            b.copy_(p)
        c = counts()
        launches = {k: c[k] - last["c"].get(k, 0) for k in TRAIN_KERNELS}
        steps.append(dict(step=step, wall_s=now - last["t"], loss=float(m["loss"]),
                          grad_norm=float(m["grad_norm"]), delta_norm=float(delta),
                          clip_level=bool(m["is_clip_level_modeling"]),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                          launches=launches))
        log(f"  step {step}: {now - last['t']:.3f} s wall (encode + step), loss "
            f"{steps[-1]['loss']:.6f}, grad norm {steps[-1]['grad_norm']:.6f}, parameter "
            f"delta norm {steps[-1]['delta_norm']:.6e}, clip-level {steps[-1]['clip_level']}, "
            f"peak device memory {steps[-1]['peak_gib']:.2f} GiB, launches {launches}")
        torch.cuda.reset_peak_memory_stats()
        last["t"], last["c"] = time.perf_counter(), c

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gelu_before = dict(act.launch_counts)
    last["t"] = time.perf_counter()
    t0 = last["t"]
    params, opt_state, history = train(
        tmodels, train_batches(TRAIN_STEPS, cfg), train_cfg, output_dir=out_dir,
        max_train_steps=TRAIN_STEPS, checkpointing_steps=TRAIN_STEPS, checkpoints_total_limit=1,
        resume_from_checkpoint=None, log_every=1, seed=TRAIN_SEED, step_callback=on_step)
    torch.cuda.synchronize()
    launches = {**counts(), **{k: n - gelu_before[k] for k, n in act.launch_counts.items()}}
    log(f"  train(): {len(history)} steps in {time.perf_counter() - t0:.2f} s including the "
        f"asynchronous checkpoint; launches {launches}")
    walls = sorted(s["wall_s"] for s in steps)
    log(f"  train step time (encode + step): median {walls[len(walls) // 2]:.3f} s, "
        f"steps {[round(s['wall_s'], 3) for s in steps]}")
    if len(steps) != TRAIN_STEPS or not all(
            torch.isfinite(torch.tensor([s["loss"], s["grad_norm"], s["delta_norm"]])).all()
            for s in steps):
        raise AssertionError(f"train steps not all finite: {steps}")
    if not all(s["delta_norm"] > 0 for s in steps) or all(
            torch.equal(a, b) for a, b in zip(start, leaves[:4])):
        raise AssertionError("a train step left the parameters unchanged")
    n_clip = sum(s["clip_level"] for s in steps)
    if n_clip == 0:
        raise AssertionError("no step took the clip-level branch")
    # per layer 3 long-query attentions (self, text, image), 4 in
    # clip-level mode (global vocal); forward twice under remat, one backward
    calls = cfg.num_layers * (3 * TRAIN_STEPS + n_clip)
    want = {"flash_fwd_bf16_lse": 2 * calls, "flash_bwd": calls,
            "rope_rotate": 0, "rope_finalize_bwd": 0,
            "flash_fwd_bf16": 0, "flash_fwd_int8_qk": 0, "dual_context": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"training launch counts {launches} != {want}")
    # every block's FFN GELU: forward and remat recompute on the card, one
    # backward a step
    if (launches["gelu_tanh"] < 2 * cfg.num_layers * TRAIN_STEPS
            or launches["gelu_tanh_bwd"] < cfg.num_layers * TRAIN_STEPS):
        raise AssertionError(f"training GELU launches {launches} below two forwards and one "
                             f"backward for each of {cfg.num_layers} blocks and "
                             f"{TRAIN_STEPS} steps")
    return launches, steps, params, opt_state


def train_models(models, dit_params):
    """The models of the training path: the bf16 DiT, no split-pair rope,
    no int8 attention."""
    import dataclasses

    return dataclasses.replace(models, dit_params=dit_params, rope_split=False,
                               attn_quant="none")


def phase_train(models, dit_params, reset_counts, counts):
    """train() at 1.3B / 512x512 / 81 frames for TRAIN_STEPS steps (AdamW,
    remat, the train CLI's defaults) on the bf16 DiT, then a resume from
    its checkpoint.  Returns the training path's launch counts and its
    steps."""
    import dataclasses

    import torch

    from stableavatar_tpu_torch.train.loop import CheckpointManager, train
    from stableavatar_tpu_torch.train.trainer import TrainConfig
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    tmodels = train_models(models, dit_params)
    leaves = tree_leaves(dit_params)
    log(f"  {sum(p.numel() for p in leaves) / 1e9:.3f} B parameters, bf16")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        launches, steps, _, _ = train_run(tmodels, TrainConfig(), out_dir, reset_counts, counts)
        cm = CheckpointManager(out_dir)
        if os.path.basename(cm.latest() or "") != f"checkpoint-{TRAIN_STEPS}":
            raise AssertionError(f"no checkpoint-{TRAIN_STEPS} in {os.listdir(out_dir)}")
        t0 = time.perf_counter()
        resumed, _, history = train(dataclasses.replace(tmodels),
                                    train_batches(1, tmodels.dit_cfg), TrainConfig(),
                                    output_dir=out_dir,
                                    max_train_steps=TRAIN_STEPS, resume_from_checkpoint="latest",
                                    seed=TRAIN_SEED)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed), leaves))
        log(f"  resumed from {cm.latest()} in {time.perf_counter() - t0:.2f} s: {len(history)} "
            f"further steps, parameters equal to the trained ones: {same}")
        if history or not same:
            raise AssertionError("the resumed run did not continue at the checkpoint's step")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches, steps


# the train CLI's optimizers: TrainConfig's flags of each
OPTIMIZER_FLAGS = {"adamw": {}, "adam8bit": dict(use_8bit_adam=True),
                   "came": dict(use_came=True)}
# card against CPU, the tiny fp32 step's parameter updates: rel-L2 limit
# (fp32 on both sides, summed in other orders; TF32 off)
OPTIMIZER_REL_TOL = 1e-5


def phase_train_optimizers(models, dit_params, reset_counts, counts, adamw_steps):
    """8-bit Adam, then CAME, through train() on phase 9's route (the bf16
    DiT at 1.3B / 512x512 / 81 frames, batch 1, remat) for TRAIN_STEPS steps
    each: the checks of `train_run`, each step's launches equal to AdamW's
    (phase 9, the same seed and batches), the peak device memory beside
    AdamW's and beside `cli/train.py:train_bytes` at --fsdp 1, and the
    checkpoint at the last step restored on the card equal to the live
    parameters and optimizer state bit for bit.  Then a tiny-config fp32
    train step of each, card against CPU, and the optimizer update alone
    (`tx.update`) of AdamW, 8-bit Adam and CAME at 1.3B."""
    import torch

    from stableavatar_tpu_torch.cli.train import train_bytes
    from stableavatar_tpu_torch.train.loop import CheckpointManager
    from stableavatar_tpu_torch.train.trainer import TrainConfig
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    tmodels = train_models(models, dit_params)
    leaves = tree_leaves(dit_params)
    adamw_peak = max(s["peak_gib"] for s in adamw_steps)
    adamw_need = train_bytes(leaves, 1, "adamw") / 2 ** 30
    for name in ("adam8bit", "came"):
        log(f"  -- {name}")
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            _, steps, params, state = train_run(tmodels, TrainConfig(**OPTIMIZER_FLAGS[name]),
                                                out_dir, reset_counts, counts)
            if [s["launches"] for s in steps] != [s["launches"] for s in adamw_steps]:
                raise AssertionError(f"{name}'s launches a step {[s['launches'] for s in steps]}"
                                     f" != AdamW's {[s['launches'] for s in adamw_steps]}")
            peak = max(s["peak_gib"] for s in steps)
            need = train_bytes(leaves, 1, name) / 2 ** 30
            log(f"  {name}: peak device memory {peak:.2f} GiB, AdamW's {adamw_peak:.2f} "
                f"({adamw_peak - peak:.2f} GiB less); train_bytes at --fsdp 1 {need:.2f} GiB, "
                f"AdamW's {adamw_need:.2f} ({adamw_need - need:.2f} GiB less)")
            t0 = time.perf_counter()
            restored = CheckpointManager(out_dir).restore("cuda")
            torch.cuda.synchronize()
            same = (restored["step"] == TRAIN_STEPS and trees_equal(restored["params"], params)
                    and trees_equal(restored["opt_state"], state))
            log(f"  {name}: checkpoint-{restored['step']} restored on the card in "
                f"{time.perf_counter() - t0:.2f} s, parameters and optimizer state equal to the "
                f"live ones: {same}")
            if not same:
                raise AssertionError(f"{name}'s checkpoint does not restore its state bit for bit")
            del restored, params, state
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        tiny_step_card_vs_cpu(name)
    time_optimizer_updates(leaves)


def tiny_step_card_vs_cpu(name):
    """One fp32 train step of the tiny DiT (`tiny_debug_configs`, with a
    random head and vocal k / v, so every block has a gradient) with the
    optimizer `name`, on the card and on the CPU from the same weights,
    batch and draws, TF32 off: the parameters' updates against each other
    at rel-L2 OPTIMIZER_REL_TOL, over every leaf but the attention key
    biases.  Their gradient is 0 in exact arithmetic (softmax ignores a
    shift every key shares), so its rounding noise, another on each side,
    is all the first step of 8-bit Adam and CAME sees there."""
    import numpy as np
    import torch

    from stableavatar_tpu_torch.config import tiny_debug_configs
    from stableavatar_tpu_torch.models.dit import init_dit
    from stableavatar_tpu_torch.train import trainer
    from stableavatar_tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths

    cfg = tiny_debug_configs()[0]
    gen = torch.Generator().manual_seed(0)
    params = init_dit(gen, cfg, "cpu")
    head = params["head"]["head"]
    head["w"] = torch.randn(head["w"].shape, generator=gen) * 0.05
    for bp in params["blocks"]:
        for k in ("k_vocal", "v_vocal"):
            bp["cross_attn"][k]["w"] = torch.randn(bp["cross_attn"][k]["w"].shape,
                                                   generator=gen) * 0.1
    rng = np.random.default_rng(7)
    f, h, w = 3, 8, 8
    shapes = {"latents": (1, cfg.out_dim, f, h, w),
              "inpaint_latents": (1, cfg.in_dim - cfg.out_dim, f, h, w),
              "prompt_embeds": (1, cfg.text_len, cfg.text_dim),
              "clip_fea": (1, cfg.clip_tokens, cfg.clip_dim),
              "vocal_embeddings": (1, 24, cfg.audio_in_dim)}
    batch = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    for k in ("face_masks", "lip_masks"):
        batch[k] = torch.from_numpy(rng.uniform(0, 1, (1, 1, f, h, w)).astype(np.float32))
    draws = {"noise": torch.from_numpy(rng.standard_normal(shapes["latents"]).astype(np.float32)),
             "idx": torch.tensor([600]), "mask_flag": torch.tensor(0.3)}
    # 8-bit Adam's first step is about g / (|g| + eps) an entry: eps above the
    # gradients' rounding noise, as the CPU tests take it
    tc = trainer.TrainConfig(learning_rate=1e-3, adam_eps=1e-6, video_sample_n_frames=9,
                             **OPTIMIZER_FLAGS[name])
    kept = [path.rsplit("/", 2)[-2:] not in (["k", "b"], ["k_img", "b"], ["k_vocal", "b"])
            for path, _ in tree_paths(params)]
    steps, losses = {}, {}
    dit_dtype = trainer.DIT_DTYPE
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    trainer.DIT_DTYPE = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            p = tree_map(lambda x: x.to(device, copy=True), params)
            tx = trainer.make_optimizer(tc)
            state = tx.init(tree_leaves(p))
            _, _, m = trainer.train_step(
                p, state, tree_map(lambda x: x.to(device), batch), None, False, dit_cfg=cfg,
                train_cfg=tc, tx=tx, sigmas_table=trainer.train_sigmas(device=device),
                draws=tree_map(lambda x: x.to(device), draws))
            losses[device] = float(m["loss"])
            steps[device] = torch.cat([(a.cpu() - b).reshape(-1) for a, b, k in zip(
                tree_leaves(p), tree_leaves(params), kept) if k])
    finally:
        trainer.DIT_DTYPE = dit_dtype
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    got, want = steps["cuda"], steps["cpu"]
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    log(f"  {name}: tiny fp32 train step, card vs CPU: loss {losses['cuda']:.7f} / "
        f"{losses['cpu']:.7f}, parameter updates rel_l2={rel:.3e} over {want.numel()} entries "
        f"(limit {OPTIMIZER_REL_TOL:.0e})")
    if not (torch.isfinite(got).all() and float(want.abs().max()) > 0
            and rel <= OPTIMIZER_REL_TOL):
        raise AssertionError(f"{name}: the card's tiny train step disagrees with the CPU's: "
                             f"rel_l2 {rel:.3e}")


def time_optimizer_updates(leaves, reps: int = 3):
    """CUDA-event ms of one `tx.update` of the train chain (the anomaly
    clip, then the optimizer) at 1.3B for AdamW, 8-bit Adam and CAME, on
    seeded bf16 gradients of the DiT's leaves: the median of `reps` after
    one warm-up, each optimizer from its own fresh state."""
    import torch

    from stableavatar_tpu_torch.train.trainer import TrainConfig, make_optimizer

    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = [(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3).to(p.dtype)
             for p in leaves]
    for name, flags in OPTIMIZER_FLAGS.items():
        tx = make_optimizer(TrainConfig(**flags))
        state = tx.init(leaves)
        times = []
        for _ in range(reps + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            updates, state = tx.update(grads, state, leaves)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            del updates
        ms = sorted(times[1:])[reps // 2]
        log(f"  optimizer update alone (tx.update), {name}: median {ms:.2f} ms of "
            f"{[round(t, 2) for t in times[1:]]} (warm-up {times[0]:.2f} ms), "
            f"{len(leaves)} leaves")
        del state
        torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


RING_W = 4  # ranks of the ring whose slice the kernels are checked at


def phase_ring_kernels(results):
    """K2-LSE in each V mode against its plain version at the DiT
    self-attention shape [3, 21504, 12, 128] (timed, with its bound) and at
    the 4-rank ring slice [3, 5376, 12, 128] (its key block of 1024 for
    "qkpv", as `flash_attention_with_stats` gives it); K2v-qkpv without LSE
    on the JAX package's blocks of 1536 (`flash_attention`) and 1024."""
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(7)
    n, d = 12, 128
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    for l in (21504, 21504 // RING_W):
        b = 3
        q, k, v = (_rand(gen, (b, l, n, d), torch.bfloat16) for _ in range(3))
        q8, k8, sqk = fa.prepare_int8(q, k, rope[:l], d ** -0.5)
        v8, sv = fa.quantize_v(v)
        tag = f"[{b},{l},{n},{d}] rope"
        pv_block = fa.jax_key_block(l, fa.STATS_BLOCK_K)
        fwd_ops = 4.0 * b * n * l * l * d
        for quant in ("qk", "qkv", "qkpv"):
            name = f"flash_fwd_int8_{quant}_lse"
            vin = v if quant == "qk" else v8

            def kernel():
                return fa._flash_int8_cuda(q8, k8, vin, sqk, None, quant=quant, sv=sv,
                                           with_lse=True, pv_block=pv_block)

            def plain():
                return fa._flash_int8_plain(q8, k8, vin, sqk, None, quant=quant, sv=sv,
                                            block_k=pv_block, out_dtype=torch.bfloat16,
                                            with_lse=True)

            (got, lse), (want, want_lse) = kernel(), plain()
            err = max(compare(f"{name} {tag}", got, want),
                      compare_lse(f"{name} {tag}", lse, want_lse))
            del got, lse, want, want_lse
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            ms = time_ms(kernel, 5)
            if l != 21504:
                log(f"  {name} {tag}: kernel {ms:.3f} ms (ring partial)")
                continue
            # Q.K^T int8; P.V bf16, or int8 for qkpv; bytes: q8, k8, int8 v
            # one each (bf16 v two), bf16 out two, the fp32 LSE four per row
            ops_int8 = fwd_ops if quant == "qkpv" else fwd_ops / 2
            vbytes = 2.0 if quant == "qk" else 1.0
            entry.update(ms=ms, plain_ms=time_ms(plain, 3), library_ms=None)
            entry["bound_ms"], entry["bound_by"] = bound_ms(
                fwd_ops - ops_int8, b * l * n * d * (1 + 1 + vbytes + 2.0) + 4.0 * b * n * l,
                ops_int8=ops_int8)
            log(f"  {name} {tag}: kernel {ms:.3f} ms, plain {entry['plain_ms']:.3f} ms, bound "
                f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}), library —")
        if l == 21504:
            for block in (1536, 1024):
                got = fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant="qkpv", sv=sv,
                                          pv_block=block)
                want = fa._flash_int8_plain(q8, k8, v8, sqk, None, quant="qkpv", sv=sv,
                                            block_k=block, out_dtype=torch.bfloat16)
                err = compare(f"flash_fwd_int8_qkpv {tag} key block {block}", got, want)
                entry = results.setdefault("flash_fwd_int8_qkpv", {"max_abs_err": 0.0})
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                del got, want
                log(f"  flash_fwd_int8_qkpv {tag} key block {block}: kernel "
                    f"{time_ms(lambda: fa._flash_int8_cuda(q8, k8, v8, sqk, None, quant='qkpv', sv=sv, pv_block=block), 5):.3f} ms")
        del q, k, v, q8, k8, v8
    torch.cuda.synchronize()


def phase_ring_merge():
    """Query slice 0 of [3, 21504, 12, 128] against the 4 key chunks of a
    4-rank ring: K1-LSE and K2-LSE ("qk") partials merged by the port's
    `merge_partials`, against K1 / K2 over all 21,504 keys (the JAX
    package's tests/test_sharding.py:265-310 at its real shape).  The int8
    partials quantise each chunk on its own slab scales, as the JAX ring
    does."""
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.ring_attention import merge_partials
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_apply_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, l, n, d = 3, 21504, 12, 128
    lw = l // RING_W
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    q, k, v = (_rand(gen, (b, l, n, d), torch.bfloat16) for _ in range(3))
    # rope first, as the ring path applies it (positions are global)
    q = rope_apply_split(q, rope).bfloat16()
    k = rope_apply_split(k, rope).bfloat16()
    qc = q[:, :lw].contiguous()
    for quant in ("none", "qk"):
        o = lse = None
        for ci in range(RING_W):
            kc, vc = (x[:, ci * lw:(ci + 1) * lw].contiguous() for x in (k, v))
            o_i, lse_i = fa.flash_attention_with_stats(qc, kc, vc, quant=quant, static_max=False)
            o, lse = (o_i, lse_i) if o is None else merge_partials(o, lse, o_i, lse_i)
        want = fa.flash_attention(qc, k, v, quant=quant, static_max=False)
        compare(f"ring merge of {RING_W} {'K1-LSE' if quant == 'none' else 'K2-LSE'} partials "
                f"[{b},{lw},{n},{d}] x {l} keys against {'K1' if quant == 'none' else 'K2'}",
                o, want, REL_TOL if quant == "none" else RING_INT8_REL_TOL)
    torch.cuda.synchronize()


def phase_ring_path(reset_counts, counts):
    """The multi-GPU path on one rank: `initialize_distributed` starts an
    NCCL group of 1, `make_mesh` its ('dp', 'fsdp', 'sp') mesh, and
    `ring_attention` runs each V mode at [3, 21504, 12, 128] (rope applied),
    one K2-LSE partial each; every output must equal the partial of
    `flash_attention_with_stats` on the same inputs.  Returns the run's
    launch counts."""
    import torch
    import torch.distributed as dist

    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.ring_attention import ring_attention
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_apply_split, rope_freqs_3d
    from stableavatar_tpu_torch.parallel.distributed import initialize_distributed
    from stableavatar_tpu_torch.parallel.mesh import make_mesh, mesh_context

    gen = torch.Generator(device="cuda").manual_seed(9)
    b, l, n, d = 3, 21504, 12, 128
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    q, k, v = (_rand(gen, (b, l, n, d), torch.bfloat16) for _ in range(3))
    q = rope_apply_split(q, rope).bfloat16()
    k = rope_apply_split(k, rope).bfloat16()
    t0 = time.perf_counter()
    if not initialize_distributed(f"localhost:{_free_port()}", 1, 0, device="cuda"):
        raise AssertionError("initialize_distributed did not start a process group")
    try:
        mesh = make_mesh(1, 1, 1, device_type="cuda")
        backend = dist.get_backend(mesh.get_group("sp"))
        log(f"  process group: backend {backend}, world {dist.get_world_size()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, started in "
            f"{time.perf_counter() - t0:.2f} s")
        if backend != "nccl":
            raise AssertionError(f"the card's process group runs {backend}, not nccl")
        outs = {}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with mesh_context(mesh), torch.no_grad():
            for quant in ("qk", "qkv", "qkpv"):
                outs[quant] = ring_attention(q, k, v, group=mesh.get_group("sp"), quant=quant)
        torch.cuda.synchronize()
        launches = counts()
        log(f"  ring_attention on 1 rank, 3 V modes: {time.perf_counter() - t0:.3f} s; "
            f"launches {launches}")
        for quant, out in outs.items():
            want, _ = fa.flash_attention_with_stats(q, k, v, quant=quant, static_max=False)
            if not (torch.isfinite(out).all() and torch.equal(out, want)):
                raise AssertionError(f"ring_attention quant={quant} on 1 rank differs from its "
                                     "K2-LSE partial")
            log(f"  ring_attention quant={quant} on 1 rank: equal to its K2-LSE partial, "
                f"{tuple(out.shape)} {out.dtype}")
    finally:
        dist.destroy_process_group()
    want = {name: 1 for name in RING_KERNELS}
    want.update(flash_fwd_int8_qk=0, flash_fwd_int8_qkv=0, flash_fwd_int8_qkpv=0)
    if {key: launches[key] for key in want} != want:
        raise AssertionError(f"ring path launch counts {launches} != {want}")
    return launches


# phase 11: the entry points of the remaining kernels.  K1-rope is one
# `rope_rotate` and one K1 launch, K4-rope one fused K4 and one
# `rope_finalize_bwd`: their rows count the K1 / K4 launches that ran
# behind a rotation in the rope path's run
ROPE_KERNELS = ("rope_rotate", "rope_finalize_bwd", "flash_fwd_bf16_rope",
                "flash_fwd_bf16_rope_lse", "flash_bwd_rope")
PROBE_KERNELS = ("mm_probe_bf16", "mm_probe_int8", "mm_probe_requant", "mm_probe_scaled",
                 "dots_probe_bf16", "dots_probe_int8")


def require_equal(name: str, got, want) -> None:
    """Raise unless two results are equal bit for bit."""
    import torch

    for a, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        if not torch.equal(a, w):
            raise AssertionError(f"{name}: not equal bit for bit "
                                 f"(max_abs {float((a.float() - w.float()).abs().max()):.3e})")
    log(f"  {name}: equal bit for bit")


def phase_rope_kernels(results, l=21504, grid=(21, 32, 32)):
    """K1-rope (with and without its LSE) and K4-rope against their plain
    versions (rotate, plain K1 / K4, inverse-rotate dQ and dK) and against
    the same functions composed out of the rope kernels (the rotation in
    PyTorch then K1; K4 then the inverse rotation in PyTorch), which they
    must equal bit for bit: at the DiT self-attention shape [3, 21504, 12,
    128] for the forward, the training shape [1, 21504, 12, 128] for
    K1-rope-LSE and K4-rope, and ragged cases (one with one query split and
    whole key blocks past k_lens).  The two passes of `csrc/rope.cu`
    (`rope_rotate`, `rope_finalize_bwd`) must equal their plain versions
    exactly and are timed beside their byte bounds and those versions (two
    and three PyTorch passes)."""
    import torch

    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_apply_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    n, d = 12, 128
    rope = pack_split(rope_freqs_3d(grid, d, device="cuda"))
    table_bytes = 4.0 * l * d

    def record(name, err, ms=None, plain_ms=None, bound=None, tag="", composed_ms=None):
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if ms is not None:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                         library_ms=None)
            if composed_ms is not None:
                entry["out_of_kernel_ms"] = composed_ms
            log(f"  {name} {tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound[0]:.3f} ms ({bound[1]}), library —"
                + ("" if composed_ms is None else f", out of the kernels {composed_ms:.3f} ms"))

    # K1-rope and rope_rotate at the DiT self-attention shape
    b = 3
    q, k, v = (_rand(gen, (b, l, n, d), bf16) for _ in range(3))
    scale = d ** -0.5
    tag = f"[{b},{l},{n},{d}]"
    qk_bytes = 2.0 * b * l * n * d * 2  # q and k, bf16

    def torch_rotation():
        return rope_apply_split(q, rope).to(bf16), rope_apply_split(k, rope).to(bf16)

    rotated = fa._rope_rotate_cuda(q, k, rope)
    require_equal(f"rope_rotate {tag} against rope_apply_split x 2 + cast", rotated,
                  torch_rotation())
    record("rope_rotate", 0.0, time_ms(lambda: fa._rope_rotate_cuda(q, k, rope), 20),
           time_ms(torch_rotation, 5), bound_ms(0.0, 2 * qk_bytes + table_bytes), tag)
    del rotated
    got = fa._flash_fwd_cuda(q, k, v, None, scale, rope=rope)
    want = fa._flash_fwd_plain(q, k, v, None, scale, rope=rope)
    err = compare(f"flash_fwd_bf16 rope {tag}", got, want)
    del want

    def out_of_kernel():
        return fa._flash_fwd_cuda(*torch_rotation(), v, None, scale)

    require_equal(f"rope_apply_split x 2 + flash_fwd_bf16 {tag} against K1-rope",
                  out_of_kernel(), got)
    fwd_ops = 4.0 * b * n * l * l * d
    record("flash_fwd_bf16_rope", err,
           time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale, rope=rope), 5),
           time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, scale, rope=rope), 3),
           bound_ms(fwd_ops, 2.0 * 4 * b * l * n * d + table_bytes), tag,
           time_ms(out_of_kernel, 5))
    log(f"  K1 alone {tag}: {time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale), 5):.3f} ms")
    del q, k, v, got

    # K1-rope-LSE and K4-rope at the training shape, and ragged cases
    for (b, l_, n_, d_), k_lens in (((1, l, n, d), None), ((2, 3000, 2, 128), [2500, 3000]),
                                    ((1, 2100, 3, 64), None),
                                    ((2, 8192, 4, 64), [5000, 8192])):
        q, k, v, do = (_rand(gen, (b, l_, n_, d_), bf16) for _ in range(4))
        kl = None if k_lens is None else torch.tensor(k_lens, dtype=torch.int32, device="cuda")
        # the ragged cases take a table of F x 32 x 32 positions
        tbl = rope if (b, l_) == (1, l) else pack_split(
            rope_freqs_3d((max(3, -(-l_ // 1024)), 32, 32), d_, device="cuda"))
        scale = d_ ** -0.5
        tag = f"[{b},{l_},{n_},{d_}]" + ("" if k_lens is None else f" k_lens={k_lens}")
        out, lse = fa._flash_fwd_cuda(q, k, v, kl, scale, with_lse=True, rope=tbl)
        want_out, want_lse = fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True, rope=tbl)
        err_fwd = max(compare(f"flash_fwd_bf16_lse rope {tag}", out, want_out),
                      compare_lse(f"flash_fwd_bf16_lse rope {tag}", lse, want_lse))
        del want_out, want_lse
        qr, kr = fa._rope_rotate_cuda(q, k, tbl)

        def fwd_out_of_kernel():
            return fa._flash_fwd_cuda(fa._rope_rows(q, tbl), fa._rope_rows(k, tbl), v, kl, scale,
                                      with_lse=True)

        require_equal(f"rope_apply_split x 2 + flash_fwd_bf16_lse {tag} against K1-rope-LSE",
                      fwd_out_of_kernel(), (out, lse))

        def k4_rope():
            return fa._flash_bwd_cuda(qr, kr, v, kl, out, lse, do, scale, rope=tbl)

        def bwd_out_of_kernel():
            # the fused K4 with fp32 dK / dV, then the inverse rotation in PyTorch
            finalize = fa._rope_finalize_cuda
            fa._rope_finalize_cuda = lambda *a: fa._rope_finalize_plain(*a, bf16)
            try:
                return k4_rope()
            finally:
                fa._rope_finalize_cuda = finalize

        grads = k4_rope()
        want = fa._flash_bwd_plain(qr, kr, v, kl, out, lse, do, scale, rope=tbl)
        errs = [compare_grad(f"flash_bwd rope {name} {tag}", g, w)
                for name, g, w in zip(("dq", "dk", "dv"), grads, want)]
        del want
        # dK, dV: fixed summation order; dQ's bulk additions change order
        composed = bwd_out_of_kernel()
        require_equal(f"flash_bwd + rope_apply_split_inv (dk, dv) {tag} against K4-rope",
                      grads[1:], composed[1:])
        compare_grad(f"flash_bwd + rope_apply_split_inv (dq) {tag} against K4-rope",
                     grads[0], composed[0])
        require_equal(f"flash_bwd dv {tag} against K4-rope's", grads[2],
                      fa._flash_bwd_cuda(qr, kr, v, kl, out, lse, do, scale)[2])
        del grads, composed
        if (b, l_) != (1, l):
            record("flash_fwd_bf16_rope_lse", err_fwd)
            record("flash_bwd_rope", max(errs))
            continue
        prod = 2.0 * b * n_ * l_ * l_ * d_
        qkvo = 2.0 * b * n_ * d_ * 4 * l_
        stats = 4.0 * b * n_ * l_ * 2
        record("flash_fwd_bf16_rope_lse", err_fwd,
               time_ms(lambda: fa._flash_fwd_cuda(q, k, v, kl, scale, with_lse=True, rope=tbl), 5),
               time_ms(lambda: fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True, rope=tbl), 3),
               bound_ms(2 * prod, qkvo + stats / 2 + table_bytes), tag,
               time_ms(fwd_out_of_kernel, 5))
        # K4-rope: S, dP, dV, dK, dQ (five products); q, dO in and dq out, k,
        # v in and dk, dv out (bf16), lse and delta, the table once
        record("flash_bwd_rope", max(errs), time_ms(k4_rope, 5),
               time_ms(lambda: fa._flash_bwd_plain(qr, kr, v, kl, out, lse, do, scale,
                                                   rope=tbl), 3),
               bound_ms(5 * prod, 2.0 * b * n_ * d_ * 7 * l_ + stats + table_bytes), tag,
               time_ms(bwd_out_of_kernel, 5))
        k1_ms = time_ms(lambda: fa._flash_fwd_cuda(qr, kr, v, kl, scale, with_lse=True), 5)
        k4_ms = time_ms(lambda: fa._flash_bwd_cuda(qr, kr, v, kl, out, lse, do, scale), 5)
        log(f"  K1-LSE alone {tag}: {k1_ms:.3f} ms, K4 alone {k4_ms:.3f} ms")
        # rope_finalize_bwd on fp32 sums of the training shape
        g32 = [torch.randn((b, l_, n_, d_), generator=gen, device="cuda") for _ in range(3)]
        require_equal(f"rope_finalize_bwd {tag} against rope_apply_split_inv x 2 + casts",
                      fa._rope_finalize_cuda(*g32, tbl), fa._rope_finalize_plain(*g32, tbl, bf16))
        record("rope_finalize_bwd", 0.0, time_ms(lambda: fa._rope_finalize_cuda(*g32, tbl), 20),
               time_ms(lambda: fa._rope_finalize_plain(*g32, tbl, bf16), 5),
               bound_ms(0.0, (4.0 + 2.0) * 3 * b * l_ * n_ * d_ + table_bytes), tag)
        del g32
    del q, k, v, do, out, lse, qr, kr
    torch.cuda.synchronize()


def phase_gelu_kernel(results):
    """The FFN's tanh-GELU pass (`sa_gelu_tanh`) and its backward
    (`sa_gelu_tanh_bwd`) on the DiT's fc1 products at 1.3B [64512, 8960] and
    14B [64512, 13824]: equal bit for bit to the composition run by PyTorch
    (nine passes) and to autograd through it, then timed beside the byte
    bound (x read once, the result written once; the backward reads g too),
    the composition ("plain") and PyTorch's one-pass
    `F.gelu(approximate="tanh")` ("library": it rounds once, so the port
    does not call it)."""
    import torch
    import torch.nn.functional as F

    from stableavatar_tpu_torch.ops import activations as act

    gen = torch.Generator(device="cuda").manual_seed(19)
    entry = results.setdefault("gelu_tanh", {"max_abs_err": 0.0})
    entry_bwd = results.setdefault("gelu_tanh_bwd", {"max_abs_err": 0.0})
    for rows, c, model in ((64512, 8960, "WAN_1_3B"), (64512, 13824, "WAN_14B")):
        x = _rand(gen, (rows, c), torch.bfloat16) * 2
        g = _rand(gen, (rows, c), torch.bfloat16)
        out = torch.empty_like(x)
        tag = f"[{rows},{c}]"
        require_equal(f"gelu_tanh {tag} against the composition", act._gelu_tanh_cuda(x, out),
                      act._gelu_tanh_plain(x))
        xg = x.clone().requires_grad_()
        (want,) = torch.autograd.grad(act._gelu_tanh_plain(xg), xg, g)
        del xg
        require_equal(f"gelu_tanh_bwd {tag} against autograd through the composition",
                      act._gelu_tanh_bwd_cuda(x, g), want)
        del want
        ms = time_ms(lambda: act._gelu_tanh_cuda(x, out), 20)
        ms_bwd = time_ms(lambda: act._gelu_tanh_bwd_cuda(x, g), 20)
        plain = time_ms(lambda: act._gelu_tanh_plain(x), 5)
        library = time_ms(lambda: F.gelu(x, approximate="tanh"), 20)
        bound = bound_ms(0.0, 2.0 * 2 * rows * c)
        bound_bwd = bound_ms(0.0, 2.0 * 3 * rows * c)
        log(f"  gelu_tanh {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms, library {library:.3f} "
            f"ms, bound {bound[0]:.3f} ms ({bound[1]}); backward {ms_bwd:.3f} ms, bound "
            f"{bound_bwd[0]:.3f} ms")
        if model == "WAN_1_3B":
            entry.update(ms=ms, plain_ms=plain, library_ms=library, bound_ms=bound[0],
                         bound_by=bound[1])
            entry_bwd.update(ms=ms_bwd, bound_ms=bound_bwd[0], bound_by=bound_bwd[1])
        entry.setdefault("shapes", []).append(dict(
            shape=[rows, c], model=model, ms=ms, plain_ms=plain, library_ms=library,
            bound_ms=bound[0], bound_by=bound[1]))
        entry_bwd.setdefault("shapes", []).append(dict(
            shape=[rows, c], model=model, ms=ms_bwd, bound_ms=bound_bwd[0],
            bound_by=bound_bwd[1]))
        del x, g, out
    torch.cuda.empty_cache()


def phase_probe_kernels(results):
    """The probes against their plain versions on one call with sane inputs
    (the scripts' chains overflow): the GEMM's four epilogues at the
    scripts' [21504, 1536] . [1536, 1536] (int8 outputs equal on the
    scripts' own int8 inputs; bf16 within REL_TOL and ABS_TOL with `a`
    scaled by K^-1/2, so that the outputs have the unit size the absolute
    bound assumes), with `torch.matmul` (bf16) and `torch._int_mm` (int8, B
    taken column-major as cuBLASLt wants it, prepared outside the timing) as
    library yardsticks; the dots probes at S3's [36, 21504, 128], their
    inputs scaled for unit-size P and outputs in the same way (S3's time
    moves with its data: `log_softmax_shares` times it again on the forward
    kernels' own operands)."""
    import torch

    from stableavatar_tpu_torch.ops import probes
    from stableavatar_tpu_torch.scripts import bench_attn_blocks as s3
    from stableavatar_tpu_torch.scripts import microbench_int8 as s1

    a16, b16, a8, b8 = s1.inputs()
    m, kk, n = s1.M, s1.K, s1.N
    a16 = (a16.float() * kk ** -0.5).bfloat16()
    ops = 2.0 * m * kk * n
    b8_cm = b8.t().contiguous().t()
    lib = {"bf16": time_ms(lambda: torch.matmul(a16, b16), 20),
           "int8": time_ms(lambda: torch._int_mm(a8, b8_cm), 20),
           # the same row-major B the kernel reads, turned inside the call
           "int8_transpose": time_ms(lambda: torch._int_mm(a8, b8.t().contiguous().t()), 20)}
    for epilogue in probes.EPILOGUES:
        name = f"mm_probe_{epilogue}"
        a, b = (a16, b16) if epilogue == "bf16" else (a8, b8)
        got, want = probes.mm_probe(a, b, epilogue), probes._mm_plain(a, b, epilogue)
        tag = f"[{m},{kk}] . [{kk},{n}]"
        if epilogue == "bf16":
            err = compare(f"{name} {tag}", got, want)
            bound = bound_ms(ops, 2.0 * (m * kk + kk * n + m * n))
        else:
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {tag}: the int8 outputs differ from the plain "
                                     f"version in {int((got != want).sum())} places")
            err = 0.0
            log(f"  {name} {tag}: equal to its plain version (exact integer sums)")
            out_bytes = 2.0 if epilogue == "scaled" else 1.0
            bound = bound_ms(0.0, m * kk + kk * n + out_bytes * m * n, ops_int8=ops)
        library = lib["bf16" if epilogue == "bf16" else "int8"]
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry.update(max_abs_err=err, ms=time_ms(lambda: probes.mm_probe(a, b, epilogue), 20),
                     plain_ms=time_ms(lambda: probes._mm_plain(a, b, epilogue), 5),
                     bound_ms=bound[0], bound_by=bound[1], library_ms=library)
        if epilogue != "bf16":
            entry["library_with_transpose_ms"] = lib["int8_transpose"]
        log(f"  {name} {tag}: kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
            f"bound {bound[0]:.3f} ms ({bound[1]}), library {library:.3f} ms"
            + ("" if epilogue == "bf16" else
               f" ({lib['int8_transpose']:.3f} ms with B turned inside the call)"))
    ratio = results["mm_probe_int8"]["ms"] / results["mm_probe_bf16"]["ms"]
    log(f"  int8 : bf16 GEMM time: mm_probe {ratio:.3f}, "
        f"cuBLAS (_int_mm : matmul) {lib['int8'] / lib['bf16']:.3f}")
    del a16, b16, a8, b8, b8_cm
    phase_probe_linears(results)

    gen = torch.Generator(device="cuda").manual_seed(12)
    bh, l, d = s3.B * s3.N, s3.L, s3.D
    fwd_ops = 4.0 * bh * l * l * d
    # P of unit size (bf16: q, k times D^-1/4; int8: |q8 . k8| >> 7 about 1)
    # and V times L^-1/2: unit-size outputs
    v = (_rand(gen, (bh, l, d), torch.float32) * l ** -0.5).bfloat16()
    for int8 in (False, True):
        name = f"dots_probe_{'int8' if int8 else 'bf16'}"
        if int8:
            q, k = ((_rand(gen, (bh, l, d), torch.float32) * 3.4).to(torch.int8)
                    for _ in range(2))
            bound = bound_ms(fwd_ops / 2, bh * l * d * (1 + 1 + 2 + 2.0), ops_int8=fwd_ops / 2)
        else:
            q, k = ((_rand(gen, (bh, l, d), torch.float32) * d ** -0.25).bfloat16()
                    for _ in range(2))
            bound = bound_ms(fwd_ops, 2.0 * 4 * bh * l * d)
        tag = f"[{bh},{l},{d}]"
        err = compare(f"{name} {tag}", probes.dots_probe(q, k, v, int8=int8),
                      probes._dots_plain(q, k, v, int8))
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry.update(max_abs_err=err, ms=time_ms(lambda: probes.dots_probe(q, k, v, int8=int8), 5),
                     plain_ms=time_ms(lambda: probes._dots_plain(q, k, v, int8), 3),
                     bound_ms=bound[0], bound_by=bound[1], library_ms=None)
        log(f"  {name} {tag}: kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
            f"bound {bound[0]:.3f} ms ({bound[1]}), library —")
        del q, k
    torch.cuda.synchronize()


# the DiT's linear shapes at one window's 21504 tokens: (M, K, N)
DIT_LINEAR_SHAPES = ((21504, 1536, 8960), (21504, 8960, 1536))


def phase_probe_linears(results):
    """The GEMM probe's four epilogues at the DiT's linear shapes against
    its plain version (int8 outputs exactly; bf16 within REL_TOL and ABS_TOL,
    `a` scaled by K^-1/2), each timed beside `torch.matmul` or
    `torch._int_mm` (B column-major, prepared outside the timing, and turned
    inside it): entries of the kernels' "shapes"."""
    import torch

    from stableavatar_tpu_torch.ops import probes

    gen = torch.Generator(device="cuda").manual_seed(13)
    for m, kk, n in DIT_LINEAR_SHAPES:
        a16 = (_rand(gen, (m, kk), torch.float32) * kk ** -0.5).bfloat16()
        b16 = _rand(gen, (kk, n), torch.bfloat16)
        a8, b8 = ((_rand(gen, shape, torch.float32) * 40).clamp(-127, 127).to(torch.int8)
                  for shape in ((m, kk), (kk, n)))
        b8_cm = b8.t().contiguous().t()
        lib = {"bf16": time_ms(lambda: torch.matmul(a16, b16), 20),
               "int8": time_ms(lambda: torch._int_mm(a8, b8_cm), 20),
               "int8_transpose": time_ms(lambda: torch._int_mm(a8, b8.t().contiguous().t()), 20)}
        ops = 2.0 * m * kk * n
        tag = f"[{m},{kk}] . [{kk},{n}]"
        for epilogue in probes.EPILOGUES:
            name = f"mm_probe_{epilogue}"
            a, b = (a16, b16) if epilogue == "bf16" else (a8, b8)
            got, want = probes.mm_probe(a, b, epilogue), probes._mm_plain(a, b, epilogue)
            if epilogue == "bf16":
                err = compare(f"{name} {tag}", got, want)
                bound = bound_ms(ops, 2.0 * (m * kk + kk * n + m * n))
            else:
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {tag}: the int8 outputs differ from the plain "
                                         f"version in {int((got != want).sum())} places")
                err = 0.0
                out_bytes = 2.0 if epilogue == "scaled" else 1.0
                bound = bound_ms(0.0, m * kk + kk * n + out_bytes * m * n, ops_int8=ops)
            del got, want
            ms = time_ms(lambda: probes.mm_probe(a, b, epilogue), 20)
            shape = dict(shape=[m, kk, n], ms=ms, bound_ms=bound[0], bound_by=bound[1],
                         library_ms=lib["bf16" if epilogue == "bf16" else "int8"])
            if epilogue != "bf16":
                shape["library_with_transpose_ms"] = lib["int8_transpose"]
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry.setdefault("shapes", []).append(shape)
            log(f"  {name} {tag}: kernel {ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), "
                f"library {shape['library_ms']:.3f} ms"
                + ("" if epilogue == "bf16" else
                   f" ({lib['int8_transpose']:.3f} ms with B turned inside the call)"))
        del a16, b16, a8, b8, b8_cm
    torch.cuda.synchronize()


def phase_remaining_paths(l=21504, grid=(21, 32, 32)):
    """The entry points of the remaining kernels, each driven with every
    launch count set to 0 just before it and checked exactly just after:
    `flash_attention(rope=)` forward at [3, 21504, 12, 128] (its output
    equal to K1-rope's: `rope_rotate` + K1), `flash_attention_with_stats(
    rope=)`, the same under
    autograd at [1, 21504, 12, 128] (finite gradients), and each probe
    script's `main` with its own CH.  Returns the launches per kernel."""
    import contextlib
    import io

    import torch

    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops import probes
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d
    from stableavatar_tpu_torch.scripts import bench_attn_blocks as s3
    from stableavatar_tpu_torch.scripts import microbench_int8 as s1
    from stableavatar_tpu_torch.scripts import microbench_int8_variants as s2

    tables = (fa.launch_counts, ca.launch_counts, probes.launch_counts)
    launches = {}

    def drive(what, fn, want, rows=()):
        """Run fn with every count at 0 and require the counts `want`; the
        launches of each kernel named in `rows` ({row: kernel}) also count
        for that row (K1 / K4 behind a rotation: K1-rope, K4-rope)."""
        for table in tables:
            for key in table:
                table[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {key: c for table in tables for key, c in table.items() if c}
        for line in printed.getvalue().splitlines():
            log(f"    {line}")
        log(f"  {what}: {seconds:.3f} s, launches {got}")
        if got != want:
            raise AssertionError(f"{what}: launch counts {got} != {want}")
        for key, c in [*got.items(), *((row, got[kernel]) for row, kernel in dict(rows).items())]:
            launches[key] = launches.get(key, 0) + c
        return result

    gen = torch.Generator(device="cuda").manual_seed(13)
    n, d = 12, 128
    rope = pack_split(rope_freqs_3d(grid, d, device="cuda"))
    q, k, v = (_rand(gen, (3, l, n, d), torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        out = drive(f"flash_attention(rope=) [3,{l},{n},{d}]",
                    lambda: fa.flash_attention(q, k, v, rope=rope),
                    {"rope_rotate": 1, "flash_fwd_bf16": 1},
                    {"flash_fwd_bf16_rope": "flash_fwd_bf16"})
        if not torch.equal(out, fa._flash_fwd_cuda(q, k, v, None, d ** -0.5, rope=rope)):
            raise AssertionError("flash_attention(rope=) differs from its K1-rope launches")
        out, lse = drive(f"flash_attention_with_stats(rope=) [3,{l},{n},{d}]",
                         lambda: fa.flash_attention_with_stats(q, k, v, rope=rope),
                         {"rope_rotate": 1, "flash_fwd_bf16_lse": 1},
                         {"flash_fwd_bf16_rope_lse": "flash_fwd_bf16_lse"})
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all() and lse.shape == (3, l, n)):
        raise AssertionError("flash_attention_with_stats(rope=): non-finite or misshapen output")
    del q, k, v, out, lse
    q, k, v = (_rand(gen, (1, l, n, d), torch.bfloat16).requires_grad_() for _ in range(3))
    g = _rand(gen, (1, l, n, d), torch.bfloat16)

    def train_step():
        fa.flash_attention(q, k, v, rope=rope).backward(g)

    drive(f"flash_attention(rope=) under autograd [1,{l},{n},{d}]", train_step,
          {"rope_rotate": 1, "flash_fwd_bf16_lse": 1, "flash_bwd": 1, "rope_finalize_bwd": 1},
          {"flash_fwd_bf16_rope_lse": "flash_fwd_bf16_lse", "flash_bwd_rope": "flash_bwd"})
    if not all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v)):
        raise AssertionError("flash_attention(rope=): non-finite gradients")
    del q, k, v, g
    torch.cuda.empty_cache()

    drive(f"scripts.microbench_int8.main (CH {s1.CH})", s1.main,
          {"mm_probe_bf16": 2 * s1.CH, "mm_probe_int8": 2 * s1.CH})
    drive(f"scripts.microbench_int8_variants.main (CH {s2.CH})", s2.main,
          {"mm_probe_requant": 2 * s2.CH, "mm_probe_scaled": 2 * s2.CH,
           "mm_probe_bf16": 2 * s2.CH})
    drive(f"scripts.bench_attn_blocks.main (CH {s3.CH})", lambda: s3.main([]),
          {"dots_probe_bf16": 2 * s3.CH, "dots_probe_int8": 2 * s3.CH,
           "flash_fwd_bf16": 2 * s3.CH})
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 12-15: the single clip, checkpoints, 14B, sequential offload
# ---------------------------------------------------------------------------


def one_window_inputs(cfg, seed=0):
    """Seeded inputs of one 81-frame clip at 512x512: a reference image, 81
    video frames of 16 kHz audio and a pre-encoded text context."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return dict(
        ref_image=rng.standard_normal((1, 3, 512, 512)).astype(np.float32) * 0.2,
        vocal_waveform=rng.standard_normal(81 * (16000 // 25)).astype(np.float32) * 0.05,
        text_ctx=torch.as_tensor(rng.standard_normal((3, cfg.text_len, cfg.text_dim)),
                                 dtype=torch.bfloat16, device="cuda"))


def check_video(name, video, shape):
    import numpy as np

    if video.shape != shape or not (np.isfinite(video).all() and video.min() >= 0.0
                                    and video.max() <= 1.0):
        raise AssertionError(f"{name}: video {video.shape} is not finite [0, 1] of {shape}")
    log(f"  {name}: video {video.shape} mean {video.mean():.4f} std {video.std():.4f}")


def check_launches(name, launches, want):
    got = {k: launches[k] for k in want}
    log(f"  {name} launches: {got}")
    if got != want:
        raise AssertionError(f"{name}: launch counts {got} != {want}")


def phase_single_clip(models, dit_bf16, reset_counts, counts):
    """generate_single_clip at 1.3B / 512x512 / 81 frames: 2 Euler steps on
    the fast path (30 K2 and 30 K5 a step), one on the bf16 path (90 K1),
    and the training loop's log_validation (one bf16 step, a written clip).
    Returns the runs' launch counts."""
    import dataclasses

    import torch

    from stableavatar_tpu_torch.pipelines.single_clip import generate_single_clip
    from stableavatar_tpu_torch.train.loop import log_validation

    cfg, layers = models.dit_cfg, models.dit_cfg.num_layers
    inputs = one_window_inputs(cfg, seed=12)
    bf16 = dataclasses.replace(models, dit_params=dit_bf16, rope_split=False, attn_quant="none")
    runs = {}
    for name, m, steps, want in (
            ("fast path, Euler, 2 steps", models, 2,
             {"flash_fwd_int8_qk": 2 * layers, "dual_context": 2 * layers, "flash_fwd_bf16": 0}),
            ("bf16, Euler, 1 step", bf16, 1,
             {"flash_fwd_bf16": 3 * layers, "flash_fwd_int8_qk": 0, "dual_context": 0})):
        marks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate_single_clip(
            m, num_inference_steps=steps, seed=42, step_callback=lambda i, x: (
                torch.cuda.synchronize(), marks.append(time.perf_counter())), **inputs)
        torch.cuda.synchronize()
        launches = counts()
        wall = time.perf_counter() - t0
        step_s = [round(b - a, 3) for a, b in zip([t0] + marks, marks)]
        log(f"  single clip, {name}: {wall:.2f} s (steps {step_s} s, the first with the "
            f"conditioning), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_launches(f"single clip, {name}", launches, want)
        check_video(f"single clip, {name}", out.videos, (1, 3, 81, 512, 512))
        if not torch.isfinite(out.latents).all():
            raise AssertionError("single-clip latents are not finite")
        runs[name] = launches
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_validation_")
    try:
        reset_counts()
        t0 = time.perf_counter()
        path = log_validation(bf16, dict(inputs, num_inference_steps=1, clip_length=81), out_dir, 1)
        torch.cuda.synchronize()
        launches = counts()
        written = os.listdir(path) if os.path.isdir(path) else [path]
        log(f"  log_validation: {time.perf_counter() - t0:.2f} s, wrote {path} "
            f"({len(written)} files)")
        check_launches("log_validation", launches, {"flash_fwd_bf16": 3 * layers})
        if not written or (os.path.isdir(path) and len(written) != 81):
            raise AssertionError(f"log_validation wrote {written[:3]}...")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return runs


TRAIN_CLI_STEPS = 3
# log_validation's default step count (train/loop.py), which the CLI keeps
VALIDATION_STEPS = 20


def write_clip_dir(root, frames=81, size=512, seconds=4.0):
    """A clip directory as the train CLI reads it, under a path holding
    "speech" (the prompt comes from the path): `frames` PNGs in images/, face
    and lip masks of the same names, a 16 kHz audio.wav, the index txt; and a
    reference PNG and a driving wav for the validation.  Seeded; returns the
    index path."""
    import cv2
    import numpy as np

    from stableavatar_tpu_torch.utils.media import save_wav

    rng = np.random.default_rng(21)
    clip = os.path.join(root, "speech_clip_000")
    for sub in ("images", "face_masks", "lip_masks"):
        os.makedirs(os.path.join(clip, sub))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([yy, xx, 1 - yy], -1) * 200
    for i in range(frames):
        frame = base + rng.uniform(0, 55, (size, size, 3))
        cv2.imwrite(os.path.join(clip, "images", f"{i:05d}.png"), frame.astype(np.uint8))
        face = (((yy - 0.5) ** 2 + (xx - 0.5 - 0.002 * i) ** 2) < 0.09).astype(np.uint8) * 255
        lip = (((yy - 0.65) ** 2 + (xx - 0.5) ** 2 * 0.25) < 0.004).astype(np.uint8) * 255
        cv2.imwrite(os.path.join(clip, "face_masks", f"{i:05d}.png"), face)
        cv2.imwrite(os.path.join(clip, "lip_masks", f"{i:05d}.png"), lip)
    t = np.arange(int(16000 * seconds)) / 16000.0
    voice = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    save_wav(os.path.join(clip, "audio.wav"), voice, 16000)
    save_wav(os.path.join(root, "voice.wav"), voice, 16000)
    cv2.imwrite(os.path.join(root, "ref.png"), (base + 27).astype(np.uint8))
    index = os.path.join(root, "index.txt")
    with open(index, "w") as f:
        f.write(clip + "\n")
    return index


def phase_train_cli(reset_counts, counts):
    """The train CLI's main at 1.3B / 512x512 / 81 frames, batch 1, AdamW and
    remat (its defaults), umT5-xxl resident on the card encoding each
    batch's prompt, for TRAIN_CLI_STEPS steps from a clip directory on disk
    (2 decode threads), a checkpoint at the last step and one validation
    clip (log_validation, VALIDATION_STEPS bf16 steps, PNG frames without
    imageio).  Checks finite losses and gradient norms, moved parameters,
    the checkpoint, the metrics JSONL, the validation frames and the exact
    launch counts; logs load, step, loader-wait, memory, checkpoint and
    validation numbers.  Returns the run's launch counts."""
    import json as json_mod

    import numpy as np
    import torch

    from stableavatar_tpu_torch.cli import train as cli_train
    from stableavatar_tpu_torch.config import WAN_1_3B
    from stableavatar_tpu_torch.train import loop
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    root = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    out_dir = os.path.join(root, "run")
    marks = {"load_s": None, "steps": [], "ckpt": [], "validation_s": []}
    waits = [0.0]
    originals = (cli_train.load_models, cli_train.build_batches, cli_train.train,
                 loop.CheckpointManager._write, loop.log_validation)
    load_models, build_batches, train, write, log_validation = originals

    def timed_load(args, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = load_models(args, device)
        torch.cuda.synchronize()
        marks["load_s"] = time.perf_counter() - t0
        marks["models"] = models
        return models

    def timed_batches(args):
        it = build_batches(args)

        def gen():
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits[0] += time.perf_counter() - t0
                yield batch

        return gen()

    def timed_write(self, path, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write(self, path, state)
        marks["ckpt"].append((os.path.getsize(os.path.join(path, "state.pt")),
                              time.perf_counter() - t0))

    def timed_validation(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = log_validation(*a, **k)
        torch.cuda.synchronize()
        marks["validation_s"].append(time.perf_counter() - t0)
        marks["validation_path"] = path
        return path

    def traced_train(models, batches, tc, **kw):
        leaves = tree_leaves(models.dit_params)
        before = [p.clone() for p in leaves]
        last = {"t": time.perf_counter(), "wait": 0.0}

        def on_step(step, params, m):
            torch.cuda.synchronize()
            now = time.perf_counter()
            moved = sum(int(not torch.equal(p, b)) for p, b in zip(leaves, before))
            for p, b in zip(leaves, before):
                b.copy_(p)
            marks["steps"].append(dict(
                step=step, wall_s=now - last["t"], loader_wait_s=waits[0] - last["wait"],
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), moved_leaves=moved,
                clip_level=bool(m["is_clip_level_modeling"]),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            log(f"  step {step}: {now - last['t']:.3f} s wall (loader wait "
                f"{waits[0] - last['wait']:.3f} s, encode incl. umT5-xxl, step), loss "
                f"{float(m['loss']):.6f}, grad norm {float(m['grad_norm']):.6f}, {moved} of "
                f"{len(leaves)} leaves moved, clip-level {bool(m['is_clip_level_modeling'])}, "
                f"peak device memory {marks['steps'][-1]['peak_gib']:.2f} GiB [{CARD[0]}]")
            last["t"], last["wait"] = time.perf_counter(), waits[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        last["t"] = time.perf_counter()
        return train(models, batches, tc, step_callback=on_step, **kw)

    argv = ["--train_data_meta", "", "--video_sample_size", "512",
            "--video_sample_n_frames", "81", "--train_batch_size", "1",
            "--max_train_steps", str(TRAIN_CLI_STEPS), "--fps", "25",
            "--dataloader_num_workers", "2", "--log_every", "1",
            "--checkpointing_steps", str(TRAIN_CLI_STEPS), "--checkpoints_total_limit", "1",
            "--validation_steps", str(TRAIN_CLI_STEPS), "--output_dir", out_dir,
            "--seed", str(TRAIN_SEED)]
    try:
        t0 = time.perf_counter()
        index = write_clip_dir(root)
        argv[1] = index
        argv += ["--validation_reference_path", os.path.join(root, "ref.png"),
                 "--validation_driven_audio_path", os.path.join(root, "voice.wav")]
        log(f"  clip directory of 81 PNGs at 512x512 with face / lip masks and a 16 kHz wav "
            f"written in {time.perf_counter() - t0:.2f} s under {root}")
        (cli_train.load_models, cli_train.build_batches, cli_train.train,
         loop.CheckpointManager._write, loop.log_validation) = (
            timed_load, timed_batches, traced_train, timed_write, timed_validation)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_train.main(argv, device="cuda")
        torch.cuda.synchronize()
        launches = counts()
        wall = time.perf_counter() - t0
    finally:
        (cli_train.load_models, cli_train.build_batches, cli_train.train,
         loop.CheckpointManager._write, loop.log_validation) = originals
    try:
        models = marks.pop("models")
        t5 = tree_leaves(models.t5_params) if models.t5_params is not None else []
        t5_bytes = sum(p.numel() * p.element_size() for p in t5)
        resident = bool(t5) and all(p.is_cuda and p.dtype == torch.bfloat16 for p in t5)
        del models
        steps = marks["steps"]
        log(f"  main(): rc {rc}, {wall:.2f} s; load_models {marks['load_s']:.2f} s; umT5-xxl "
            f"resident on the card in bf16: {resident} ({t5_bytes / 2**30:.2f} GiB)")
        walls = [s["wall_s"] for s in steps]
        log(f"  train CLI step wall s {[round(w, 3) for w in walls]}, loader wait s "
            f"{[round(s['loader_wait_s'], 3) for s in steps]}, peak device memory "
            f"{max(s['peak_gib'] for s in steps):.2f} GiB with umT5-xxl resident [{CARD[0]}]")
        for nbytes, secs in marks["ckpt"]:
            log(f"  checkpoint: {nbytes / 1e9:.2f} GB written in {secs:.2f} s "
                f"({nbytes / 1e9 / secs:.2f} GB/s) [{CARD[0]}]")
        log(f"  log_validation: {[round(v, 2) for v in marks['validation_s']]} s "
            f"({VALIDATION_STEPS} bf16 steps, the decode and the frames) [{CARD[0]}]")
        if rc != 0 or not resident or len(steps) != TRAIN_CLI_STEPS or not np.isfinite(
                [[s["loss"], s["grad_norm"]] for s in steps]).all():
            raise AssertionError(f"train CLI: rc {rc}, T5 resident {resident}, steps {steps}")
        if not all(s["moved_leaves"] > 0 and s["grad_norm"] > 0 for s in steps):
            raise AssertionError(f"a train CLI step left the parameters unchanged: {steps}")
        ckpts = sorted(d for d in os.listdir(out_dir) if d.startswith("checkpoint-"))
        (metrics,) = [f for f in os.listdir(out_dir) if f.endswith(".metrics.jsonl")]
        with open(os.path.join(out_dir, metrics)) as f:
            losses = [json_mod.loads(line)["train_loss"] for line in f if line.strip()]
        path = marks.get("validation_path")
        frames = (len(os.listdir(path)) if path and os.path.isdir(path)
                  else int(bool(path and os.path.isfile(path))))
        log(f"  wrote {ckpts}, {len(losses)} losses in {metrics}, validation {path} "
            f"({frames} files)")
        if ckpts != [f"checkpoint-{TRAIN_CLI_STEPS}"] or len(losses) != TRAIN_CLI_STEPS \
                or not np.allclose(losses, [s["loss"] for s in steps]):
            raise AssertionError(f"train CLI output: {ckpts}, losses {losses}")
        if path is None or (os.path.isdir(path) and frames != 81) or frames == 0:
            raise AssertionError(f"train CLI validation wrote {path} ({frames} files)")
        layers = WAN_1_3B.num_layers
        n_clip = sum(s["clip_level"] for s in steps)
        calls = layers * (3 * TRAIN_CLI_STEPS + n_clip)
        check_launches("train CLI", launches, {
            "flash_fwd_bf16_lse": 2 * calls, "flash_bwd": calls,
            "flash_fwd_bf16": 3 * layers * VALIDATION_STEPS,
            "rope_rotate": 0, "rope_finalize_bwd": 0, "flash_fwd_int8_qk": 0,
            "flash_fwd_int8_static_qk": 0, "dual_context": 0})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches, steps


def wav2vec2_state_dict(params, cfg):
    """The port's wav2vec2 tree -> an HF `Wav2Vec2ForCTC` state dict ("wav2vec2."
    prefix, the position conv as a plain weight): what
    `--pretrained_wav2vec_path` reads."""
    sd = {}

    def put(name, p):
        sd[f"wav2vec2.{name}.weight"] = p["w"]
        if "b" in p:
            sd[f"wav2vec2.{name}.bias"] = p["b"]

    for i, c in enumerate(params["conv_layers"]):
        put(f"feature_extractor.conv_layers.{i}.conv", {"w": c["w"]})
        if "gn" in c:
            put(f"feature_extractor.conv_layers.{i}.layer_norm", c["gn"])
    put("feature_projection.layer_norm", params["feature_projection"]["norm"])
    put("feature_projection.projection", params["feature_projection"]["proj"])
    put("encoder.pos_conv_embed.conv", params["pos_conv"])
    put("encoder.layer_norm", params["encoder_norm"])
    for i, bp in enumerate(params["blocks"]):
        b = f"encoder.layers.{i}"
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            put(f"{b}.attention.{theirs}", bp["attn"][ours])
        put(f"{b}.layer_norm", bp["norm1"])
        put(f"{b}.feed_forward.intermediate_dense", bp["ffn"]["fc1"])
        put(f"{b}.feed_forward.output_dense", bp["ffn"]["fc2"])
        put(f"{b}.final_layer_norm", bp["norm2"])
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def trees_equal(a, b) -> bool:
    import torch

    from stableavatar_tpu_torch.utils.tree import tree_paths

    pa, pb = dict(tree_paths(a)), dict(tree_paths(b))
    return sorted(pa) == sorted(pb) and all(
        torch.equal(x, pb[k]) if torch.is_tensor(x) else x == pb[k] for k, x in pa.items())


def phase_checkpoints(models, dit_bf16, reset_counts, counts):
    """The CLI's checkpoint path at 1.3B: the random bf16 DiT written in
    Wan's layout as fp32 `diffusion_pytorch_model.safetensors` (as the
    published Wan2.1-1.3B file), a StableAvatar `.pt` override (vocal
    projector and vocal k / v redrawn, one tensor of another size) and an
    HF wav2vec2 directory, all through the port's exporters into a temp
    directory; then `load_models` with --pretrained_model_name_or_path,
    --transformer_path and --pretrained_wav2vec_path on the card.  The
    loaded DiT and wav2vec2 equal the written trees bit for bit, and one
    Euler window-step of generate_long on them equals the same step on the
    in-memory trees bit for bit.  Returns the window-steps' launch counts."""
    import dataclasses
    import json as json_mod

    import torch

    from stableavatar_tpu_torch.cli.inference import DIT_FILE, build_parser, load_models
    from stableavatar_tpu_torch.pipelines.long import generate_long
    from stableavatar_tpu_torch.utils import checkpoint as ckpt
    from stableavatar_tpu_torch.utils.tree import tree_map

    cfg = models.dit_cfg
    gen = torch.Generator(device="cuda").manual_seed(13)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        log(f"  {d}: {shutil.disk_usage(d).free / 1e9:.1f} GB free")
        t0 = time.perf_counter()
        sd = ckpt.export_dit_to_torch_state_dict(dit_bf16, cfg)
        base_path = os.path.join(d, DIT_FILE)
        ckpt.save_safetensors(sd, base_path)
        nbytes = os.path.getsize(base_path)
        log(f"  wrote {DIT_FILE}: {nbytes / 1e9:.2f} GB fp32 in {time.perf_counter() - t0:.2f} s")
        del sd
        # the fine-tuned override: the vocal parts redrawn; the head's
        # weight of another size, which the merge skips
        redraw = lambda x: (torch.randn(x.shape, generator=gen, device="cuda") * 0.02).to(x.dtype)
        tuned = dict(dit_bf16, vocal_projector=tree_map(redraw, dit_bf16["vocal_projector"]),
                     blocks=[dict(bp, cross_attn=dict(
                         bp["cross_attn"], k_vocal=tree_map(redraw, bp["cross_attn"]["k_vocal"]),
                         v_vocal=tree_map(redraw, bp["cross_attn"]["v_vocal"])))
                             for bp in dit_bf16["blocks"]])
        ov = {k: v.bfloat16() for k, v in ckpt.export_dit_to_torch_state_dict(tuned, cfg).items()}
        ov["head.head.weight"] = torch.zeros((3, 3), dtype=torch.bfloat16)
        ov_path = os.path.join(d, "transformer3d-square.pt")
        t0 = time.perf_counter()
        torch.save(ov, ov_path)
        log(f"  wrote {os.path.basename(ov_path)}: {os.path.getsize(ov_path) / 1e9:.2f} GB bf16 in "
            f"{time.perf_counter() - t0:.2f} s")
        del ov
        w2v_dir = os.path.join(d, "wav2vec2-base-960h")
        os.makedirs(w2v_dir)
        ckpt.save_safetensors(wav2vec2_state_dict(models.wav2vec_params, models.wav2vec_cfg),
                              os.path.join(w2v_dir, "model.safetensors"))
        with open(os.path.join(w2v_dir, "preprocessor_config.json"), "w") as f:
            json_mod.dump({"do_normalize": True, "sampling_rate": 16000}, f)

        for path in (base_path, ov_path):
            t0 = time.perf_counter()
            n = sum(v.numel() * v.element_size()
                    for v in ckpt.load_torch_state_dict(path).values())
            s = time.perf_counter() - t0
            log(f"  read {os.path.basename(path)}: {n / 1e9:.2f} GB in {s:.2f} s, "
                f"{n / 1e9 / s:.2f} GB/s")

        args = build_parser().parse_args([
            "--pretrained_model_name_or_path", d, "--transformer_path", ov_path,
            "--pretrained_wav2vec_path", w2v_dir, "--validation_prompts", "A person is talking"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_models(args, "cuda")
        torch.cuda.synchronize()
        log(f"  load_models from the checkpoints: {time.perf_counter() - t0:.2f} s (umT5-xxl "
            f"random, encoded, released; DiT {nbytes / 1e9:.2f} GB + override read, converted, "
            f"cast and copied)")
        want = dict(tuned, head=dit_bf16["head"])
        same_dit = trees_equal(loaded.dit_params, want)
        same_w2v = trees_equal(loaded.wav2vec_params, models.wav2vec_params)
        log(f"  loaded DiT equals the written tree with the override merged: {same_dit}; "
            f"wav2vec2 equals the written one: {same_w2v}")
        if not (same_dit and same_w2v):
            raise AssertionError("the loaded checkpoints differ from the written trees")
    finally:
        shutil.rmtree(d, ignore_errors=True)

    inputs = one_window_inputs(cfg, seed=13)
    memory = dataclasses.replace(loaded, dit_params=want)
    outs, runs = [], {}
    for name, m in (("loaded", loaded), ("in memory", memory)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = generate_long(m, num_inference_steps=1, overlap_window_length=OVERLAP, seed=42,
                            output_type="latent", **inputs)
        torch.cuda.synchronize()
        runs[name] = counts()
        log(f"  one Euler window-step of generate_long on the {name} trees: "
            f"{time.perf_counter() - t0:.2f} s with the conditioning")
        check_launches(f"window-step, {name}", runs[name], {"flash_fwd_bf16": 3 * cfg.num_layers})
        outs.append(out.latents)
    if not (torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])):
        raise AssertionError("the window-step on the loaded checkpoint differs from the "
                             "in-memory one")
    log(f"  window-step latents {tuple(outs[0].shape)}: loaded == in memory, bit for bit")
    return runs


K14B = (3, 21504, 40, 128)  # q / k / v of WAN_14B's self-attention at 512x512


def phase_kernels_14b(results):
    """K1, K2 and K5 at WAN_14B's shape [3, 21504, 40, 128] (TMA rows of
    10,240 B) against their plain versions, with time, bound and, for K1,
    SDPA's time: an entry of each kernel's "shapes"."""
    import torch

    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(14)
    b, l, n, d = K14B
    scale = d ** -0.5
    fwd_ops = 4.0 * b * n * l * l * d
    q, k, v = (_rand(gen, K14B, torch.bfloat16) for _ in range(3))
    tag = "[3,21504,40,128]"

    def entry(name, err, ms, plain, bound, library, **extra):
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        lib = "—" if library is None else f"{library:.3f} ms"
        log(f"  {name} {tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bound[0]:.3f} ms "
            f"({bound[1]}), library {lib}")
        r.setdefault("shapes", []).append(dict(shape=list(K14B), model="WAN_14B", ms=ms,
                                               plain_ms=plain, bound_ms=bound[0],
                                               bound_by=bound[1], library_ms=library, **extra))

    err = compare(f"flash_fwd_bf16 {tag}", fa._flash_fwd_cuda(q, k, v, None, scale),
                  fa._flash_fwd_plain(q, k, v, None, scale))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    entry("flash_fwd_bf16", err, time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale), 5),
          time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, scale), 2),
          bound_ms(fwd_ops, 2.0 * 4 * b * l * n * d),
          time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 5))
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    q8, k8, sqk = fa.prepare_int8(q, k, rope, scale)
    err = compare(f"flash_fwd_int8_qk {tag} rope", fa._flash_int8_cuda(q8, k8, v, sqk, None),
                  fa._flash_int8_plain(q8, k8, v, sqk))
    entry("flash_fwd_int8_qk", err, time_ms(lambda: fa._flash_int8_cuda(q8, k8, v, sqk, None), 5),
          time_ms(lambda: fa._flash_int8_plain(q8, k8, v, sqk), 2),
          bound_ms(fwd_ops / 2, b * l * n * d * (1 + 1 + 2 + 2.0), ops_int8=fwd_ops / 2), None)
    del q8, k8, sqk
    k1, v1 = (_rand(gen, (b, 512, n, d), torch.bfloat16) for _ in range(2))
    k2, v2 = (_rand(gen, (b, 257, n, d), torch.bfloat16) for _ in range(2))
    err = compare(f"dual_context {tag} x (512, 257)", ca._dual_cuda(q, k1, v1, k2, v2, scale),
                  ca._dual_plain(q, k1, v1, k2, v2, scale))
    entry("dual_context", err, time_ms(lambda: ca._dual_cuda(q, k1, v1, k2, v2, scale), 5),
          time_ms(lambda: ca._dual_plain(q, k1, v1, k2, v2, scale), 2),
          bound_ms(4.0 * b * n * l * (512 + 257) * d, 2.0 * b * n * d * (2 * l + 2 * (512 + 257))),
          None)
    del q, k, v, k1, v1, k2, v2
    torch.cuda.empty_cache()


ARGV_14B = ["--model_family", "14B", "--validation_prompts", "A person is talking to the camera",
            "--negative_prompts", "blurry, distorted"]


def run_14b_step(args_extra, reset_counts, counts, want):
    """load_models with --model_family 14B (and `args_extra`), then one
    Euler window-step of generate_long (81 frames, latent output), the
    launch counts set to 0 just before it.  Returns a dict: latents (on the
    host), launches, the step's seconds, the run's peak and the models'
    resident GiB, and the models."""
    import torch

    from stableavatar_tpu_torch.cli.inference import build_parser, load_models
    from stableavatar_tpu_torch.pipelines.long import generate_long
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    tag = " ".join(args_extra) or "bf16"
    args = build_parser().parse_args(ARGV_14B + args_extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = load_models(args, "cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"  load_models 14B {tag}: {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (umT5-xxl encoded and released "
        f"before the DiT loads), {resident:.2f} GiB on the card after")
    inputs = one_window_inputs(models.dit_cfg, seed=14)
    inputs["text_ctx"] = models.text_ctx
    marks = []

    def mark(i, x):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    timer = StepTimer("cuda")
    out = generate_long(models, num_inference_steps=1, overlap_window_length=OVERLAP, seed=42,
                        output_type="latent", step_callback=mark, timer=timer, **inputs)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step = timer.history["denoise_step"][0]
    log(f"  14B window-step {tag}: {step:.3f} s ({marks[0] - t0:.2f} s with the conditioning); "
        f"peak device memory of the run {peak:.2f} GiB")
    check_launches(f"14B {tag}", launches, want)
    if not torch.isfinite(out.latents).all():
        raise AssertionError("14B latents are not finite")
    return dict(latents=out.latents.cpu(), launches=launches, step_s=step, peak=peak,
                resident=resident, models=models)


def phase_14b(reset_counts, counts):
    """--model_family 14B through the CLI's load_models (umT5-xxl on the
    card, encoded, released; the DiT initialised leaf by leaf in bf16 on the
    card): one window-step with --fast_path linears (40 K2, 40 K5) and one
    on the bf16 path (120 K1).  Returns both runs' dicts (models dropped)."""
    import torch

    from stableavatar_tpu_torch.utils.tree import tree_leaves

    layers = 40
    runs = {}
    for name, extra, want in (
            ("fast", ["--fast_path", "linears"],
             {"flash_fwd_int8_qk": layers, "dual_context": layers, "flash_fwd_bf16": 0}),
            ("bf16", [], {"flash_fwd_bf16": 3 * layers, "flash_fwd_int8_qk": 0,
                          "dual_context": 0})):
        runs[name] = run_14b_step(extra, reset_counts, counts, want)
        dit = runs[name].pop("models").dit_params
        n = sum(x.numel() * x.element_size() for x in tree_leaves(dit))
        log(f"  WAN_14B DiT {name}: {n / 2**30:.2f} GiB on the card")
        del dit
        torch.cuda.empty_cache()
    return runs


def phase_sequential(resident, reset_counts, counts):
    """The 14B bf16 window-step under --GPU_memory_mode
    sequential_cpu_offload: the DiT's 40 blocks in pinned host memory,
    streamed two at a time.  Its latents equal the resident run's (phase
    14) bit for bit; its peak device memory is logged beside the resident
    run's and must stay below it less half the blocks' bytes; the blocks'
    H2D rate is timed alone, and the step beside the resident one says
    whether the copies hide behind compute.  Returns the launch counts."""
    import torch

    run = run_14b_step(["--GPU_memory_mode", "sequential_cpu_offload"], reset_counts, counts,
                       {"flash_fwd_bf16": 120, "flash_fwd_int8_qk": 0, "dual_context": 0})
    sd = run["models"].streamed_dit
    block_gib = sum(hb.nbytes for hb in sd.host_blocks) / 2**30
    log(f"  streamed DiT: {sd.num_layers} blocks, {block_gib:.2f} GiB in pinned host memory "
        f"(pinned: {sd.host_blocks[0].flat.is_pinned()}); on the card "
        f"{sd.resident_bytes / 2**30:.2f} GiB of non-block parameters and 2 slots of "
        f"{sd.slots[0].numel() / 2**30:.3f} GiB")
    log(f"  peak device memory of the 14B window-step: resident {resident['peak']:.2f} GiB, "
        f"streamed {run['peak']:.2f} GiB; on the card after loading: resident "
        f"{resident['resident']:.2f} GiB, streamed {run['resident']:.2f} GiB")
    if not sd.host_blocks[0].flat.is_pinned():
        raise AssertionError("the streamed blocks are not in pinned host memory")
    if not run["peak"] < resident["peak"] - block_gib / 2:
        raise AssertionError(f"streamed peak {run['peak']:.2f} GiB is not far below the "
                             f"resident {resident['peak']:.2f} GiB")
    same = torch.equal(run["latents"], resident["latents"])
    log(f"  streamed latents equal the resident run's bit for bit: {same}")
    if not same:
        raise AssertionError("the streamed 14B window-step differs from the resident one")
    # the blocks' host-to-device rate, the copies alone on a side stream
    stream = torch.cuda.Stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        start.record(stream)
        for i, hb in enumerate(sd.host_blocks):
            sd.slots[i % 2][:hb.nbytes].copy_(hb.flat, non_blocking=True)
        end.record(stream)
    torch.cuda.synchronize()
    s = start.elapsed_time(end) / 1e3
    exposed = run["step_s"] - resident["step_s"]
    log(f"  H2D of the {sd.num_layers} blocks alone: {block_gib * 2**30 / 1e9 / s:.2f} GB/s, "
        f"{s * 1e3 / sd.num_layers:.2f} ms a block, {s:.3f} s in all; streamed step "
        f"{run['step_s']:.3f} s - resident step {resident['step_s']:.3f} s = {exposed:.3f} s "
        f"({'the copies hide behind compute' if exposed < s / 2 else 'the copies show'})")
    launches = run["launches"]
    del run, sd
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 17. the serving app; 18. the preprocessing tools and the host scripts
# ---------------------------------------------------------------------------

APP_ARGV = ["--fast_path", "linears"]
APP_PROMPT = "A person is talking to the camera"
# MDX-Net's topology at Kim_Vocal_2's STFT geometry: 4 spectral channels in
# and out, [1, 4, 3072, 256] a segment; the net's width and TDF bottleneck
MDX_WIDTH, MDX_TDF_DIV, MDX_SECONDS = 32, 16, 30.0
# the ONNX runner on the card against the same runner on the CPU (fp32,
# TF32 off on both): relative L2 of the separated track
MDX_REL_TOL = 1e-4
QUALITY_LAYERS = 4  # quality_curves' depth: its 16 Euler / UniPC / TeaCache steps


def write_app_inputs(root):
    """A seeded 512x512 reference image and a 16 kHz voice that makes
    N_WINDOWS windows of 81 frames at overlap OVERLAP (105 video frames)."""
    import numpy as np
    from PIL import Image

    from stableavatar_tpu_torch.utils.media import save_wav

    rng = np.random.default_rng(17)
    img_path, wav_path = os.path.join(root, "ref.png"), os.path.join(root, "voice.wav")
    Image.fromarray(rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)).save(img_path)
    infer_length = 21 + (21 - OVERLAP) * (N_WINDOWS - 1)
    t = np.arange(((infer_length - 1) * 4 + 1) * (16000 // 25)) / 16000
    voice = 0.3 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    save_wav(wav_path, voice.astype(np.float32), 16000)
    return img_path, wav_path


def read_video(name, path, shape):
    """The video an app request wrote, checked: a PNG frame directory read
    back as [1, 3, T, H, W] in [0, 1], or an mp4 file (ffmpeg present)."""
    import numpy as np
    from PIL import Image

    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        frames = np.stack([np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                           for n in names])
        check_video(name, frames.transpose(3, 0, 1, 2)[None].astype(np.float32) / 255.0, shape)
    elif not (path.endswith(".mp4") and os.path.getsize(path) > 0):
        raise AssertionError(f"{name}: no video at {path}")
    else:
        log(f"  {name}: mp4 of {os.path.getsize(path)} bytes")


def http_post(base, name, values, timeout=900):
    import urllib.error
    import urllib.parse
    import urllib.request

    req = urllib.request.Request(base + urllib.parse.quote(f"/api/{name}"),
                                 data=json.dumps({"data": values}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        body = json.loads(urllib.request.urlopen(req, timeout=timeout).read())
    except urllib.error.HTTPError as e:  # the shim answers a failed callback with 500
        raise AssertionError(f"POST /api/{name}: {e.code} {e.read().decode()}") from e
    return body["data"]


def phase_app(reset_counts, counts):
    """17. The serving app at WAN_1_3B, 512x512: `build_app_parser` flags,
    `load_models` with umT5-xxl kept on the card, `AvatarService`,
    `build_ui` and `launch` on 127.0.0.1; over HTTP the page, the MCP
    tools, request A (Generate: euler, 2 steps, seed 7) and the Separate
    tab; request B (unipc, 2 steps, TeaCache 0.1, streamed) through
    `AvatarService.generate`.  Returns the service (its models stay on the
    card for phase 18's trace) and the launches of request A."""
    import urllib.request

    import numpy as np
    import torch

    from stableavatar_tpu_torch.cli import app as tapp
    from stableavatar_tpu_torch.cli.inference import load_models
    from stableavatar_tpu_torch.utils.media import load_wav
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    root = tempfile.mkdtemp(prefix="chip_smoke_app_")
    args = tapp.build_app_parser().parse_args(APP_ARGV + ["--output_dir",
                                                          os.path.join(root, "out")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = load_models(args, "cuda", keep_t5=True)
    torch.cuda.synchronize()
    if models.t5_params is None or models.text_ctx is not None:
        raise AssertionError("the server's load_models released umT5")
    log(f"  load_models (umT5-xxl kept on the card): {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    timer = StepTimer("cuda")
    service = tapp.AvatarService(models, args.output_dir, model_family=args.model_family,
                                 timer=timer)
    demo = tapp.build_ui(service)
    demo.launch(server_name="127.0.0.1", server_port=0, mcp_server=True,
                prevent_thread_lock=True)
    img_path, wav_path = write_app_inputs(root)
    layers, calls = models.dit_cfg.num_layers, 2 * N_WINDOWS  # 2 steps x 2 windows
    want = {"flash_fwd_int8_qk": layers * calls, "dual_context": layers * calls}
    shape = (1, 3, 105, 512, 512)
    try:
        base = f"http://127.0.0.1:{demo.server_port}"
        page = urllib.request.urlopen(base + "/", timeout=30).read().decode()
        tools = json.loads(urllib.request.urlopen(base + "/mcp/tools", timeout=30).read())
        names = [t["name"] for t in tools["tools"]]
        if "Avatar Generation" not in page or names != ["Generate 生成", "Extract", "Separate"]:
            raise AssertionError(f"app page / MCP tools wrong: {names}")
        log(f"  GET / ({len(page)} bytes) and /mcp/tools: {names}")

        values = demo.default_inputs("Generate 生成")
        values[:4] = [img_path, wav_path, APP_PROMPT, "blurry, distorted"]
        values[7], values[8], values[18] = 2, "euler", 7  # steps, solver, seed
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        video, seed = http_post(base, "Generate 生成", values)
        wall = time.perf_counter() - t0
        launches = counts()
        step = timer.history["denoise_step"][-1] / N_WINDOWS
        log(f"  request A (POST /api/Generate 生成, euler, 2 steps): wall {wall:.2f} s, "
            f"window-step {step:.3f} s, seed {seed}, peak device memory with umT5-xxl "
            f"resident {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases "
            f"{ {k: round(v['total_s'], 3) for k, v in timer.summary().items()} }")
        check_launches("request A", launches, want)
        if seed != 7:
            raise AssertionError(f"request A returned seed {seed}, not 7")
        read_video("request A", video, shape)

        timer.history.clear()
        reset_counts()
        t0 = time.perf_counter()
        video_b, seed_b, _ = service.generate(
            img_path, wav_path, APP_PROMPT, "blurry, distorted", num_inference_steps=2,
            seed_param=8, enable_teacache=True, teacache_threshold=0.1,
            num_skip_start_steps=5, sample_solver="unipc", stream_output=True)
        wall = time.perf_counter() - t0
        step = timer.history["denoise_step"][-1] / N_WINDOWS
        log(f"  request B (generate, unipc, 2 steps, TeaCache 0.1, streamed): wall "
            f"{wall:.2f} s, window-step {step:.3f} s, seed {seed_b}; phases "
            f"{ {k: round(v['total_s'], 3) for k, v in timer.summary().items()} }")
        # 2 steps: TeaCache computes every call (its first and last of each cycle)
        check_launches("request B", counts(), want)
        if seed_b != 8:
            raise AssertionError(f"request B returned seed {seed_b}, not 8")
        read_video("request B", video_b, shape)

        t0 = time.perf_counter()
        (vocal,) = http_post(base, "Separate", [wav_path])
        sep, sr = load_wav(vocal, 16000)
        if not (sr == 16000 and sep.size == load_wav(wav_path, 16000)[0].size
                and np.isfinite(sep).all()):
            raise AssertionError(f"Separate wrote no usable vocals at {vocal}")
        log(f"  POST /api/Separate (HPSS tier, no Kim_Vocal_2.onnx here): "
            f"{time.perf_counter() - t0:.2f} s, {sep.size} samples")
    finally:
        demo.close()
    shutil.rmtree(root, ignore_errors=True)
    return service, launches


def stereo_track(seconds, sr=44100):
    """A seeded stereo 44.1 kHz track: a voiced harmonic stack and noise."""
    import numpy as np

    rng = np.random.default_rng(18)
    t = np.arange(int(sr * seconds)) / sr
    voice = sum(a * np.sin(2 * np.pi * 180 * k * t) for k, a in ((1, 0.3), (2, 0.15), (3, 0.1)))
    voice *= 0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)
    return np.stack([voice + 0.05 * rng.standard_normal(t.size),
                     0.8 * voice + 0.05 * rng.standard_normal(t.size)]).astype(np.float32)


def phase_mdx():
    """18a. The ONNX runner with an MDX-topology graph at Kim_Vocal_2's
    geometry (seeded random weights) through `mdx_separate_waveform` on a
    stereo 44.1 kHz track: the card against the same runner on the CPU."""
    import numpy as np
    import torch

    from stableavatar_tpu_torch.preprocess import vocal_separator as sep
    from stableavatar_tpu_torch.utils.onnx_runner import parse_onnx
    from tests.torch_onnx_graphs import mdx_graph

    data, _ = mdx_graph(c=4, g=MDX_WIDTH, f=sep.MDX_DIM_F, t=sep.MDX_DIM_T, crop=0,
                        tdf_div=MDX_TDF_DIV, seed=0, scale=0.05)
    graph = parse_onnx(data)
    track = stereo_track(MDX_SECONDS)
    kept = sep.MDX_HOP * (sep.MDX_DIM_T - 1) - 2 * (sep.MDX_N_FFT // 2)  # a segment's centre
    n_segments = -(-track.shape[-1] // kept)

    def separate(device):
        t0 = time.perf_counter()
        out = sep.mdx_separate_waveform(track, graph, device=device)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    separate("cuda")  # warm-up: cuDNN's choice of algorithms
    got, card_s = separate("cuda")
    want, cpu_s = separate("cpu")
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    mx = float(np.abs(got - want).max())
    log(f"  MDX-topology graph ({len(data) / 1e6:.1f} MB, width {MDX_WIDTH}) on a "
        f"{MDX_SECONDS:.0f} s stereo 44.1 kHz track, {n_segments} segments of "
        f"[1, 4, {sep.MDX_DIM_F}, {sep.MDX_DIM_T}]: card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; card vs CPU rel_l2 {rel:.3e} max_abs {mx:.3e} "
        f"(limit rel_l2 {MDX_REL_TOL}, fp32 with TF32 off)")
    if got.shape != track.shape or not np.isfinite(got).all() or not rel <= MDX_REL_TOL:
        raise AssertionError(f"the ONNX runner on the card disagrees with the CPU: {rel:.3e}")


def phase_trace(models, reset_counts, counts):
    """18b. `device_trace` around one fast window-step of phase 17's
    models: the exported Chrome trace names K2's and K5's kernels."""
    import torch

    from stableavatar_tpu_torch.models.dit import dit_forward
    from stableavatar_tpu_torch.utils.profiling import device_trace

    cfg = models.dit_cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    x = torch.randn((3, 16, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    y = torch.randn((3, 20, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").to(bf16)
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").to(bf16)
    voc = torch.randn((1, 161, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 999.0, device="cuda")
    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), device_trace(logdir):
        dit_forward(models.dit_params, cfg, x, t, text, clip, y, voc, video_sample_n_frames=81,
                    vocal_cfg_tile=True, rope_split=True, attn_quant="qk")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("traced window-step", counts(),
                   {"flash_fwd_int8_qk": cfg.num_layers, "dual_context": cfg.num_layers})
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {"flash_fwd_kernel": 0, "dual_context_kernel": 0}
    for e in kernels:
        for k in names:
            names[k] += k in e.get("name", "")
    device_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    log(f"  device_trace around one fast window-step: {wall:.2f} s, {len(events)} events, "
        f"{len(kernels)} kernels ({device_ms:.1f} ms on the card), flash / dual-context "
        f"kernels {names}, {os.path.getsize(os.path.join(logdir, trace)) / 1e6:.1f} MB")
    if names != {"flash_fwd_kernel": cfg.num_layers, "dual_context_kernel": cfg.num_layers}:
        raise AssertionError(f"the trace does not name the window-step's kernels: {names}")
    shutil.rmtree(logdir, ignore_errors=True)


def phase_scripts(reset_counts, counts):
    """18c. The host scripts' mains: bench_decode_overlap, bench_dit_step
    base and full, profile_step_parts and quality_curves --small, with exact
    launch counts (none for the decode)."""
    from stableavatar_tpu_torch.config import WAN_1_3B
    from stableavatar_tpu_torch.scripts import (bench_decode_overlap, bench_dit_step,
                                                profile_step_parts, quality_curves)

    log("  bench_decode_overlap (512x512, 27 latents, 105 frames):")
    reset_counts()
    res = bench_decode_overlap.main([])
    check_launches("decode overlap", counts(), {k: 0 for k in counts()})
    if not res["equal"]:
        raise AssertionError("the overlapped decode's frames differ from the monolithic one's")
    log(f"  decode + copy: monolithic {res['monolithic_s']} s, overlapped "
        f"{res['overlapped_s']} s")

    log("  bench_dit_step base full --inner 2:")
    reset_counts()
    res = bench_dit_step.main(["base", "full", "--inner", "2"])
    want = {}
    for name, r in res.items():
        for k, n in bench_dit_step.launches_per_forward(name, WAN_1_3B.num_layers).items():
            want[k] = want.get(k, 0) + n * r["forwards"]
    check_launches("bench_dit_step", counts(), want)

    log("  profile_step_parts (the 512x512 window, 30 layers):")
    reset_counts()
    res = profile_step_parts.main([])
    want_k1 = sum(r["calls"] * profile_step_parts.PARTS[k] for k, r in res.items())
    check_launches("profile_step_parts", counts(), {"flash_fwd_bf16": want_k1})

    log(f"  quality_curves --small --layers {QUALITY_LAYERS} (512x512, 2 windows):")
    reset_counts()
    res = quality_curves.main(["--small", "--layers", str(QUALITY_LAYERS)])
    n = QUALITY_LAYERS * res["dit_forwards"]
    check_launches("quality_curves", counts(), {"flash_fwd_int8_qk": n, "dual_context": n})
    rows = res["solver_curve"] + res["teacache_frontier"]
    if not all(r["psnr_latent"] > 0 for r in rows):
        raise AssertionError(f"quality_curves rows without a PSNR: {rows}")


def main() -> int:
    try:
        import torch
        import stableavatar_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port has no CPU run here",
              file=sys.stderr)
        return 1

    # the smoke drives device 0 only and reports the one card it used
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, found {torch.cuda.device_count()} "
              "(set CUDA_VISIBLE_DEVICES to one of them)", file=sys.stderr)
        return 1

    results = {}
    phase_device()
    log("== kernels against their plain versions")
    phase_kernels(results)

    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa

    def counts():
        return {**fa.launch_counts, **ca.launch_counts}

    log("== random 1.3B / ViT-H / wav2vec2-base / VAE weights on the card")
    t0 = time.perf_counter()
    models, dit_bf16 = build_models("cuda")
    torch.cuda.synchronize()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    log("== reference: card against CPU on a small input")
    phase_reference(models)

    log("== train reference: card against CPU on a small window")
    phase_train_reference(dit_bf16, models.dit_cfg)

    def reset_counts():
        for d in (fa.launch_counts, ca.launch_counts):
            for k in d:
                d[k] = 0

    # main path 1, inference: every launch count starts at 0 here and is
    # read after its last phase; the comparisons above do not count
    reset_counts()
    layers = models.dit_cfg.num_layers
    log("== main path: generate_long, 1.3B, 512x512, Euler, overlap 15, 2 windows, 2 steps")
    n_dit_calls = phase_pipeline(models)
    c = counts()
    log(f"  launches: {c}")
    want = layers * n_dit_calls
    if c["flash_fwd_int8_qk"] != want or c["dual_context"] != want:
        raise AssertionError(f"expected {want} K2 and K5 launches, got {c}")
    log("== CLI-default bf16 path: dit_forward, attn_quant='none'")
    gelu_launches = phase_bf16(dit_bf16, models.dit_cfg)
    inference = counts()
    k1 = inference["flash_fwd_bf16"] - c["flash_fwd_bf16"]
    log(f"  K1 launches: {k1}")
    if k1 != 3 * layers:
        raise AssertionError(f"expected {3 * layers} K1 launches (1 self + 2 cross per layer), got {k1}")

    # main path 2, the inference CLI: counts set to 0 inside, just before
    # run_generation
    log("== main path: the inference CLI, --fast_path linears, DPM++ 2, TeaCache, K3, "
        "umT5-xxl, 1.3B, 512x512, 2 windows, 5 steps")
    cli = phase_cli(reset_counts, counts)

    # path 3, the int8 variants: counts set to 0 inside, just before each run
    log("== int8 variants: qkpv generate_long (UniPC), qkv and static qkv dit_forward windows")
    variants = phase_variants(models, reset_counts, counts)

    # main path 4, training: counts set to 0 inside, just before train()
    log(f"== main path: train(), 1.3B, 512x512, 81 frames, batch 1, remat, AdamW, "
        f"{TRAIN_STEPS} steps")
    training, adamw_steps = phase_train(models, dit_bf16, reset_counts, counts)

    # path 4b, training with 8-bit Adam and with CAME: counts set to 0
    # inside, just before each train()
    log(f"== train() with 8-bit Adam, then CAME: 1.3B, 512x512, 81 frames, batch 1, remat, "
        f"{TRAIN_STEPS} steps each")
    phase_train_optimizers(models, dit_bf16, reset_counts, counts, adamw_steps)

    # path 7, the single clip and log_validation: counts set to 0 inside,
    # just before each run
    log("== single clip: generate_single_clip, 1.3B, 512x512, 81 frames, fast path 2 Euler "
        "steps, bf16 1 step, log_validation")
    phase_single_clip(models, dit_bf16, reset_counts, counts)

    # path 8, checkpoints: counts set to 0 inside, just before each window-step
    log("== checkpoints: the 1.3B DiT written as Wan's fp32 safetensors, a .pt override and a "
        "wav2vec2 directory, loaded by load_models; one window-step loaded vs in memory")
    phase_checkpoints(models, dit_bf16, reset_counts, counts)
    del models, dit_bf16
    torch.cuda.empty_cache()

    # path 11, the train CLI: counts set to 0 inside, just before its main
    log(f"== train CLI: main() at 1.3B, 512x512, 81 frames from a clip directory on disk, "
        f"umT5-xxl resident, {TRAIN_CLI_STEPS} steps, a checkpoint and a validation clip")
    phase_train_cli(reset_counts, counts)

    # paths 9 and 10, 14B resident and streamed: counts set to 0 inside,
    # just before each window-step
    log("== 14B: K1, K2, K5 at [3, 21504, 40, 128]; load_models --model_family 14B, one "
        "window-step with --fast_path linears and one bf16")
    phase_kernels_14b(results)
    runs_14b = phase_14b(reset_counts, counts)
    for name, run in (("flash_fwd_bf16", "bf16"), ("flash_fwd_int8_qk", "fast"),
                      ("dual_context", "fast")):
        for entry in results[name]["shapes"]:
            if entry.get("model") == "WAN_14B":
                entry["launches"] = runs_14b[run]["launches"][name]
    log("== sequential: the 14B bf16 window-step with --GPU_memory_mode sequential_cpu_offload")
    phase_sequential(runs_14b["bf16"], reset_counts, counts)

    # path 5, multi-GPU inference's kernels and its one-rank path: counts set
    # to 0 inside, just before ring_attention
    log("== ring: K2-LSE and K2v-qkpv against their plain versions, the ring merge at the "
        "DiT shape, the one-rank NCCL mesh and ring_attention")
    phase_ring_kernels(results)
    phase_ring_merge()
    ring = phase_ring_path(reset_counts, counts)

    # path 6, the entry points of the remaining kernels: counts set to 0
    # inside, just before each
    log("== remaining kernels: K1-rope, K4-rope, the probes and the GELU pass against their "
        "plain versions")
    phase_rope_kernels(results)
    phase_probe_kernels(results)
    phase_gelu_kernel(results)
    log("== remaining entry points: flash_attention(rope=) forward, with stats and under "
        "autograd, and the probe scripts' main")
    remaining = phase_remaining_paths()

    # path 12, the serving app: counts set to 0 inside, just before each
    # request; path 13, the tools and host scripts: before each
    log("== app: load_models with umT5-xxl kept, AvatarService, build_ui, launch; over HTTP "
        "Generate (1.3B, 512x512, 2 windows, euler 2 steps) and Separate; generate with "
        "unipc, TeaCache, streaming")
    service, app = phase_app(reset_counts, counts)
    log("== tools: the ONNX runner (MDX topology, Kim_Vocal_2 geometry) card vs CPU, "
        "device_trace, bench_decode_overlap, bench_dit_step, profile_step_parts, "
        "quality_curves")
    phase_mdx()
    phase_trace(service.models, reset_counts, counts)
    del service
    torch.cuda.empty_cache()
    phase_scripts(reset_counts, counts)
    launches = {**{k: inference[k] for k in INFERENCE_KERNELS},
                **{k: cli[k] for k in CLI_KERNELS},
                **{k: variants[k] for k in VARIANT_KERNELS},
                **{k: training[k] for k in TRAIN_KERNELS},
                **{k: ring[k] for k in RING_KERNELS},
                **{k: remaining.get(k, 0) for k in ROPE_KERNELS + PROBE_KERNELS},
                "gelu_tanh": gelu_launches, "gelu_tanh_bwd": training["gelu_tanh_bwd"]}
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels of the main paths never launched: {idle}")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = results.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": r.get("max_abs_err"),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"), "library_ms": r.get("library_ms"),
            **({"app_launches": app[name]} if name in app and app[name] else {}),
            **{k: r[k] for k in ("library_with_transpose_ms", "shapes", "k1_text_ms",
                                 "k1_image_ms", "sdpa_two_calls_and_add_ms", "out_of_kernel_ms")
               if k in r},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
