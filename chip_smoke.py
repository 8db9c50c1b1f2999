"""Chip smoke test of the PyTorch/CUDA port (`stableavatar_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check raises and the script
exits non-zero):

1. device   -- require CUDA, print the card's name and power limit, build the
               hand-written kernels from csrc/ and print the build seconds;
2. kernels  -- K1 (bf16 flash), K2 (int8-QK flash), K5 (dual-context
               cross-attention), K1 with its LSE output and the K4 backward
               (K4a dK/dV, K4b dQ) against their plain PyTorch versions at the
               main-path shapes and on small ragged cases, with times, the
               least time the card could take (bound) and, where one PyTorch
               call computes the same function, that call's time;
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
               (attn_quant="none"): 90 K1 launches;
7. train    -- the port's train() for 3 steps at the full width of WAN_1_3B,
               512x512, 81 frames, batch 1, remat, AdamW (the train CLI's
               defaults), one step in clip-level mode; checks finite losses,
               changed parameters, a checkpoint written and resumed at step
               3, and the exact K1-LSE / K4a / K4b launch counts.

Phases 5-6 (inference) and 7 (training) are the two main paths: the launch
counts are set to 0 just before each and read just after.  The line before
the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
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
    "flash_bwd_dkdv": ("stableavatar_tpu_torch/csrc/flash_attention_bwd.cu",
                       "stableavatar_tpu/ops/flash_attention.py:905"),
    "flash_bwd_dq": ("stableavatar_tpu_torch/csrc/flash_attention_bwd.cu",
                     "stableavatar_tpu/ops/flash_attention.py:941"),
}
INFERENCE_KERNELS = ("flash_fwd_bf16", "flash_fwd_int8_qk", "dual_context")
TRAIN_KERNELS = ("flash_fwd_bf16_lse", "flash_bwd_dkdv", "flash_bwd_dq")


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


def compare(name: str, got, want) -> float:
    """Raise unless rel-L2 <= REL_TOL and max-abs <= ABS_TOL; return max-abs."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    mx = float((g - w).abs().max())
    log(f"  {name}: rel_l2={rel:.3e} max_abs={mx:.3e}")
    if not (rel <= REL_TOL and mx <= ABS_TOL):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(rel_l2 {rel:.3e} > {REL_TOL} or max_abs {mx:.3e} > {ABS_TOL})"
        )
    return mx


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port has no CPU run here")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # name, power limit: exactly as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from stableavatar_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {path}")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Function properties for" in line:
            log(f"  ptxas: {line.split('for', 1)[1].strip()[:60]}")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas:   {line.replace('ptxas info    :', '').strip()}")


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def phase_kernels(results):
    import torch

    from stableavatar_tpu_torch.ops import cross_attention as ca
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
            lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
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
    del q8, k8, got, want

    got = fa._flash_fwd_cuda(q, k, v, None, scale)
    want = fa._flash_fwd_plain(q, k, v, None, scale)
    err = compare("flash_fwd_bf16 [3,21504,12,128]", got, want)
    record("flash_fwd_bf16", "main", err,
           time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale), 5),
           time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, scale), 3),
           bound_ms(fwd_ops, io_bytes), sdpa_ms(q, k, v))
    del got, want

    # K5 at the DiT cross-attention shape: text 512, image 257
    k1, v1 = (_rand(gen, (b, 512, n, d), bf16) for _ in range(2))
    k2, v2 = (_rand(gen, (b, 257, n, d), bf16) for _ in range(2))
    got = ca._dual_cuda(q, k1, v1, k2, v2, scale)
    want = ca._dual_plain(q, k1, v1, k2, v2, scale)
    err = compare("dual_context [3,21504,12,128] x (512, 257)", got, want)
    record("dual_context", "main", err,
           time_ms(lambda: ca._dual_cuda(q, k1, v1, k2, v2, scale), 5),
           time_ms(lambda: ca._dual_plain(q, k1, v1, k2, v2, scale), 3),
           bound_ms(4.0 * b * n * l * (512 + 257) * d,
                    2.0 * b * n * d * (2 * l + 2 * (512 + 257))))
    del q, k, v, k1, v1, k2, v2, got, want

    phase_kernels_train(record, sdpa_ms, gen)

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
        k1, v1 = (_rand(gen, (b, 77, n, d), bf16) for _ in range(2))
        k2, v2 = (_rand(gen, (b, 33, n, d), bf16) for _ in range(2))
        record("dual_context", tag, compare(
            f"dual_context {tag} x (77, 33)", ca._dual_cuda(q, k1, v1, k2, v2, scale),
            ca._dual_plain(q, k1, v1, k2, v2, scale)), None, None)
    torch.cuda.synchronize()


def compare_lse(name: str, got, want) -> float:
    """Raise unless K1's LSE is finite and within LSE_TOL of the plain one."""
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


def phase_kernels_train(record, sdpa_ms, gen):
    """K1 with LSE and the K4 backward at the training shapes: the DiT
    self-attention of one 512x512, 81-frame sample [1, 21504, 12, 128], the
    text / image cross-attention (Lk 512, 257) and the ragged cases."""
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
        main = (b, lq, lk) == (1, 21504, 21504)
        if not main:
            for name, e in (("flash_fwd_bf16_lse", err), ("flash_bwd_dkdv", max(errs[1:])),
                            ("flash_bwd_dq", errs[0])):
                record(name, tag, e, None, None)
            continue
        # keys never masked here: the work is the full L^2 per head
        prod = 2.0 * b * n * lq * lk * d  # flops of one L x L x D product
        qkvo = 2.0 * b * n * d * (2 * lq + 2 * lk)  # q, do (or out), k, v in bf16
        stats = 4.0 * b * n * lq * 2  # lse and delta, fp32
        record("flash_fwd_bf16_lse", tag, err,
               time_ms(lambda: fa._flash_fwd_cuda(q, k, v, kl, scale, with_lse=True), 5),
               time_ms(lambda: fa._flash_fwd_plain(q, k, v, kl, scale, with_lse=True), 3),
               bound_ms(2 * prod, 2.0 * b * n * d * (2 * lq + 2 * lk) + stats / 2),
               sdpa_ms(q, k, v))
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), None)
        dims = (b, lq, lk, n, d, float(scale), float(scale * fa.LOG2E))
        from stableavatar_tpu_torch.ops import cuda_lib

        def k4a():
            cuda_lib.launch("sa_flash_bwd_dkdv", *args, dk.data_ptr(), dv.data_ptr(), *dims)

        def k4b():
            cuda_lib.launch("sa_flash_bwd_dq", *args, dq.data_ptr(), *dims)

        plain = time_ms(lambda: fa._flash_bwd_plain(q, k, v, kl, out, lse, do, scale), 3)
        library = sdpa_ms(q, k, v, backward=True)
        # K4a: S, dP, dV, dK (4 products); K4b: S, dP, dQ (3 products)
        record("flash_bwd_dkdv", tag, max(errs[1:]), time_ms(k4a, 5), plain,
               bound_ms(4 * prod, qkvo + stats + 2.0 * 2 * b * n * lk * d), library)
        record("flash_bwd_dq", tag, errs[0], time_ms(k4b, 5), plain,
               bound_ms(3 * prod, qkvo + stats + 2.0 * b * n * lq * d), library)
        log("  (K4a and K4b plain_ms and library_ms are one whole backward each: the plain "
            "version and SDPA compute dq, dk and dv together)")
        del q, k, v, do, out, lse, delta, dq, dk, dv
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

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    x = torch.randn((3, 16, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    y = torch.randn((3, 20, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").to(bf16)
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").to(bf16)
    voc = torch.randn((1, 161, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 999.0, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dit_forward(dit_params, cfg, x, t, text, clip, y, voc, video_sample_n_frames=81,
                          vocal_cfg_tile=True, attn_quant="none")
        torch.cuda.synchronize()
    log(f"  bf16 dit_forward window: {time.perf_counter() - t0:.3f} s, out {tuple(out.shape)}")
    if tuple(out.shape) != (3, 16, 21, 64, 64) or not torch.isfinite(out).all():
        raise AssertionError("bf16 dit_forward output has the wrong shape or non-finite values")


# host-draw seed of train(): with batch 1 its third step takes the
# clip-level branch (encode_batch's draws from numpy's default_rng)
TRAIN_SEED, TRAIN_STEPS = 6, 3


def train_batches(n, cfg):
    """Synthetic batches with the dataset's keys at the train CLI's defaults
    (512x512, 81 frames, batch 1): pixels in [-1, 1], the first frame
    visible, face and lip masks, 16 kHz audio for 81 frames at 25 fps and a
    pre-encoded prompt (the port has no T5 yet)."""
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


def phase_train(models, dit_params, reset_counts, counts):
    """train() at 1.3B / 512x512 / 81 frames for TRAIN_STEPS steps (AdamW,
    remat, the train CLI's defaults) on the bf16 DiT, then a resume from
    its checkpoint.  Returns the training path's launch counts."""
    import dataclasses

    import torch

    from stableavatar_tpu_torch.train.loop import CheckpointManager, train
    from stableavatar_tpu_torch.train.trainer import TrainConfig
    from stableavatar_tpu_torch.utils.tree import tree_leaves

    cfg = models.dit_cfg
    tmodels = dataclasses.replace(models, dit_params=dit_params, rope_split=False,
                                  attn_quant="none")
    leaves = tree_leaves(dit_params)
    n_params = sum(p.numel() for p in leaves)
    before = [p.clone() for p in leaves]
    start = [p.clone() for p in leaves[:4]]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
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

    log(f"  {n_params / 1e9:.3f} B parameters, bf16")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        last["t"] = time.perf_counter()
        t0 = last["t"]
        _, _, history = train(tmodels, train_batches(TRAIN_STEPS, cfg), TrainConfig(),
                              output_dir=out_dir, max_train_steps=TRAIN_STEPS,
                              checkpointing_steps=TRAIN_STEPS, checkpoints_total_limit=1,
                              resume_from_checkpoint=None, log_every=1, seed=TRAIN_SEED,
                              step_callback=on_step)
        torch.cuda.synchronize()
        launches = counts()
        log(f"  train(): {len(history)} steps in {time.perf_counter() - t0:.2f} s including the "
            f"asynchronous checkpoint; launches {launches}")
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
        want = {"flash_fwd_bf16_lse": 2 * calls, "flash_bwd_dkdv": calls, "flash_bwd_dq": calls,
                "flash_fwd_bf16": 0, "flash_fwd_int8_qk": 0, "dual_context": 0}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"training launch counts {launches} != {want}")

        cm = CheckpointManager(out_dir)
        if os.path.basename(cm.latest() or "") != f"checkpoint-{TRAIN_STEPS}":
            raise AssertionError(f"no checkpoint-{TRAIN_STEPS} in {os.listdir(out_dir)}")
        t0 = time.perf_counter()
        resumed, _, history = train(dataclasses.replace(tmodels), train_batches(1, cfg),
                                    TrainConfig(), output_dir=out_dir,
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
    phase_bf16(dit_bf16, models.dit_cfg)
    inference = counts()
    k1 = inference["flash_fwd_bf16"] - c["flash_fwd_bf16"]
    log(f"  K1 launches: {k1}")
    if k1 != 3 * layers:
        raise AssertionError(f"expected {3 * layers} K1 launches (1 self + 2 cross per layer), got {k1}")

    # main path 2, training: counts set to 0 inside, just before train()
    log(f"== main path: train(), 1.3B, 512x512, 81 frames, batch 1, remat, AdamW, "
        f"{TRAIN_STEPS} steps")
    training, _ = phase_train(models, dit_bf16, reset_counts, counts)
    launches = {**{k: inference[k] for k in INFERENCE_KERNELS},
                **{k: training[k] for k in TRAIN_KERNELS}}
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
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
