"""Long-video generation: the port's `generate_long` as the inference CLI
runs it by default (bf16 DiT, unprepared parameters, no attention
quantisation, Euler on the 50-step flow-match schedule, latents out).

One request is one reference image, one voice track and a pre-encoded
text context, all drawn from the seed, on weights drawn from the seed.
Set-up is the weights, the conditioning and the first sweep (one denoise
step over every window), which builds and warms every kernel; the window
is the sweeps after it until `seconds` have passed (the sweep in flight
finishes, and the window holds at least the checked sweep).
`window_step_s` is the window's wall time over the window-steps (sweeps x
windows) it completed.

What is judged, once the window has closed and the peak memory is read
(`judge`; a sweep s among the first of the window, a window w, a block k
and a CFG row r drawn from the seed):

- `cond_gap`: the conditioning set-up made (CLIP features, the VAE latents
  of the reference-frame video, the wav2vec states of window w) against
  the reference's from the raw image and audio; the largest relative L2.
- `branch_gap`: the self-attention, cross-attention and FFN branches of
  block k in window-step (s, w), each from the program's own input to it;
  the largest relative L2 of the three outputs.
- `dit_gap`: the program's DiT output for row r of (s, w) against the
  reference DiT's, run on the program's latents before sweep s with the
  reference's own conditioning; relative L2.
- `update_ulps`: sweep s's latents against the reference's update of the
  program's latents before it from the program's DiT outputs: the CFG
  combine, the Euler step, each window stored in bf16 and cross-faded over
  the overlap into the stored tail of the one before; the mean absolute
  gap over the mean bf16 spacing of the reference's latents.
"""

from __future__ import annotations

import random
import time

import numpy as np

from avatar_bench import core, roofline, weights
from avatar_bench.reference import common as rc
from avatar_bench.reference import dit as ref_dit
from avatar_bench.reference import encoders as ref_enc


class _WindowClosed(Exception):
    pass


def plan(tr: dict, c: dict):
    """(windows, audio sample slices, latent frames a window, latent h, w)."""
    sr, fps = tr["sample_rate"], tr["fps"]
    total = int(round(tr["audio_seconds"] * sr))
    per_frame = int(sr / fps)
    infer = (int(total / per_frame) - 1) // 4 + 1
    frames = (tr["clip_length"] - 1) // 4 + 1
    windows = rc.window_plan(infer, frames, tr["overlap"])
    slices = rc.audio_slices(windows, infer, per_frame, total)
    h, w = tr["image_size"]
    s = c["vae"]["spatial_compression_ratio"]
    return windows, slices, frames, h // s, w // s


def make_inputs(tr: dict, c: dict, gen, device):
    """The request: a smooth reference image in [-1, 1], a voice-band noise
    track, and the CFG text context [neg, neg, pos] of umT5-sized states
    with zeros past each prompt's length."""
    import torch
    import torch.nn.functional as F

    h, w = tr["image_size"]
    coarse = torch.randn((1, 3, h // 32, w // 32), generator=gen, device=device)
    fine = torch.randn((1, 3, h, w), generator=gen, device=device)
    image = torch.tanh(F.interpolate(coarse, size=(h, w), mode="bilinear") + 0.1 * fine)
    total = int(round(tr["audio_seconds"] * tr["sample_rate"]))
    audio = 0.1 * torch.randn(total, generator=gen, device=device)
    d = c["dit"]
    text = torch.zeros((2, d["text_len"], d["text_dim"]), device=device)
    for row, n in enumerate((tr["negative_tokens"], tr["prompt_tokens"])):
        text[row, :n] = 0.2 * torch.randn((n, d["text_dim"]), generator=gen, device=device)
    text_ctx = torch.stack([text[0], text[0], text[1]]).to(torch.bfloat16)
    return image, audio.cpu().numpy(), text_ctx


def program_configs(c: dict):
    from stableavatar_tpu_torch import config as pc

    def make(cls, group):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in group.items()})

    return (make(pc.DiTConfig, c["dit"]), make(pc.VAEConfig, c["vae"]),
            make(pc.CLIPConfig, c["clip"]), make(pc.Wav2Vec2Config, c["wav2vec"]))


STAGES = ("self", "cross", "ffn")


class _Capture:
    """Keeps what the judge reads, by patching names in the port's modules
    while the run lasts: the conditioning set-up made, the DiT's outputs of
    the checked sweep, and the inputs and outputs of the three branches
    (self-attention, cross-attention, FFN) of one block of one window-step
    of it.  The branches' tensors are copied as they are made into pinned
    host buffers allocated before the window, so that neither the device's
    peak nor an allocation inside the window holds them."""

    def __init__(self, n_win, n_layers, sample, buffers):
        self.n_win = n_win
        self.sample = sample
        self.target = (sample["sweep"] * n_win + sample["window"]) * n_layers + sample["block"]
        self.buf = buffers
        self.got = {"voc": []}
        self.forwards = self.blocks = 0
        self.current = None  # the target block's parameters while it runs

    def _keep(self, name, t):
        self.buf[name].copy_(t, non_blocking=True)
        self.got[name] = self.buf[name]

    def conditioning(self, real):
        def wrapped(*a, **k):
            out = real(*a, **k)
            self.got["clip"], self.got["y"] = out
            return out
        return wrapped

    def vocal(self, real):
        def wrapped(*a, **k):
            out = real(*a, **k)
            self.got["voc"].append(out)
            return out
        return wrapped

    def forward(self, real):
        def wrapped(*a, **k):
            out = real(*a, **k)
            sweep, w = divmod(self.forwards, self.n_win)
            self.forwards += 1
            if sweep == self.sample["sweep"]:
                self.got[w] = out
            return out
        return wrapped

    def apply_block(self, real):
        def wrapped(p, x, **kw):
            if self.blocks == self.target:
                self.current = p
            try:
                return real(p, x, **kw)
            finally:
                self.current = None
                self.blocks += 1
        return wrapped

    def self_attention(self, real):
        def wrapped(p, x, *a, **k):
            out = real(p, x, *a, **k)
            if self.current is not None:
                self._keep("self_in", x)
                self._keep("self_out", out)
            return out
        return wrapped

    def cross_attention(self, real):
        def wrapped(p, x, context_text, context_img, vocal_context, *a, **k):
            out = real(p, x, context_text, context_img, vocal_context, *a, **k)
            if self.current is not None:
                self._keep("cross_in", x)
                self._keep("cross_out", out)
                self.got["contexts"] = (context_text, context_img, vocal_context)
            return out
        return wrapped

    def linear(self, real):
        def wrapped(p, x):
            out = real(p, x)
            if self.current is not None:
                if p is self.current["ffn"]["fc1"]:
                    self._keep("ffn_in", x)
                elif p is self.current["ffn"]["fc2"]:
                    self._keep("ffn_out", out)
            return out
        return wrapped


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        variant: str = "program") -> core.Outcome:
    """One run of the cell.  The conditioning runs in float32 with TF32 off,
    as the configuration states.  variant "control" switches on the
    program's lower-precision paths in its place: the int8 path of
    `--fast_path linears` (W8A8 linears, split-pair rope, int8 Q.K
    self-attention, the fused cross-attention) and TF32 products in the
    float32 conditioning (PyTorch's cuDNN default)."""
    import torch

    from stableavatar_tpu_torch.models import dit as dit_mod
    from stableavatar_tpu_torch.pipelines import long as long_mod
    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    from avatar_bench.trace import Tracer

    if variant not in ("program", "control"):
        raise ValueError(f"unknown variant {variant!r}")
    tr, c = cell.traffic, cell.config
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = variant == "control"
    torch.backends.cudnn.allow_tf32 = variant == "control"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtypes = c["dtypes"]
    dit, vae, clip, w2v = weights.draw(
        [weights.spec_dit(c["dit"]), weights.spec_vae(c["vae"]), weights.spec_clip(c["clip"]),
         weights.spec_wav2vec(c["wav2vec"])], gen, device,
        [getattr(torch, dtypes[k]) for k in ("dit", "vae", "clip", "wav2vec")])
    image, audio, text_ctx = make_inputs(tr, c, gen, device)
    dit_cfg, vae_cfg, clip_cfg, w2v_cfg = program_configs(c)
    prog_dit, fast = dit, {}
    if variant == "control":
        from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

        prog_dit = prepare_fast_params(dit, dit_cfg, quant=True)
        fast = dict(rope_split=True, attn_quant="qk")
    models = WanModels(dit_params=prog_dit, dit_cfg=dit_cfg, vae_params=vae, vae_cfg=vae_cfg,
                       clip_params=clip, clip_cfg=clip_cfg, wav2vec_params=w2v,
                       wav2vec_cfg=w2v_cfg, device=device, **fast)

    windows, slices, frames, lh, lw = plan(tr, c)
    n_win = len(windows)
    rng = random.Random(seed)
    lo, hi = tr["check_sweeps"]
    sample = {"sweep": rng.randint(lo, hi), "window": rng.randrange(n_win),
              "block": rng.randrange(c["dit"]["num_layers"]), "row": rng.randrange(3)}
    shape = (3, frames * (lh // 2) * (lw // 2), c["dit"]["dim"])
    buffers = {f"{stage}_{end}": torch.empty(shape, dtype=torch.bfloat16, pin_memory=on_card)
               for stage in STAGES for end in ("in", "out")}
    cap = _Capture(n_win, c["dit"]["num_layers"], sample, buffers)
    warm = tr["warmup_sweeps"]
    st = {"start": None, "end": None, "sweeps": 0, "bad": 0, "trace": None}
    tracer = Tracer() if trace else None

    def on_step(i, lat):
        # the StepTimer has synchronised the card at the end of the sweep
        now = time.monotonic()
        if i == sample["sweep"] - 1:
            cap.got["before"] = lat
        elif i == sample["sweep"]:
            cap.got["after"] = lat
        # checked in the warm-up sweeps too, so that its kernels load there
        finite = bool(torch.isfinite(lat).all())
        if i < warm - 1:
            return
        if i == warm - 1:
            st["start"] = time.monotonic()
            if tracer is not None:
                tracer.start()
            return
        st["sweeps"] += 1
        st["bad"] += int(not finite)
        if tracer is not None and st["trace"] is None:
            st["trace"] = tracer.stop(steps=n_win)
        if now - st["start"] >= seconds and i >= sample["sweep"]:
            st["end"] = now
            raise _WindowClosed

    patches = [(long_mod, "prepare_conditioning", cap.conditioning),
               (long_mod, "extract_vocal_features", cap.vocal),
               (long_mod, "dit_forward", cap.forward), (dit_mod, "apply_block", cap.apply_block),
               (dit_mod, "_self_attention", cap.self_attention),
               (dit_mod, "_cross_attention", cap.cross_attention),
               (dit_mod, "apply_linear", cap.linear)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, wrap in patches:
        setattr(m, name, wrap(getattr(m, name)))
    try:
        long_mod.generate_long(
            models, ref_image=image, vocal_waveform=audio, text_ctx=text_ctx,
            num_inference_steps=tr["steps"], text_guide_scale=tr["text_guidance"],
            audio_guide_scale=tr["audio_guidance"], clip_length=tr["clip_length"],
            overlap_window_length=tr["overlap"], scheduler=tr["scheduler"], fps=tr["fps"],
            sr=tr["sample_rate"], seed=seed, shift=tr["shift"], output_type="latent",
            timer=StepTimer(device), step_callback=on_step)
    except _WindowClosed:
        pass
    finally:
        for m, name, real in saved:
            setattr(m, name, real)
    if st["end"] is None:
        raise core.BenchError(f"the schedule of {tr['steps']} steps ended before the window "
                              f"of {seconds} s closed")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    steps = st["sweeps"] * n_win
    metrics = {"window_step_s": (st["end"] - st["start"]) / steps,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": st["start"] - t0}
    del models, prog_dit
    if on_card:
        torch.cuda.empty_cache()

    checks = judge(c, tr, (dit, vae, clip, w2v), (image, audio, text_ctx), cap.got, windows,
                   slices, sample, cell.limits)
    calls = roofline.dit_calls(c["dit"], 3, frames, lh, lw,
                               roofline.wav2vec_frames(c["wav2vec"], len(slices[0])),
                               (frames - 1) * 4 + 1)
    ctx = {"trace": st["trace"], "calls": calls, "steps": n_win, "train": False}
    return core.Outcome(metrics=metrics, checks=checks, attempted=steps,
                        failed=st["bad"] * n_win, memory_peak_bytes=peak, trace=st["trace"],
                        layer_ctx=ctx)


def reference_conditioning(c, tr, vae, clip, w2v, image, audio, slice_idx):
    """CLIP features [1, 257, 1280], y [1, 20, F, h, w] and the window's
    wav2vec states [1, T, 768], worked out by the reference."""
    import torch

    clip_fea = ref_enc.clip_features(clip, c["clip"], image)
    video = torch.cat([image[:, :, None], image.new_zeros((1, 3, tr["clip_length"] - 1,
                                                           *image.shape[-2:]))], 2)
    lat = ref_enc.vae_encode(vae, c["vae"], video)
    f, lh, lw = lat.shape[2:]
    mask = torch.zeros((1, 4, f, lh, lw), device=lat.device)
    mask[:, :, 0] = 1.0
    y = torch.cat([mask, lat], 1)
    wav = torch.as_tensor(audio[slice_idx], device=image.device)
    return clip_fea, y, ref_enc.wav2vec_states(w2v, c["wav2vec"], wav)


def _rel(got, want, base=None):
    import torch

    base = want if base is None else base
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(base.float()))


NUMBERS = ("cond_gap", "branch_gap", "dit_gap", "update_ulps")


def judge(c, tr, models, inputs, got, windows, slices, sample, limits):
    """The compared numbers (module docstring), each with its limit."""
    import torch

    (dit, vae, clip, w2v), (image, audio, text_ctx) = models, inputs
    need = ("clip", "y", "before", "after", "contexts", *range(len(windows)),
            *(f"{stage}_{end}" for stage in STAGES for end in ("in", "out")))
    if not all(k in got for k in need) or len(got["voc"]) != len(windows):
        return [core.Check(n, float("inf"), limits[n]) for n in NUMBERS]
    sig = rc.flow_match_sigmas(tr["steps"], tr["shift"])
    sweep, win = sample["sweep"], sample["window"]
    before, after = got["before"], got["after"]
    dev = before.device
    d = c["dit"]
    with rc.exact_fp32():
        clip_fea, y, states = reference_conditioning(c, tr, vae, clip, w2v, image, audio,
                                                     slices[win])
        cond_gap = max(_rel(got["clip"][:1], clip_fea), _rel(got["y"][:1], y),
                       _rel(got["voc"][win], states))

        # the three branches of one block of the sampled window-step, each
        # from the program's own input to it
        s, e = windows[win]
        grid = (e - s, before.shape[3] // 2, before.shape[4] // 2)
        cos, sin = rc.rope_tables(grid, d["dim"] // d["num_heads"], dev)
        lens = torch.as_tensor(ref_dit.vocal_windows(states.shape[1], (e - s - 1) * 4 + 1)[2],
                               device=dev)
        bp = dit["blocks"][sample["block"]]
        text, img, vocal = (z.float() for z in got["contexts"])
        branch = {
            "self": lambda h: ref_dit.self_attention(bp["self_attn"], d, h, cos, sin),
            "cross": lambda h: ref_dit.cross_attention(bp["cross_attn"], d, h, text, img, vocal,
                                                       lens, e - s),
            "ffn": lambda h: ref_dit.ffn(bp["ffn"], h),
        }
        branch_gap = max(_rel(got[f"{k}_out"].to(dev), f(got[f"{k}_in"].to(dev).float()))
                         for k, f in branch.items())
        del text, img, vocal

        # the whole DiT on one CFG row of the sampled window-step
        row = sample["row"]
        x = before[:, :, s:e].float().repeat(3, 1, 1, 1, 1)
        t = torch.full((3,), float(np.float32(sig[sweep]) * np.float32(1000.0)), device=dev)
        want = ref_dit.dit_forward(dit, d, x, t, text_ctx.float(), clip_fea.repeat(3, 1, 1),
                                   y[:, :, :e - s].repeat(3, 1, 1, 1, 1), states,
                                   (e - s - 1) * 4 + 1, rows=(row,))
        dit_gap = _rel(got[win][row:row + 1], want)
        del want, x

        # the sweep's update from the program's DiT outputs
        step = float(np.float32(sig[sweep + 1]) - np.float32(sig[sweep]))
        ov = tr["overlap"]
        r = torch.as_tensor(rc.ramp(ov), device=dev)[None, None, :, None, None]
        pred = torch.zeros_like(before)
        prev_end = None
        for w, (s, e) in enumerate(windows):
            v = ref_dit.guidance(got[w], tr["text_guidance"], tr["audio_guidance"])
            new = (before[:, :, s:e].float() + step * v).to(torch.bfloat16)
            if s != 0 and ov > 0:
                tail = pred[:, :, prev_end - ov:prev_end].float()
                head = (new[:, :, :ov].float() * r + tail * (1 - r)).to(torch.bfloat16)
                new = torch.cat([head, new[:, :, ov:]], 2)
            pred[:, :, s:e] = new
            prev_end = e
        gap = (after.float() - pred.float()).abs().mean()
        update_ulps = float(gap / rc.ulp_bf16(pred).mean())
    values = dict(cond_gap=cond_gap, branch_gap=branch_gap, dit_gap=dit_gap, update_ulps=update_ulps)
    return [core.Check(n, values[n], limits[n]) for n in NUMBERS]
