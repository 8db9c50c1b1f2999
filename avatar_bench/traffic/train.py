"""Fine-tuning: the port's `train/loop.py:train` as the train CLI runs it by
default (bf16 DiT, remat, AdamW behind the anomaly-aware clip, a constant
schedule, batch 1, inpaint mode), on weights drawn from the seed.

The batches are a pool of host batches in the clip dataset's layout, made
from the seed and cycled through `train()`'s own loop: smooth moving
images in [-1, 1], the dataset's inpaint mask (the first frame visible,
`image_start_only`), the first frame as the reference image, rectangles as
face and lip masks, voice-band noise as audio, and a pre-encoded prompt of
umT5-sized states (umT5 is not loaded).  The dropout flags follow a plan
fixed from the seed at the CLI's rates: in every cycle of steps the same
count of clip-level steps and of steps with the audio dropped, in another
order; the warm-up holds one of each and one plain step.

Set-up is the weights, the pool and the warm-up steps; the window is the
steps after them until `seconds` have passed (the step in flight
finishes).  `train_step_s` is the window's wall time over the steps it
completed.

What is judged, once the window has closed, the peak memory is read and
the program's state is freed (`judge`): the reference
(`reference/train.py:follow`) trains from the seed's weights through the
first `judged_steps` steps on the same batches, flags and draws (the VAE
posterior noise, which the harness hands the program for those steps, and
the flow noise, timestep and mask draw, which the program made), and

- `encode_gap`: each judged step's DiT inputs as `encode_batch` made them
  against the reference's; the largest relative L2;
- `loss_gap`: each judged step's loss against the reference's; the
  largest relative gap;
- `grad_gap`: the first step's gradient as the optimizer got it (after
  the clip), worked out from AdamW's first moment after that step, against
  the reference's: the relative L2 of their difference over every leaf.
  Not the gap of each leaf's norms: rounding moves a gradient mostly
  across itself, which leaves its norm where it was, so norms read the
  float8 control as they read the program;
- `update_gap`: each leaf's change over the judged steps (the norm of its
  parameters' change), the program's against the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the median over the leaves whose first gradient in the
  reference is not nought to rounding (at least a thousandth of the
  median leaf's).  The median leaf, not the worst: a leaf whose first
  gradient is some 1e-7 (as the late blocks' attention q / k weights read
  after a clip-level step) gets AdamW's first update from elements near
  its eps of 1e-10, where the program's bf16 rounding decides which
  parameters move.  A fault on fewer than half of the leaves, or one that
  turns an update without changing its norm, is `loss_gap`'s and
  `grad_gap`'s to catch.
"""

from __future__ import annotations

import contextlib
import math
import random
import shutil
import sys
import tempfile
import time

import numpy as np

from avatar_bench import core, roofline, weights
from avatar_bench.reference import train as rt

ENCODED = ("latents", "inpaint_latents", "clip_fea", "vocal_embeddings", "face_masks", "lip_masks")
NUMBERS = ("encode_gap", "loss_gap", "grad_gap", "update_gap")


def latent_shape(tr: dict, c: dict):
    """[B, z, latent frames, h, w] of one batch's VAE latents."""
    h, w = tr["image_size"]
    s = c["vae"]["spatial_compression_ratio"]
    return (tr["batch_size"], c["vae"]["z_dim"], (tr["clip_length"] - 1) // 4 + 1, h // s, w // s)


def make_pool(tr: dict, c: dict, gen, device, seed: int):
    """The pool of host batches (numpy, the clip dataset's layout) and the
    prompt's states [B, text_len, text_dim] (bf16 on the device)."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    (h, w), t, b = tr["image_size"], tr["clip_length"], tr["batch_size"]
    pad = 64
    mask = np.ones((b, t, 1, h, w), np.float32)
    mask[:, 0] = 0.0
    pool = []
    for _ in range(tr["pool"]):
        coarse = torch.randn((b, 3, (h + 2 * pad) // 32, (w + 2 * pad) // 32), generator=gen,
                             device=device)
        field = F.interpolate(coarse, size=(h + 2 * pad, w + 2 * pad), mode="bicubic",
                              align_corners=False)
        vy, vx = rng.uniform(-0.75, 0.75, 2)
        frames = torch.stack([field[:, :, pad + int(round(vy * i)):pad + int(round(vy * i)) + h,
                                    pad + int(round(vx * i)):pad + int(round(vx * i)) + w]
                              for i in range(t)], 2)
        pixels = torch.tanh(frames + 0.05 * torch.randn(frames.shape, generator=gen, device=device))
        pixels = pixels.cpu().numpy()
        face = np.zeros((b, 1, t, h, w), np.float32)
        lip = np.zeros_like(face)
        cy, cx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w
        fh, fw = rng.uniform(0.35, 0.5) * h, rng.uniform(0.3, 0.4) * w
        y0, x0 = int(cy - fh / 2), int(cx - fw / 2)
        face[..., y0:int(cy + fh / 2), x0:int(cx + fw / 2)] = 1.0
        lip[..., int(cy + fh / 8):int(cy + fh / 3), int(cx - fw / 5):int(cx + fw / 5)] = 1.0
        pool.append({"pixel_values": pixels,
                     "masked_pixel_values": pixels * (1.0 - mask.transpose(0, 2, 1, 3, 4)),
                     "pixel_value_masks": mask, "reference_image": pixels[:, :, 0:1].copy(),
                     "tgt_face_masks": face, "tgt_lip_masks": lip,
                     "vocal_input_values": voice(tr, b, gen, device).cpu().numpy()})
    d = c["dit"]
    text = torch.zeros((b, d["text_len"], d["text_dim"]), device=device)
    n = tr["prompt_tokens"]
    text[:, :n] = 0.2 * torch.randn((b, n, d["text_dim"]), generator=gen, device=device)
    text = text.to(torch.bfloat16)
    for batch in pool:
        batch["prompt_embeds"] = text
    return pool


def voice(tr: dict, b: int, gen, device):
    """[b, samples] of noise in the voice band (80 Hz to 4 kHz), under a
    syllable-rate envelope, at 0.1 of full scale."""
    import torch

    n, sr = tr["audio_samples"], tr["sample_rate"]
    spec = torch.fft.rfft(torch.randn((b, n), generator=gen, device=device))
    hz = torch.fft.rfftfreq(n, 1.0 / sr).to(device)
    wav = torch.fft.irfft(spec * ((hz >= 80) & (hz <= 4000)), n)
    phase = 2 * math.pi * torch.rand((b, 1), generator=gen, device=device)
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 4.0 * torch.arange(n, device=device) / sr + phase)
    wav = wav * env
    return 0.1 * wav / wav.abs().amax(-1, keepdim=True)


def flag_plan(tr: dict, seed: int):
    """Step i's dropout flags ({"audio_dropped", "clip_level"}): the warm-up's
    first three steps one plain, one clip-level and one with the audio
    dropped in an order drawn from the seed, then cycles that each hold the
    traffic's counts of both, in an order drawn from the seed."""
    rng = random.Random(seed)
    kinds = [{"clip_level": True}, {"audio_dropped": True}, {}]
    rng.shuffle(kinds)
    f = tr["flags"]
    while True:
        for k in kinds:
            yield {"audio_dropped": bool(k.get("audio_dropped")), "clip_level": bool(k.get("clip_level"))}
        kinds = ([{"clip_level": True}] * f["clip_level"] + [{"audio_dropped": True}] * f["audio_dropped"]
                 + [{}] * (f["cycle"] - f["clip_level"] - f["audio_dropped"]))
        rng.shuffle(kinds)


def train_config(tr: dict):
    from stableavatar_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(**tr["train"])


def _first_moments(state):
    """AdamW's first-moment list in the program's optimizer state (the
    per-leaf list under "mu"), or None."""
    if isinstance(state, dict):
        if "mu" in state:
            return state["mu"]
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        for v in state:
            got = _first_moments(v)
            if got is not None:
                return got
    return None


@contextlib.contextmanager
def _patched(patches):
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, wrap in patches:
        setattr(m, name, wrap(getattr(m, name)))
    try:
        yield
    finally:
        for m, name, real in saved:
            setattr(m, name, real)


def _ranged(name, fn):
    import torch

    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


class _Program:
    """Drives the program's `train()` and keeps what the judge reads, by
    patching names in the port's modules while the run lasts: the flags and
    the VAE noise handed to `encode_batch`, its outputs, the flow draws and
    the losses of the judged steps, a host copy of AdamW's first moment
    after the first step (and its norm by leaf), and a host copy of the
    DiT after the last judged step.  In a traced run it opens host ranges around the
    encode and the optimizer's calls."""

    def __init__(self, judged, flags, vae_noise, dit, host, first, b1, traced):
        self.judged, self.flags, self.vae_noise, self.traced = judged, flags, vae_noise, traced
        self.dit, self.host, self.first, self.b1 = dit, host, first, b1
        self.encodes = self.steps = 0
        self.encoded, self.draws, self.loss = [], [], []
        self.grad = None
        self.kinds = []

    def encode_batch(self, real):
        def wrapped(models, batch, rng, **kw):
            i = self.encodes
            self.encodes += 1
            f = next(self.flags)
            self.kinds.append(f)
            kw.update(audio_dropout_prob=float(f["audio_dropped"]),
                      clip_level_prob=float(f["clip_level"]))
            if i < self.judged:
                kw["vae_noise"] = self.vae_noise[i]
            out = (_ranged("bench.encode", real) if self.traced else real)(models, batch, rng, **kw)
            if i < self.judged:
                self.encoded.append({k: out[k] for k in ENCODED})
            return out
        return wrapped

    def sample_draws(self, real):
        def wrapped(*a, **k):
            out = real(*a, **k)
            if self.steps < self.judged:
                self.draws.append(out)
            return out
        return wrapped

    def train_step(self, real):
        def wrapped(*a, **k):
            out = real(*a, **k)
            i = self.steps
            self.steps += 1
            if i < self.judged:
                self._judged(i, *out)
            return out
        return wrapped

    def _judged(self, i, params, opt_state, metrics):
        import torch

        from stableavatar_tpu_torch.utils.tree import tree_leaves

        self.loss.append(metrics["loss"])
        if i == 0:
            mu = _first_moments(opt_state)
            by_id = {id(p): path for path, p in rt.paths(self.dit)}
            names = [by_id.get(id(p)) for p in tree_leaves(params)]
            if mu is None or len(mu) != len(names) or None in names:
                raise core.BenchError("the program's AdamW state has no first moment per leaf")
            self.grad = (names, torch.stack([torch.linalg.vector_norm(m.float()) for m in mu])
                         / (1.0 - self.b1))
            for name, m in zip(names, mu):
                self.first[name].copy_(m.detach(), non_blocking=True)
        if i == self.judged - 1:
            for path, p in rt.paths(self.dit):
                self.host[path].copy_(p.detach(), non_blocking=True)

    def make_optimizer(self, real):
        from stableavatar_tpu_torch.train import optim

        def wrapped(*a, **k):
            tx = real(*a, **k)
            return optim.GradientTransformation(tx.init, _ranged("bench.optimizer", tx.update))
        return wrapped


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        variant: str = "program") -> core.Outcome:
    """One run of the cell.  variant "control" puts the reference computed
    with float8 e4m3 products (`reference/train.py:lower_precision`) in the
    program's place, with the flow draws made from the seed: no window."""
    import torch

    if variant not in ("program", "control"):
        raise ValueError(f"unknown variant {variant!r}")
    tr, c = cell.traffic, cell.config
    on_card = torch.device(device).type == "cuda"
    dtypes = [getattr(torch, c["dtypes"][k]) for k in ("dit", "vae", "clip", "wav2vec")]
    specs = [weights.spec_dit(c["dit"]), weights.spec_vae(c["vae"]), weights.spec_clip(c["clip"]),
             weights.spec_wav2vec(c["wav2vec"])]

    def draw_weights():
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return weights.draw(specs, g, device, dtypes)

    models = draw_weights()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    pool = make_pool(tr, c, gen, device, seed)
    judged = tr["judged_steps"]
    shape = latent_shape(tr, c)
    vae_noise = [tuple(torch.randn(shape, generator=gen, device=device).to(dtypes[1])
                       for _ in range(2)) for _ in range(judged)]
    plan = flag_plan(tr, seed)
    flags = [next(plan) for _ in range(judged)]
    tc = tr["train"]
    st = {"start": None, "end": None, "steps": 0, "trace": None, "losses": [], "marks": []}
    if variant == "program":
        prog = _train(cell, seed, seconds, trace, models, pool, vae_noise, flag_plan(tr, seed), st,
                      device)
        draws = prog.pop("draws")
    else:
        draws = [{"noise": torch.randn(shape, generator=gen, device=device),
                  "idx": torch.randint(0, tc["num_train_timesteps"], (shape[0],), generator=gen,
                                       device=device),
                  "mask_flag": torch.rand((), generator=gen, device=device)} for _ in range(judged)]
        steps = _steps(pool, flags, vae_noise, draws)
        with rt.exact_fp32_autograd(), rt.lower_precision():
            prog = rt.follow(c, models, steps, tc, keep=True)
        prog.update(first=prog.pop("first_grads"), first_scale=1.0)
        del prog["params"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    metrics = {}
    if st["steps"]:
        metrics = {"train_step_s": (st["end"] - st["start"]) / st["steps"],
                   "peak_mem_gib": peak / 2 ** 30, "setup_s": st["start"] - t0}
    bad = sum(not math.isfinite(float(x)) for x in st["losses"])
    del models
    if on_card:
        torch.cuda.empty_cache()

    models = draw_weights()  # the seed's weights again, for the reference
    t_ref = time.monotonic()
    with rt.exact_fp32_autograd():
        ref = rt.follow(c, models, _steps(pool, flags, vae_noise, draws), tc, keep=True)
    del ref["params"]
    print(f"avatar_bench: the reference followed {len(draws)} steps in "
          f"{time.monotonic() - t_ref:.1f} s", file=sys.stderr, flush=True)
    if variant == "program":
        prog["change"] = {path: float(torch.linalg.vector_norm(
            prog["host"][path].to(device).float() - p0.float()))
            for path, p0 in rt.paths(models[0])}
    checks = judge(prog, ref, cell.limits)
    f, lh, lw = shape[2:]
    calls = roofline.dit_calls(c["dit"], tr["batch_size"], f, lh, lw,
                               roofline.wav2vec_frames(c["wav2vec"], tr["audio_samples"]),
                               tr["clip_length"])
    ctx = {"trace": st["trace"], "calls": calls, "steps": 1, "train": True}
    return core.Outcome(metrics=metrics, checks=checks, attempted=st["steps"], failed=bad,
                        memory_peak_bytes=peak, trace=st["trace"], layer_ctx=ctx)


def _steps(pool, flags, vae_noise, draws):
    return [{"batch": pool[i % len(pool)], "flags": flags[i], "vae_noise": vae_noise[i], **draws[i]}
            for i in range(len(draws))]


def _pinned(named, dtype, pin: bool) -> dict:
    """Host tensors shaped like the (path, tensor) pairs `named`, in `dtype`
    (None: theirs), views of one flat buffer, pinned where `pin`."""
    import torch

    dtype = dtype or named[0][1].dtype
    flat = torch.empty(sum(p.numel() for _, p in named), dtype=dtype, pin_memory=pin)
    out, at = {}, 0
    for path, p in named:
        out[path] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out


def _train(cell, seed, seconds, traced, models, pool, vae_noise, plan, st, device):
    """The program's run: `train()` over the pool until the window closes.
    Returns what the judge reads of it."""
    import torch

    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.train import loop as loop_mod
    from stableavatar_tpu_torch.train import optim as optim_mod
    from stableavatar_tpu_torch.train import trainer as trainer_mod

    from avatar_bench.trace_train import Tracer

    from avatar_bench.traffic.gen import program_configs

    tr = cell.traffic
    dit, vae, clip, w2v = models
    dit_cfg, vae_cfg, clip_cfg, w2v_cfg = program_configs(cell.config)
    on_card = torch.device(device).type == "cuda"
    host = _pinned(rt.paths(dit), None, on_card)
    first = _pinned(rt.paths(dit), torch.float32, on_card)
    tc = train_config(tr)
    prog = _Program(tr["judged_steps"], plan, vae_noise, dit, host, first, tc.adam_beta1, traced)
    warm = tr["warmup_steps"]
    tracer = Tracer() if traced else None
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def on_step(step, params, metrics):
        now = time.monotonic()
        st["marks"].append(now)
        if step < warm:
            return
        if step == warm:
            sync()
            st["start"] = time.monotonic()
            if tracer is not None:
                tracer.start()
            return
        st["steps"] += 1
        st["losses"].append(metrics["loss"])
        if tracer is not None and st["trace"] is None:
            st["trace"] = tracer.stop(steps=1)
        if now - st["start"] >= seconds:
            sync()
            st["end"] = time.monotonic()

    def feed():
        i = 0
        while st["end"] is None:
            yield pool[i % len(pool)]
            i += 1

    patches = [(loop_mod, "encode_batch", prog.encode_batch),
               (loop_mod, "train_step", prog.train_step),
               (trainer_mod, "sample_draws", prog.sample_draws)]
    if traced:
        patches += [(loop_mod, "make_optimizer", prog.make_optimizer),
                    (optim_mod, "global_norm", lambda f: _ranged("bench.optimizer", f)),
                    (optim_mod, "apply_updates", lambda f: _ranged("bench.optimizer", f))]
    wan = WanModels(dit_params=dit, dit_cfg=dit_cfg, vae_params=vae, vae_cfg=vae_cfg,
                    clip_params=clip, clip_cfg=clip_cfg, wav2vec_params=w2v, wav2vec_cfg=w2v_cfg,
                    device=device)
    out_dir = tempfile.mkdtemp(prefix="avatar_bench_train_")
    loop = tr["loop"]
    try:
        with _patched(patches):
            loop_mod.train(wan, feed(), tc, output_dir=out_dir, seed=seed,
                           train_mode=tr["train_mode"], resume_from_checkpoint="latest",
                           step_callback=on_step, **loop)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if st["end"] is None:
        raise core.BenchError(f"train() stopped before the window of {seconds} s closed")
    sync()
    marks = st["marks"]
    kinds = ["C" if f["clip_level"] else "A" if f["audio_dropped"] else "P" for f in prog.kinds]
    print("avatar_bench: host seconds between steps, by kind: " + " ".join(
        f"{k}{b - a:.3f}" for k, a, b in zip(kinds[1:], marks, marks[1:])),
        file=sys.stderr, flush=True)
    names, norms = prog.grad
    return {"encoded": prog.encoded, "loss": [float(x) for x in prog.loss],
            "grad": dict(zip(names, norms.tolist())), "host": host, "first": first,
            "first_scale": 1.0 / (1.0 - tc.adam_beta1),
            "draws": [{"noise": d["noise"], "idx": d["idx"], "mask_flag": d["mask_flag"]}
                      for d in prog.draws]}


def _rel(got, want) -> float:
    import torch

    num = float(torch.linalg.vector_norm(got.float() - want.float()))
    den = float(torch.linalg.vector_norm(want.float()))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _rel_leaves(got: dict, scale: float, want: dict) -> float:
    """The relative L2 of got x scale against want over all their leaves."""
    import torch

    num = den = 0.0
    for k, w in want.items():
        num += float(torch.linalg.vector_norm(got[k].to(w.device).float() * scale - w)) ** 2
        den += float(torch.linalg.vector_norm(w)) ** 2
    return math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else float("inf"))


def judge(prog: dict, ref: dict, limits: dict):
    """The compared numbers (module docstring), each with its limit."""
    n = len(ref["loss"])
    if len(prog["loss"]) != n or len(prog["encoded"]) != n or set(prog["grad"]) != set(ref["grad"]):
        return [core.Check(k, float("inf"), limits[k]) for k in NUMBERS]
    encode_gap = max(_rel(got[k].to(want[k].device), want[k])
                     for got, want in zip(prog["encoded"], ref["encoded"]) for k in ENCODED)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    grad_gap = _rel_leaves(prog["first"], prog["first_scale"], ref["first_grads"])
    moved = rt.moved_leaves(ref["grad_raw"])
    update_gap = rt.median_leaf_gap(prog["change"], ref["change"], moved)
    for name, got, want, keys in (("grad", prog["grad"], ref["grad"], list(ref["grad"])),
                                  ("update", prog["change"], ref["change"], moved)):
        floor = rt.median(want[k] for k in keys)
        worst = sorted(keys, key=lambda k: -abs(got[k] - want[k]) / max(want[k], floor))[:3]
        print(f"avatar_bench: {name} norms of the widest leaves, program / reference: " + "; ".join(
            f"{k} {got[k]:.6g} / {want[k]:.6g}" for k in worst) + f"; median leaf {floor:.6g}; "
            f"worst-leaf gap {rt.worst_leaf_gap(got, want, keys):.6g}; "
            f"median-leaf gap {rt.median_leaf_gap(got, want, keys):.6g}", file=sys.stderr, flush=True)
    values = dict(encode_gap=encode_gap, loss_gap=loss_gap, grad_gap=grad_gap,
                  update_gap=update_gap)
    return [core.Check(k, values[k] if math.isfinite(values[k]) else float("inf"), limits[k])
            for k in NUMBERS]
