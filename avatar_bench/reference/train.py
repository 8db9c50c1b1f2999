"""One fine-tuning step of the talking DiT after another, in float32.

The step the port's train CLI runs by default (`train/loop.py:train` at its
defaults): the raw clip batch encoded, the flow-matching noisy latents and
target, the DiT forward and the masked flow loss, the gradient of every
parameter by autograd, the anomaly-aware global-norm clip and AdamW.  The
parameters are kept in the dtype the configuration states for the DiT and
rounded to it after every update; everything else is float32 with TF32
off.  The draws that make a step random are inputs here: the VAE posterior
noise, the flow noise, the timestep index, the loss-mask draw and the
dropout flags.

Autograd holds one block's activations at a time (each block recomputed
in the backward, as `torch.utils.checkpoint` does) and one block of
attention queries at a time (each query block recomputed likewise), so
the step fits the card at the cell's size.

`lower_precision()` puts every product of the DiT through float8 e4m3
(the linears' inputs and weights, attention's q, k, probabilities and v,
each rounded with one scale a tensor, the product in float32): the
reference computed one precision below the configuration's bfloat16, the
benchmark's control.  It reads only the trees and batches it
is given and imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from avatar_bench.reference import common as rc
from avatar_bench.reference import dit as rd
from avatar_bench.reference import encoders as re_

# logits of one block of attention queries stay under this many bytes
ATTN_BLOCK_BYTES = 1 << 30
_FP8 = contextvars.ContextVar("avatar_bench_reference_fp8", default=False)


@contextlib.contextmanager
def exact_fp32_autograd():
    """float32 products without TF32, autograd on; the settings restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.enable_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def lower_precision():
    """The DiT's products in float8 e4m3 while open (module docstring)."""
    token = _FP8.set(True)
    try:
        yield
    finally:
        _FP8.reset(token)


def _e4m3(x):
    """x rounded to float8 e4m3 under one scale (its absolute max to 448),
    the gradient passed straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x.detach())


def linear(p, x):
    if not _FP8.get():
        return rc.linear(p, x)
    b = p.get("b")
    return F.linear(_e4m3(x.float()), _e4m3(p["w"].float()), None if b is None else b.float())


# ---------------------------------------------------------------------------
# attention, one block of queries at a time under autograd
# ---------------------------------------------------------------------------


def _attend(q, k, v, mask, scale):
    fp8 = _e4m3 if _FP8.get() else (lambda x: x)
    logits = torch.matmul(fp8(q.permute(0, 2, 1, 3)), fp8(k.permute(0, 2, 3, 1))) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.nan_to_num(probs, nan=0.0)
    return torch.matmul(fp8(probs), fp8(v.permute(0, 2, 1, 3))).permute(0, 2, 1, 3)


def attention(q, k, v, k_lens=None):
    """Softmax attention of q [B, Lq, N, D] over k, v [B, Lk, N, D] (keys at
    or past k_lens[b] left out), each block of queries recomputed in the
    backward."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    q, k, v = q.float(), k.float(), v.float()
    mask = None
    if k_lens is not None:
        cols = torch.arange(lk, device=q.device)
        mask = (cols[None, :] < k_lens.to(q.device)[:, None])[:, None, None, :]
    block = max(1, min(lq, ATTN_BLOCK_BYTES // (4 * b * n * lk)))
    return torch.cat([checkpoint(_attend, q[:, s:s + block], k, v, mask, d ** -0.5,
                                 use_reentrant=False) for s in range(0, lq, block)], 1)


# ---------------------------------------------------------------------------
# the DiT, one row per clip, its own audio on each
# ---------------------------------------------------------------------------


def vocal_projector(p, cfg, audio, latents, e0, e, n_frames):
    """As `reference/dit.py:vocal_projector`, with this module's linears and
    attention: audio [B, La, 768] on the latents [B, L, dim] of each row."""
    pp = p["proj"]
    if "fc" in pp:
        x = linear(pp["fc"], audio)
    else:
        x = linear(pp["fc2"], rc.layer_norm(linear(pp["fc1"], audio), pp["norm1"], 1e-5))
    x = rc.layer_norm(x, pp["norm"], 1e-5)
    gather, mask, lens = rd.vocal_windows(x.shape[1], n_frames)
    b, vd = x.shape[0], x.shape[-1]
    f, lw = gather.shape
    idx = torch.as_tensor(gather.reshape(-1), device=x.device)
    x = x.index_select(1, idx).reshape(b, f, lw, vd)
    x = (x * torch.as_tensor(mask, device=x.device)[None, :, :, None]).reshape(b, f * lw, vd)
    heads, eps = cfg["vocal_num_heads"], cfg["eps"]
    d = vd // heads
    for bp in p["blocks"]:
        m = bp["modulation"].float() + e0
        x = x + (rc.layer_norm(x, None, eps) * (1 + m[:, 1:2]) + m[:, 0:1]) * m[:, 2:3]
        normed = rc.layer_norm(x, bp["norm3"], eps)
        ca = bp["cross_attn"]
        q = rc.rms_norm(linear(ca["q"], normed), ca["norm_q"]["w"], eps).reshape(b * f, -1, heads, d)
        k = rc.rms_norm(linear(ca["k"], latents), ca["norm_k"]["w"], eps).reshape(b * f, -1, heads, d)
        v = linear(ca["v"], latents).reshape(b * f, -1, heads, d)
        x = x + linear(ca["o"], attention(q, k, v).reshape(b, -1, vd))
        h = rc.layer_norm(x, None, eps) * (1 + m[:, 4:5]) + m[:, 3:4]
        x = x + linear(bp["ffn"]["fc2"], rc.gelu_tanh(linear(bp["ffn"]["fc1"], h))) * m[:, 5:6]
    hm = p["final_head"]["modulation"].float() + e[:, None]
    x = linear(p["final_head"]["final_proj"],
               rc.layer_norm(x, None, eps) * (1 + hm[:, 1:2]) + hm[:, 0:1])
    return x.reshape(b, f, lw, vd), torch.as_tensor(lens, device=x.device)


def self_attention(p, cfg, h, cos, sin):
    b, l, dim = h.shape
    heads, eps = cfg["num_heads"], cfg["eps"]
    d = dim // heads
    q = rc.rope(rc.rms_norm(linear(p["q"], h), p["norm_q"]["w"], eps).reshape(b, l, heads, d),
                cos, sin)
    k = rc.rope(rc.rms_norm(linear(p["k"], h), p["norm_k"]["w"], eps).reshape(b, l, heads, d),
                cos, sin)
    v = linear(p["v"], h).reshape(b, l, heads, d)
    return linear(p["o"], attention(q, k, v).reshape(b, l, dim))


def cross_attention(p, cfg, h, text, img, vocal, vocal_lens):
    """Text + image + vocal cross-attention: vocal [B, Fv, Lw, dim], the
    tokens split into Fv equal groups, each attending its own Lw vocal
    tokens (the first vocal_lens[f] of them; None: all)."""
    b, l, dim = h.shape
    heads, eps = cfg["num_heads"], cfg["eps"]
    d = dim // heads
    q = rc.rms_norm(linear(p["q"], h), p["norm_q"]["w"], eps).reshape(b, l, heads, d)
    kt = rc.rms_norm(linear(p["k"], text), p["norm_k"]["w"], eps).reshape(b, -1, heads, d)
    vt = linear(p["v"], text).reshape(b, -1, heads, d)
    ki = rc.rms_norm(linear(p["k_img"], img), p["norm_k_img"]["w"], eps).reshape(b, -1, heads, d)
    vi = linear(p["v_img"], img).reshape(b, -1, heads, d)
    out = attention(q, kt, vt) + attention(q, ki, vi)
    f = vocal.shape[1]
    vq = q.reshape(b * f, l // f, heads, d)
    vk = linear(p["k_vocal"], vocal).reshape(b * f, -1, heads, d)
    vv = linear(p["v_vocal"], vocal).reshape(b * f, -1, heads, d)
    lens = None if vocal_lens is None else vocal_lens.repeat(b)
    out = out + attention(vq, vk, vv, k_lens=lens).reshape(b, l, heads, d)
    return linear(p["o"], out.reshape(b, l, dim))


def block(p, cfg, e0, text, img, vocal, vocal_lens, cos, sin, x):
    eps = cfg["eps"]
    m = p["modulation"].float() + e0
    h = rc.layer_norm(x, None, eps) * (1 + m[:, 1:2]) + m[:, 0:1]
    x = x + self_attention(p["self_attn"], cfg, h, cos, sin) * m[:, 2:3]
    h = rc.layer_norm(x, p["norm3"], eps)
    x = x + cross_attention(p["cross_attn"], cfg, h, text, img, vocal, vocal_lens)
    h = rc.layer_norm(x, None, eps) * (1 + m[:, 4:5]) + m[:, 3:4]
    ffn = p["ffn"]
    return x + linear(ffn["fc2"], rc.gelu_tanh(linear(ffn["fc1"], h))) * m[:, 5:6]


def dit_forward(params, cfg, x, t, text, clip_fea, y, audio, n_frames: int,
                clip_level: bool = False):
    """The velocity [B, out_dim, F, H, W] of each row: x [B, 16, F, H, W],
    t [B], text [B, 512, 4096], clip_fea [B, 257, 1280], y [B, 20, F, H, W],
    audio [B, La, 768] each row's wav2vec states.  With `clip_level` every
    token attends all the clip's vocal tokens (padding included) in one
    pass, else the tokens of each latent frame its own window."""
    patch = tuple(cfg["patch_size"])
    b, _, f, h, w = x.shape
    grid = (f // patch[0], h // patch[1], w // patch[2])
    dim, heads = cfg["dim"], cfg["num_heads"]
    tokens = linear(params["patch_embedding"], rd.patchify(torch.cat([x, y], 1).float(), patch))
    cos, sin = rc.rope_tables(grid, dim // heads, x.device)
    te = params["time_embedding"]
    e = linear(te["fc2"], F.silu(linear(te["fc1"], rc.sinusoidal_embedding(cfg["freq_dim"], t))))
    e0 = linear(params["time_projection"]["fc"], F.silu(e)).reshape(b, 6, dim)
    tp = params["text_embedding"]
    text = linear(tp["fc2"], rc.gelu_tanh(linear(tp["fc1"], text)))
    ip = params["img_emb"]
    img = rc.layer_norm(linear(ip["fc2"], rc.gelu_exact(linear(
        ip["fc1"], rc.layer_norm(clip_fea, ip["norm1"], 1e-5)))), ip["norm2"], 1e-5)
    vocal, lens = vocal_projector(params["vocal_projector"], cfg, audio.float(), tokens, e0, e,
                                  n_frames)
    if clip_level:
        vocal, lens = vocal.reshape(b, 1, -1, vocal.shape[-1]), None
    for bp in params["blocks"]:
        fn = functools.partial(block, bp, cfg, e0, text, img, vocal, lens, cos, sin)
        tokens = checkpoint(fn, tokens, use_reentrant=False)
    hp = params["head"]
    hm = hp["modulation"].float() + e[:, None]
    out = linear(hp["head"], rc.layer_norm(tokens, None, cfg["eps"]) * (1 + hm[:, 1:2])
                 + hm[:, 0:1])
    return rd.unpatchify(out, grid, patch, cfg["out_dim"])


# ---------------------------------------------------------------------------
# the batch's encodes
# ---------------------------------------------------------------------------


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of an antialiased linear resize
    (`jax.image.resize(method="linear")`): half-pixel centres, a triangle
    widened by the downscale factor, columns summing to 1, samples outside
    the input zero."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centre = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(centre[None, :] - np.arange(n_in)[:, None]) / width
    k = np.maximum(0.0, 1.0 - x)
    total = k.sum(axis=0, keepdims=True)
    k = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 k / np.where(total != 0, total, 1), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], k, 0.0).astype(np.float32)


def resize(x, shape):
    """x resized to `shape` axis by axis (`resize_weights`)."""
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = torch.as_tensor(resize_weights(n_in, n_out), device=x.device)
            x = torch.movedim(torch.tensordot(x.float(), w, dims=([axis], [0])), -1, axis)
    return x


def vae_posterior(params, cfg, video):
    """(normalised mean, raw log-variance) of the VAE posterior of video
    [B, 3, 1 + 4n, H, W], both [B, z, 1 + n, H/8, W/8]: the causal encoder
    of `reference/encoders.py:vae_encode` with the log-variance kept."""
    carry = re_._Carry()
    parts = [re_._encode_chunk(params["encoder"], cfg, video[:, :, :1].float(), carry, True)]
    for s in range(1, video.shape[2], 4):
        carry = re_._Carry(carry.out)
        parts.append(re_._encode_chunk(params["encoder"], cfg, video[:, :, s:s + 4].float(), carry,
                                       False))
    z = re_._conv(params["conv1"], torch.cat(parts, 2))
    mu, logvar = z[:, :cfg["z_dim"]], z[:, cfg["z_dim"]:]
    mean = torch.as_tensor(cfg["latent_mean"], device=z.device).reshape(1, -1, 1, 1, 1)
    std = torch.as_tensor(cfg["latent_std"], device=z.device).reshape(1, -1, 1, 1, 1)
    return (mu - mean) / std, logvar


def sample_latents(params, cfg, video, noise):
    """The posterior sampled with `noise`: mean + exp(log_var / 2) noise,
    the log-variance clipped to [-30, 20]."""
    mu, logvar = vae_posterior(params, cfg, video)
    return mu + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.float()


def encode(c: dict, vae, clip, w2v, batch: dict, flags: dict, vae_noise) -> Dict[str, torch.Tensor]:
    """The DiT's inputs of one raw batch (the clip dataset's layout, one
    row): the latents of the clip and of the masked clip sampled with
    `vae_noise` (a pair), the inpaint latents (the pixel mask packed four
    frames to a latent frame, the first frame four times, inverted and
    resized to the latent grid, before the masked clip's latents; zero for
    a t2v step), the CLIP features of the reference image, the wav2vec
    states of the audio (zero where the audio is dropped), and the face and
    lip masks resized to the latent grid."""
    dev = vae_noise[0].device

    def dev_(k):
        return torch.as_tensor(batch[k], device=dev)

    pixels = dev_("pixel_values").float()
    lat = sample_latents(vae, c["vae"], pixels, vae_noise[0])
    masked = sample_latents(vae, c["vae"], dev_("masked_pixel_values").float(), vae_noise[1])
    b, _, f, lh, lw = lat.shape
    m = dev_("pixel_value_masks").float()[:, :, 0]  # [B, T, H, W]
    m = torch.cat([m[:, :1].repeat(1, 4, 1, 1), m[:, 1:]], 1)
    m = m.reshape(b, m.shape[1] // 4, 4, *m.shape[-2:]).transpose(1, 2)
    m = resize(1.0 - m, (*m.shape[:3], lh, lw))
    inpaint = torch.cat([m, masked], 1) * (0.0 if flags.get("t2v") else 1.0)
    ref = dev_("reference_image").float()[:, :, 0]
    states = torch.cat([re_.wav2vec_states(w2v, c["wav2vec"], wav) for wav in dev_(
        "vocal_input_values").float()], 0)
    if flags.get("audio_dropped"):
        states = torch.zeros_like(states)

    def masks(k):
        return resize(dev_(k).float()[:, 0], (b, f, lh, lw))[:, None]

    return {"latents": lat, "inpaint_latents": inpaint,
            "clip_fea": re_.clip_features(clip, c["clip"], ref), "vocal_embeddings": states,
            "face_masks": masks("tgt_face_masks"), "lip_masks": masks("tgt_lip_masks")}


# ---------------------------------------------------------------------------
# the loss, the clip and AdamW
# ---------------------------------------------------------------------------


def train_sigmas(n: int, shift: float) -> np.ndarray:
    """The training sigmas, float32: 1 .. 1/n, shifted."""
    s = np.linspace(1, n, n, dtype=np.float32)[::-1] / np.float32(n)
    return (shift * s / (1 + (shift - 1) * s)).astype(np.float32)


def flow_loss(pred, target, face, lip, mask_flag: float):
    """The mean squared error weighted by the face mask (draw in [0.4,
    0.5)), the lip mask (draw >= 0.5) or 1 + face + lip (else)."""
    if 0.4 <= mask_flag < 0.5:
        w = face
    elif mask_flag >= 0.5:
        w = lip
    else:
        w = 1.0 + face + lip
    return ((pred - target).square() * w).mean()


def max_norm(tc: dict, gnorm: float, count: int) -> float:
    """The anomaly-aware clipping bound after `count` optimizer steps: from
    max_grad_norm x initial ratio down to max_grad_norm over
    abnormal_norm_clip_start steps, and after those a tenth of it at most
    where the norm passes five times the bound."""
    start, final = tc["max_grad_norm"] * tc["initial_grad_norm_ratio"], tc["max_grad_norm"]
    steps = tc["abnormal_norm_clip_start"]
    bound = start + (final - start) * min(max(count / max(steps, 1), 0.0), 1.0)
    ratio = gnorm / bound
    return bound / min(ratio, 10.0) if ratio > 5.0 and count > steps else bound


def paths(tree, prefix="") -> List[tuple]:
    """(path, leaf) pairs of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in paths(v, f"{prefix}/{i}")]
    return [(prefix.lstrip("/"), tree)]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def follow(c: dict, models, steps: List[dict], tc: dict, keep: bool = False) -> dict:
    """Train the DiT of `models` ((dit, vae, clip, wav2vec) trees, the DiT's
    leaves in the dtype they are kept in, left unchanged) for len(steps)
    steps from its weights.  A step is {"batch", "flags" ({"audio_dropped",
    "clip_level", "t2v"}), "vae_noise" (pair), "noise", "idx", "mask_flag"};
    tc the traffic's optimizer settings.  Returns each step's encodes and
    loss, the first step's gradient by leaf path (its norm before and after
    the clip) and each leaf's change after the last step (its norm); with
    `keep` also the first step's clipped gradients ("first_grads") and the
    last parameters ("params"), by leaf path, on the device."""
    dit, vae, clip, w2v = models
    d = c["dit"]
    named = paths(dit)
    stored = named[0][1].dtype
    live = [p.detach().float().clone().requires_grad_(True) for _, p in named]
    params = _rebuild(dit, iter(live))
    m = [torch.zeros_like(p) for p in live]
    v = [torch.zeros_like(p) for p in live]
    sig = train_sigmas(tc["num_train_timesteps"], tc["shift"])
    b1, b2 = tc["adam_beta1"], tc["adam_beta2"]
    out = {"encoded": [], "loss": []}
    for i, s in enumerate(steps):
        with torch.no_grad():
            enc = encode(c, vae, clip, w2v, s["batch"], s["flags"], s["vae_noise"])
        out["encoded"].append(enc)
        lat = enc["latents"]
        sigma = torch.as_tensor(sig[np.asarray(s["idx"].cpu())], device=lat.device)
        sigma = sigma.reshape(-1, 1, 1, 1, 1)
        noise = s["noise"].float()
        noisy = (1.0 - sigma) * lat + sigma * noise
        pred = dit_forward(params, d, noisy, sigma.reshape(-1) * tc["num_train_timesteps"],
                           torch.as_tensor(s["batch"]["prompt_embeds"], device=lat.device).float(),
                           enc["clip_fea"], enc["inpaint_latents"], enc["vocal_embeddings"],
                           tc["video_sample_n_frames"], bool(s["flags"].get("clip_level")))
        loss = flow_loss(pred, noise - lat, enc["face_masks"], enc["lip_masks"],
                         float(s["mask_flag"]))
        grads = torch.autograd.grad(loss, live)
        del pred
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
            gnorm = float(torch.linalg.vector_norm(norms))
            scale = min(max_norm(tc, gnorm, i) / (gnorm + 1e-6), 1.0)
            if i == 0:
                out["grad_raw"] = {p: float(n) for (p, _), n in zip(named, norms)}
                out["grad"] = {p: float(n) * scale for (p, _), n in zip(named, norms)}
                if keep:
                    out["first_grads"] = {p: g * scale for (p, _), g in zip(named, grads)}
            t = i + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            for j, g in enumerate(grads):
                g = g * scale
                m[j].mul_(b1).add_((1 - b1) * g)
                v[j].mul_(b2).add_((1 - b2) * g.square())
                u = m[j] / c1 / (torch.sqrt(v[j] / c2) + tc["adam_eps"])
                u = -tc["learning_rate"] * (u + tc["weight_decay"] * live[j])
                live[j].copy_((live[j] + u).to(stored).float())
        del grads
    with torch.no_grad():
        out["change"] = {p: float(torch.linalg.vector_norm(live[j] - p0.float()))
                         for j, (p, p0) in enumerate(named)}
    if keep:
        out["params"] = {p: live[j].detach() for j, (p, _) in enumerate(named)}
    return out


def median(values) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves=None) -> List[float]:
    """Each leaf's gap between two norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    leaves = list(want) if leaves is None else list(leaves)
    floor = median(want[k] for k in leaves)
    return [abs(got[k] - want[k]) / max(want[k], floor, 1e-30) for k in leaves]


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves=None) -> float:
    """The largest of `leaf_gaps`."""
    return max(leaf_gaps(got, want, leaves), default=0.0)


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves=None) -> float:
    """The median of `leaf_gaps`: each leaf's own gap, then the median leaf."""
    gaps = leaf_gaps(got, want, leaves)
    return median(gaps) if gaps else 0.0


def moved_leaves(grad_raw: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose first gradient is at least `share` of the median
    leaf's: those whose gradient is not nought to rounding (a key's bias
    under softmax), which AdamW moves by round-off alone."""
    floor = share * median(grad_raw.values())
    return [k for k, g in grad_raw.items() if g >= floor and math.isfinite(g)]
