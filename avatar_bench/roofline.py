"""The card's peaks and the work of the DiT's calls, from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense
rates).  A call's bound is the least time the card could take for it: the
larger of its operations over the bf16 peak and its bytes over the memory
rate, each input read once and each output written once (2 bytes an
element).  The work is defined by the model's calls, whatever kernel
computes them.
"""

from __future__ import annotations

import dataclasses
from typing import List

from avatar_bench.reference.dit import vocal_windows

PEAK_BF16 = 989e12  # FLOP/s, dense
HBM_BYTES_S = 3.35e12
BF16 = 2


@dataclasses.dataclass(frozen=True)
class Call:
    kind: str  # "linear", "attention" (counted in the attention share) or "vocal_attention"
    name: str
    flops: float
    nbytes: float

    @property
    def bound_s(self) -> float:
        return max(self.flops / PEAK_BF16, self.nbytes / HBM_BYTES_S)


def linear(name, m, k, n) -> Call:
    return Call("linear", name, 2.0 * m * k * n, BF16 * (m * k + k * n + m * n))


def attention(name, b, heads, lq, lk, d, kind="attention") -> Call:
    """Softmax attention of b x heads rows: Q.K^T and P.V (4 b h lq lk d
    operations), q, k, v read and o written once."""
    return Call(kind, name, 4.0 * b * heads * lq * lk * d, BF16 * b * heads * d * (2 * lq + 2 * lk))


def wav2vec_frames(c: dict, samples: int) -> int:
    n = samples
    for k, s in zip(c["conv_kernels"], c["conv_strides"]):
        n = (n - k) // s + 1
    return n


def dit_calls(c: dict, rows: int, latent_frames: int, lh: int, lw: int, audio_tokens: int,
              video_frames: int) -> List[Call]:
    """Every linear and attention call of one DiT forward over `rows` CFG rows
    of latent_frames x lh x lw latents, with `audio_tokens` wav2vec states run
    through the vocal projector once (on the last row, tiled to the others)."""
    pt, ph, pw = c["patch_size"]
    f, gh, gw = latent_frames // pt, lh // ph, lw // pw
    seq = f * gh * gw
    d, heads, ffn = c["dim"], c["num_heads"], c["ffn_dim"]
    hd = d // heads
    vd, vheads = c["audio_proj_dim"], c["vocal_num_heads"]
    gather, _, _ = vocal_windows(audio_tokens, video_frames)
    nf, lwin = gather.shape
    m, txt, img = rows * seq, rows * c["text_len"], rows * c["clip_tokens"]
    out = [linear("patch_embedding", m, c["in_dim"] * pt * ph * pw, d),
           linear("time_embedding.fc1", rows, c["freq_dim"], d),
           linear("time_embedding.fc2", rows, d, d),
           linear("time_projection", rows, d, 6 * d),
           linear("text_embedding.fc1", txt, c["text_dim"], d),
           linear("text_embedding.fc2", txt, d, d),
           linear("img_emb.fc1", img, c["clip_dim"], c["clip_dim"]),
           linear("img_emb.fc2", img, c["clip_dim"], d)]
    a = audio_tokens
    if c.get("audio_proj_hidden") is None:
        out.append(linear("vocal.proj", a, c["audio_in_dim"], vd))
    else:
        out += [linear("vocal.proj1", a, c["audio_in_dim"], c["audio_proj_hidden"]),
                linear("vocal.proj2", a, c["audio_proj_hidden"], vd)]
    av = nf * lwin
    for _ in range(c["vocal_num_layers"]):
        out += [linear("vocal.q", av, vd, vd), linear("vocal.k", seq, d, vd),
                linear("vocal.v", seq, d, vd), linear("vocal.o", av, vd, vd),
                linear("vocal.fc1", av, vd, 2 * vd), linear("vocal.fc2", av, 2 * vd, vd),
                attention("vocal_projector", nf, vheads, lwin, seq // nf, vd // vheads,
                          kind="vocal_attention")]
    out.append(linear("vocal.final_proj", av, vd, vd))
    for _ in range(c["num_layers"]):
        out += [linear("self.q", m, d, d), linear("self.k", m, d, d), linear("self.v", m, d, d),
                linear("self.o", m, d, d),
                attention("self", rows, heads, seq, seq, hd),
                linear("cross.q", m, d, d), linear("cross.k", txt, d, d),
                linear("cross.v", txt, d, d), linear("cross.k_img", img, d, d),
                linear("cross.v_img", img, d, d),
                linear("cross.k_vocal", rows * nf * lwin, vd, d),
                linear("cross.v_vocal", rows * nf * lwin, vd, d),
                attention("text", rows, heads, seq, c["text_len"], hd),
                attention("image", rows, heads, seq, c["clip_tokens"], hd),
                attention("vocal", rows * nf, heads, seq // nf, lwin, hd, kind="vocal_attention"),
                linear("cross.o", m, d, d), linear("ffn.fc1", m, d, ffn), linear("ffn.fc2", m, ffn, d)]
    out.append(linear("head", m, d, pt * ph * pw * c["out_dim"]))
    return out


def model_flops(calls: List[Call]) -> float:
    """The model's operations: every linear and attention product."""
    return sum(x.flops for x in calls)


def bound_s(calls: List[Call], kind: str) -> float:
    return sum(x.bound_s for x in calls if x.kind == kind)
