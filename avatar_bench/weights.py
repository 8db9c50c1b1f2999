"""Seeded random weights, made by the benchmark on the card.

Each model is a nested dict / list of leaves in the layout the port reads
(a linear is {"w": [d_out, d_in], "b": [d_out]}, the VAE's norms carry a
float "scale").  `spec_*` give every leaf's shape and distribution; `draw`
makes a tree from them with one generator, filling one flat buffer per
dtype in a few large calls and handing out views of it.  Both the program
and the reference read the trees `draw` returns; neither makes weights.

The distributions are the published initialisations' scales, with three
departures listed in each configuration file's "assumed": norm weights
are 1 + N(0, 0.1) and biases N(0, 0.02) rather than 1 and 0, so that a
dropped norm weight or bias shows; the DiT head (zero in the published
init) is N(0, 0.5 / sqrt(dim)), so that the velocity is not 0; the vocal
k / v projections and the VAE attention's output (also zero-initialised)
get their linear's scale.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28  # elements per fill call


def _n(shape, std, mean=0.0):
    return ("n", tuple(int(s) for s in shape), float(std), float(mean))


def lin(d_in, d_out, bias=True, std=None):
    p = {"w": _n((d_out, d_in), math.sqrt(2.0 / (d_in + d_out)) if std is None else std)}
    if bias:
        p["b"] = _n((d_out,), 0.02)
    return p


def affine(d):
    return {"w": _n((d,), 0.1, 1.0), "b": _n((d,), 0.02)}


def scale(d):
    return {"w": _n((d,), 0.1, 1.0)}


def spec_dit(c: dict) -> dict:
    d, ffn = c["dim"], c["ffn_dim"]
    patch_in = c["in_dim"] * math.prod(c["patch_size"])

    def block():
        return {
            "self_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                          "norm_q": scale(d), "norm_k": scale(d)},
            "norm3": affine(d),
            "cross_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                           "norm_q": scale(d), "norm_k": scale(d), "k_img": lin(d, d),
                           "v_img": lin(d, d), "norm_k_img": scale(d),
                           "k_vocal": lin(d, d), "v_vocal": lin(d, d)},
            "ffn": {"fc1": lin(d, ffn), "fc2": lin(ffn, d)},
            "modulation": _n((1, 6, d), d ** -0.5),
        }

    vd = c["audio_proj_dim"]
    if c.get("audio_proj_hidden") is None:
        proj = {"fc": lin(c["audio_in_dim"], vd, bias=False), "norm": affine(vd)}
    else:
        h = c["audio_proj_hidden"]
        proj = {"fc1": lin(c["audio_in_dim"], h, bias=False), "norm1": affine(h),
                "fc2": lin(h, vd, bias=False), "norm": affine(vd)}

    def vocal_block():
        return {"norm3": affine(vd),
                "cross_attn": {"q": lin(vd, vd), "k": lin(d, vd), "v": lin(d, vd),
                               "o": lin(vd, vd), "norm_q": scale(vd), "norm_k": scale(vd)},
                "ffn": {"fc1": lin(vd, 2 * vd), "fc2": lin(2 * vd, vd)},
                "modulation": _n((1, 6, vd), vd ** -0.5)}

    return {
        "patch_embedding": lin(patch_in, d),
        "text_embedding": {"fc1": lin(c["text_dim"], d), "fc2": lin(d, d)},
        "time_embedding": {"fc1": lin(c["freq_dim"], d), "fc2": lin(d, d)},
        "time_projection": {"fc": lin(d, 6 * d)},
        "img_emb": {"norm1": affine(c["clip_dim"]), "fc1": lin(c["clip_dim"], c["clip_dim"]),
                    "fc2": lin(c["clip_dim"], d), "norm2": affine(d)},
        "blocks": [block() for _ in range(c["num_layers"])],
        "head": {"head": lin(d, math.prod(c["patch_size"]) * c["out_dim"], std=0.5 / math.sqrt(d)),
                 "modulation": _n((1, 2, d), d ** -0.5)},
        "vocal_projector": {
            "proj": proj,
            "blocks": [vocal_block() for _ in range(c["vocal_num_layers"])],
            "final_head": {"final_proj": lin(vd, vd), "modulation": _n((1, 2, vd), vd ** -0.5)},
        },
    }


def _conv(cin, cout, k):
    return {"w": _n((cout, cin, *k), 1.0 / math.sqrt(cin * math.prod(k))), "b": _n((cout,), 0.02)}


def _vnorm(d):
    return {"gamma": _n((d,), 0.1, 1.0), "scale": float(math.sqrt(d))}


def spec_vae(c: dict) -> dict:
    """The encoder and the 1x1x1 convs around the latent (the decoder is not
    on the timed path of any cell; `spec_vae_decoder` adds it where needed)."""
    def res(cin, cout):
        p = {"norm1": _vnorm(cin), "conv1": _conv(cin, cout, (3, 3, 3)),
             "norm2": _vnorm(cout), "conv2": _conv(cout, cout, (3, 3, 3))}
        if cin != cout:
            p["shortcut"] = _conv(cin, cout, (1, 1, 1))
        return p

    dims = [c["dim"] * u for u in [1] + list(c["dim_mult"])]
    enc = {"conv1": _conv(3, dims[0], (3, 3, 3)), "down": []}
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        ch = cin
        for _ in range(c["num_res_blocks"]):
            enc["down"].append(res(ch, cout))
            ch = cout
        if i != len(c["dim_mult"]) - 1:
            rp = {"conv": _conv(cout, cout, (3, 3))}
            if c["temporal_downsample"][i]:
                rp["time_conv"] = _conv(cout, cout, (3, 1, 1))
            enc["down"].append(rp)
    d = dims[-1]
    enc.update(mid1=res(d, d), mid_attn={"norm": _vnorm(d), "qkv": _conv(d, 3 * d, (1, 1)),
                                         "proj": _conv(d, d, (1, 1))},
               mid2=res(d, d), head_norm=_vnorm(d), head_conv=_conv(d, 2 * c["z_dim"], (3, 3, 3)))
    z = c["z_dim"]
    return {"encoder": enc, "conv1": _conv(2 * z, 2 * z, (1, 1, 1)),
            "conv2": _conv(z, z, (1, 1, 1))}


def spec_clip(c: dict) -> dict:
    d, m = c["vision_dim"], c["mlp_ratio"]
    tokens = (c["image_size"] // c["patch_size"]) ** 2 + 1

    def block():
        return {"norm1": affine(d), "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d)},
                "norm2": affine(d), "mlp": {"fc1": lin(d, m * d), "fc2": lin(m * d, d)}}

    return {"patch_embedding": {"w": _n((d, 3 * c["patch_size"] ** 2), 0.02)},
            "cls_embedding": _n((1, 1, d), d ** -0.5),
            "pos_embedding": _n((1, tokens, d), d ** -0.5),
            "pre_norm": affine(d),
            "blocks": [block() for _ in range(c["vision_layers"])]}


def spec_wav2vec(c: dict) -> dict:
    h = c["hidden_size"]
    convs, cin = [], 1
    for i, (cout, k) in enumerate(zip(c["conv_dims"], c["conv_kernels"])):
        p = {"w": _n((cout, cin, k), 0.02)}
        if i == 0:
            p["gn"] = affine(cout)
        convs.append(p)
        cin = cout

    def block():
        return {"attn": {n: lin(h, h) for n in ("q", "k", "v", "o")}, "norm1": affine(h),
                "ffn": {"fc1": lin(h, c["ffn_dim"]), "fc2": lin(c["ffn_dim"], h)},
                "norm2": affine(h)}

    g = c["num_conv_pos_embedding_groups"]
    return {"conv_layers": convs,
            "feature_projection": {"norm": affine(c["conv_dims"][-1]),
                                   "proj": lin(c["conv_dims"][-1], h)},
            "pos_conv": {"w": _n((h, h // g, c["num_conv_pos_embeddings"]), 0.02),
                         "b": _n((h,), 0.02)},
            "encoder_norm": affine(h),
            "blocks": [block() for _ in range(c["num_layers"])]}


def _leaves(spec, out):
    if isinstance(spec, dict):
        for v in spec.values():
            _leaves(v, out)
    elif isinstance(spec, list):
        for v in spec:
            _leaves(v, out)
    elif isinstance(spec, tuple):
        out.append(spec)
    return out


def draw(specs, gen: torch.Generator, device, dtypes):
    """Materialise the trees `specs` (a list) with `gen`, tree i in dtype
    dtypes[i]: one flat buffer a dtype, filled with N(0, 1) in chunks of
    CHUNK elements, each leaf a view scaled and shifted in place."""
    by_dtype = {}
    for spec, dt in zip(specs, dtypes):
        by_dtype.setdefault(dt, []).extend(_leaves(spec, []))
    views = {}
    for dt, leaves in by_dtype.items():
        total = sum(math.prod(s) for _, s, _, _ in leaves)
        buf = torch.empty(total, dtype=dt, device=device)
        for a in range(0, total, CHUNK):
            buf[a:a + CHUNK].normal_(generator=gen)
        off, out = 0, []
        for _, shape, std, mean in leaves:
            n = math.prod(shape)
            out.append(buf[off:off + n].view(shape).mul_(std).add_(mean))
            off += n
        views[dt] = iter(out)

    def build(spec, dt):
        if isinstance(spec, dict):
            return {k: build(v, dt) for k, v in spec.items()}
        if isinstance(spec, list):
            return [build(v, dt) for v in spec]
        if isinstance(spec, tuple):
            return next(views[dt])
        return spec

    return [build(spec, dt) for spec, dt in zip(specs, dtypes)]
