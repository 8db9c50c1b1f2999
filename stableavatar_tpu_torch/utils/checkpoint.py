"""Checkpoint I/O of the port (port of `stableavatar_tpu/utils/checkpoint.py`).

The reference weight files map onto the port's parameter trees (the trees
`utils/weights.py` bridges from the JAX package and the `init_*`
initialisers draw): the Wan DiT `diffusion_pytorch_model.safetensors` and
fine-tuned `.pt` overrides (patch-embed channel padding, size-mismatched
keys skipped), `Wan2.1_VAE.pth`, `models_t5_umt5-xxl-enc-bf16.pth`, the
open-clip XLM-RoBERTa ViT-H `.pth` and HF wav2vec2-base-960h.  The port's
trees keep PyTorch's layouts (linear [d_out, d_in], convs [O, I, k...]), so
each converter is a key map: only the patch embeddings (flattened to one
matmul), the VAE norm gammas (flattened) and wav2vec2's weight-normed
position conv change.

State dicts hold CPU tensors (numpy arrays are accepted too).  `.pt` /
`.pth` files load through `torch.load(weights_only=True)`, `.safetensors`
through the reader here (8-byte little-endian header length, JSON header,
raw little-endian buffers), so no `safetensors` package is needed.  The
converted trees stay on the host, in the file's dtype; `to_device` casts
and copies each leaf to the card once.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from stableavatar_tpu_torch.utils.tree import tree_map

StateDict = Mapping[str, torch.Tensor]

# safetensors dtype names <-> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> {name: CPU tensor}, each read straight into
    its tensor's memory."""
    out = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            start, end = info["data_offsets"]
            buf = torch.empty(end - start, dtype=torch.uint8)
            f.seek(base + start)
            if f.readinto(buf.numpy()) != end - start:
                raise ValueError(f"{path}: {name} is truncated")
            out[name] = buf.view(_ST_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as a `.safetensors` file (numpy arrays too)."""
    tensors = {k: torch.as_tensor(v).detach().cpu().contiguous() for k, v in tensors.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.pt` / `.pth` / `.safetensors` file -> {name: CPU tensor} (host
    RAM, the file's dtypes)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def to_device(tree, device, dtype=None):
    """Copy each tensor leaf to `device` once, floating leaves cast to
    `dtype` on the host first (python-float leaves pass through)."""
    def move(x):
        if not torch.is_tensor(x):
            return x
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return x.to(device).contiguous()

    return tree_map(move, tree)


# ---------------------------------------------------------------------------
# key maps
# ---------------------------------------------------------------------------


def _get(sd, key) -> torch.Tensor:
    return torch.as_tensor(sd[key])


def _lin(sd, name, bias=True):
    p = {"w": _get(sd, f"{name}.weight")}
    if bias and f"{name}.bias" in sd:
        p["b"] = _get(sd, f"{name}.bias")
    return p


def _ln(sd, name):
    return {"w": _get(sd, f"{name}.weight"), "b": _get(sd, f"{name}.bias")}


def _rms(sd, name):
    return {"w": _get(sd, f"{name}.weight")}


def convert_dit(sd: StateDict, cfg) -> dict:
    """Wan DiT state dict -> the port's DiT tree (a list of blocks).  A
    patch embedding with fewer input channels than cfg.in_dim (the 16-channel
    base model under the 36-channel talking model) is zero-padded."""
    pe_w = _get(sd, "patch_embedding.weight")  # [O, I, kt, kh, kw]
    if pe_w.shape[1] < cfg.in_dim:
        pad = pe_w.new_zeros((pe_w.shape[0], cfg.in_dim - pe_w.shape[1], *pe_w.shape[2:]))
        pe_w = torch.cat([pe_w, pad], dim=1)

    def block(i):
        b = f"blocks.{i}"
        return {
            "self_attn": {
                **{n: _lin(sd, f"{b}.self_attn.{n}") for n in ("q", "k", "v", "o")},
                "norm_q": _rms(sd, f"{b}.self_attn.norm_q"),
                "norm_k": _rms(sd, f"{b}.self_attn.norm_k"),
            },
            "norm3": _ln(sd, f"{b}.norm3"),
            "cross_attn": {
                **{n: _lin(sd, f"{b}.cross_attn.{n}") for n in ("q", "k", "v", "o")},
                "norm_q": _rms(sd, f"{b}.cross_attn.norm_q"),
                "norm_k": _rms(sd, f"{b}.cross_attn.norm_k"),
                "k_img": _lin(sd, f"{b}.cross_attn.k_img"),
                "v_img": _lin(sd, f"{b}.cross_attn.v_img"),
                "norm_k_img": _rms(sd, f"{b}.cross_attn.norm_k_img"),
                "k_vocal": _lin(sd, f"{b}.cross_attn.k_vocal"),
                "v_vocal": _lin(sd, f"{b}.cross_attn.v_vocal"),
            },
            "ffn": {"fc1": _lin(sd, f"{b}.ffn.0"), "fc2": _lin(sd, f"{b}.ffn.2")},
            "modulation": _get(sd, f"{b}.modulation"),
        }

    return {
        "patch_embedding": {"w": pe_w.reshape(pe_w.shape[0], -1),
                            "b": _get(sd, "patch_embedding.bias")},
        "text_embedding": {"fc1": _lin(sd, "text_embedding.0"),
                           "fc2": _lin(sd, "text_embedding.2")},
        "time_embedding": {"fc1": _lin(sd, "time_embedding.0"),
                           "fc2": _lin(sd, "time_embedding.2")},
        "time_projection": {"fc": _lin(sd, "time_projection.1")},
        "img_emb": {"norm1": _ln(sd, "img_emb.proj.0"), "fc1": _lin(sd, "img_emb.proj.1"),
                    "fc2": _lin(sd, "img_emb.proj.3"), "norm2": _ln(sd, "img_emb.proj.4")},
        "blocks": [block(i) for i in range(cfg.num_layers)],
        "head": {"head": _lin(sd, "head.head"), "modulation": _get(sd, "head.modulation")},
        "vocal_projector": convert_vocal_projector(sd, cfg, prefix="vocal_projector."),
    }


def convert_vocal_projector(sd: StateDict, cfg, prefix: str = "") -> dict:
    """The 1B projector (one projection) or the 14B one (two stages)."""
    if prefix + "proj_model.proj.weight" in sd:
        proj = {"fc": _lin(sd, f"{prefix}proj_model.proj", bias=False),
                "norm": _ln(sd, f"{prefix}proj_model.norm")}
    else:
        proj = {"fc1": _lin(sd, f"{prefix}proj_model.proj_1", bias=False),
                "norm1": _ln(sd, f"{prefix}proj_model.norm_1"),
                "fc2": _lin(sd, f"{prefix}proj_model.proj_2", bias=False),
                "norm": _ln(sd, f"{prefix}proj_model.norm_2")}

    def block(i):
        b = f"{prefix}blocks.{i}"
        return {
            "norm3": _ln(sd, f"{b}.norm3"),
            "cross_attn": {
                **{n: _lin(sd, f"{b}.cross_attn.{n}") for n in ("q", "k", "v", "o")},
                "norm_q": _rms(sd, f"{b}.cross_attn.norm_q"),
                "norm_k": _rms(sd, f"{b}.cross_attn.norm_k"),
            },
            "ffn": {"fc1": _lin(sd, f"{b}.ffn.0"), "fc2": _lin(sd, f"{b}.ffn.2")},
            "modulation": _get(sd, f"{b}.modulation"),
        }

    return {
        "proj": proj,
        "blocks": [block(i) for i in range(cfg.vocal_num_layers)],
        "final_head": {"final_proj": _lin(sd, f"{prefix}final_head.final_proj"),
                       "modulation": _get(sd, f"{prefix}final_head.modulation")},
    }


def _conv(sd, name):
    return {"w": _get(sd, f"{name}.weight"), "b": _get(sd, f"{name}.bias")}


def _vae_norm(sd, name, dim):
    return {"gamma": _get(sd, f"{name}.gamma").reshape(-1), "scale": float(np.sqrt(dim))}


def _vae_res(sd, name, cin, cout):
    p = {"norm1": _vae_norm(sd, f"{name}.residual.0", cin),
         "conv1": _conv(sd, f"{name}.residual.2"),
         "norm2": _vae_norm(sd, f"{name}.residual.3", cout),
         "conv2": _conv(sd, f"{name}.residual.6")}
    if f"{name}.shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{name}.shortcut")
    return p


def _vae_attn(sd, name, dim):
    return {"norm": _vae_norm(sd, f"{name}.norm", dim), "qkv": _conv(sd, f"{name}.to_qkv"),
            "proj": _conv(sd, f"{name}.proj")}


def convert_vae(sd: StateDict, cfg) -> dict:
    """Wan2.1_VAE state dict (keys `encoder.downsamples.N...`, without the
    "model." prefix the reference adds when loading) -> the port's VAE tree."""
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    enc = {"conv1": _conv(sd, "encoder.conv1"), "down": []}
    mi = 0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        c = cin
        for _ in range(cfg.num_res_blocks):
            enc["down"].append(_vae_res(sd, f"encoder.downsamples.{mi}", c, cout))
            c = cout
            mi += 1
        if i != len(cfg.dim_mult) - 1:
            rp = {"conv": _conv(sd, f"encoder.downsamples.{mi}.resample.1")}
            if cfg.temporal_downsample[i]:
                rp["time_conv"] = _conv(sd, f"encoder.downsamples.{mi}.time_conv")
            enc["down"].append(rp)
            mi += 1
    d = dims[-1]
    enc.update(mid1=_vae_res(sd, "encoder.middle.0", d, d),
               mid_attn=_vae_attn(sd, "encoder.middle.1", d),
               mid2=_vae_res(sd, "encoder.middle.2", d, d),
               head_norm=_vae_norm(sd, "encoder.head.0", d),
               head_conv=_conv(sd, "encoder.head.2"))

    ddims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    temporal_upsample = tuple(reversed(cfg.temporal_downsample))
    dec = {"conv1": _conv(sd, "decoder.conv1"),
           "mid1": _vae_res(sd, "decoder.middle.0", ddims[0], ddims[0]),
           "mid_attn": _vae_attn(sd, "decoder.middle.1", ddims[0]),
           "mid2": _vae_res(sd, "decoder.middle.2", ddims[0], ddims[0]),
           "up": []}
    mi = 0
    for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
        c = cin // 2 if i in (1, 2, 3) else cin
        for _ in range(cfg.num_res_blocks + 1):
            dec["up"].append(_vae_res(sd, f"decoder.upsamples.{mi}", c, cout))
            c = cout
            mi += 1
        if i != len(cfg.dim_mult) - 1:
            rp = {"conv": _conv(sd, f"decoder.upsamples.{mi}.resample.1")}
            if temporal_upsample[i]:
                rp["time_conv"] = _conv(sd, f"decoder.upsamples.{mi}.time_conv")
            dec["up"].append(rp)
            mi += 1
    dec.update(head_norm=_vae_norm(sd, "decoder.head.0", ddims[-1]),
               head_conv=_conv(sd, "decoder.head.2"))
    return {"encoder": enc, "decoder": dec, "conv1": _conv(sd, "conv1"),
            "conv2": _conv(sd, "conv2")}


def convert_t5(sd: StateDict, cfg) -> dict:
    """umT5-xxl encoder state dict -> the port's T5 tree."""
    def block(i):
        b = f"blocks.{i}"
        p = {
            "norm1": _rms(sd, f"{b}.norm1"),
            "attn": {n: _lin(sd, f"{b}.attn.{n}", bias=False) for n in ("q", "k", "v", "o")},
            "norm2": _rms(sd, f"{b}.norm2"),
            "ffn": {"gate": _lin(sd, f"{b}.ffn.gate.0", bias=False),
                    "fc1": _lin(sd, f"{b}.ffn.fc1", bias=False),
                    "fc2": _lin(sd, f"{b}.ffn.fc2", bias=False)},
        }
        if f"{b}.pos_embedding.embedding.weight" in sd:
            p["pos_emb"] = _get(sd, f"{b}.pos_embedding.embedding.weight")
        return p

    params = {"token_embedding": _get(sd, "token_embedding.weight"),
              "blocks": [block(i) for i in range(cfg.num_layers)],
              "norm": _rms(sd, "norm")}
    if "pos_embedding.embedding.weight" in sd:
        params["pos_emb"] = _get(sd, "pos_embedding.embedding.weight")
    return params


def convert_clip_visual(sd: StateDict, cfg, prefix: str = "visual.") -> dict:
    """open-clip XLM-RoBERTa ViT-H/14 state dict -> the port's CLIP tree."""
    pe = _get(sd, f"{prefix}patch_embedding.weight")  # [O, 3, p, p]

    def block(i):
        b = f"{prefix}transformer.{i}"
        return {"norm1": _ln(sd, f"{b}.norm1"),
                "attn": {"qkv": _lin(sd, f"{b}.attn.to_qkv"), "proj": _lin(sd, f"{b}.attn.proj")},
                "norm2": _ln(sd, f"{b}.norm2"),
                "mlp": {"fc1": _lin(sd, f"{b}.mlp.0"), "fc2": _lin(sd, f"{b}.mlp.2")}}

    return {"patch_embedding": {"w": pe.reshape(pe.shape[0], -1)},
            "cls_embedding": _get(sd, f"{prefix}cls_embedding"),
            "pos_embedding": _get(sd, f"{prefix}pos_embedding"),
            "pre_norm": _ln(sd, f"{prefix}pre_norm"),
            "blocks": [block(i) for i in range(cfg.vision_layers)]}


def _weight_norm(g, v) -> torch.Tensor:
    """torch weight_norm's weight g * v / ||v|| over (out, in) per kernel
    tap, in numpy fp32 as the JAX package computes it."""
    g, v = (torch.as_tensor(x).float().numpy() for x in (g, v))
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def convert_wav2vec2(sd: StateDict, cfg) -> dict:
    """HF `Wav2Vec2Model` state dict -> the port's wav2vec2 tree."""
    convs = []
    for i in range(len(cfg.conv_dims)):
        base = f"feature_extractor.conv_layers.{i}"
        p = {"w": _get(sd, f"{base}.conv.weight")}
        if f"{base}.layer_norm.weight" in sd:
            p["gn"] = _ln(sd, f"{base}.layer_norm")
        convs.append(p)

    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        pos_w = _weight_norm(sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"])
    elif f"{pc}.parametrizations.weight.original0" in sd:
        pos_w = _weight_norm(sd[f"{pc}.parametrizations.weight.original0"],
                             sd[f"{pc}.parametrizations.weight.original1"])
    else:
        pos_w = _get(sd, f"{pc}.weight")

    def block(i):
        b = f"encoder.layers.{i}"
        return {"attn": {"q": _lin(sd, f"{b}.attention.q_proj"),
                         "k": _lin(sd, f"{b}.attention.k_proj"),
                         "v": _lin(sd, f"{b}.attention.v_proj"),
                         "o": _lin(sd, f"{b}.attention.out_proj")},
                "norm1": _ln(sd, f"{b}.layer_norm"),
                "ffn": {"fc1": _lin(sd, f"{b}.feed_forward.intermediate_dense"),
                        "fc2": _lin(sd, f"{b}.feed_forward.output_dense")},
                "norm2": _ln(sd, f"{b}.final_layer_norm")}

    return {"conv_layers": convs,
            "feature_projection": {"norm": _ln(sd, "feature_projection.layer_norm"),
                                   "proj": _lin(sd, "feature_projection.projection")},
            "pos_conv": {"w": pos_w, "b": _get(sd, f"{pc}.bias")},
            "encoder_norm": _ln(sd, "encoder.layer_norm"),
            "blocks": [block(i) for i in range(cfg.num_layers)]}


def merge_pt_override(params, sd: StateDict, cfg) -> dict:
    """Overlay a fine-tuned `.pt` state dict onto a DiT tree, keeping the
    base leaf wherever the override's size differs (the reference's
    non-strict merge).  Returns the merged tree; reports the skipped keys."""
    override = convert_dit(sd, cfg)
    skipped = []

    def merge(node, new, path):
        if isinstance(node, dict):
            return {k: merge(v, new[k], f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [merge(v, n, f"{path}/{i}") for i, (v, n) in enumerate(zip(node, new))]
        if tuple(node.shape) != tuple(new.shape):
            skipped.append(path.lstrip("/"))
            return node
        return new

    merged = merge(params, override, "")
    if skipped:
        print(f"merge_pt_override: skipped {len(skipped)} size-mismatched tensors: "
              f"{', '.join(skipped[:8])}")
    return merged


# ---------------------------------------------------------------------------
# the port's own checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, tree) -> None:
    """Write a parameter (or optimizer) tree to the directory `path`, every
    tensor moved to the host."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "tree.pt.tmp")
    torch.save(tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x, tree), tmp)
    os.replace(tmp, os.path.join(path, "tree.pt"))


def restore_checkpoint(path: str, template=None):
    """The tree saved at `path`.  With a `template` tree, each leaf is
    restored onto the template leaf's device and dtype (shapes must match)."""
    tree = torch.load(os.path.join(path, "tree.pt"), map_location="cpu", weights_only=True)
    if template is None:
        return tree

    def put(t, x):
        if not torch.is_tensor(t):
            return x
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(x.shape)} does not fit the "
                             f"template's {tuple(t.shape)}")
        return x.to(device=t.device, dtype=t.dtype)

    return tree_map(put, template, tree)


# ---------------------------------------------------------------------------
# export: the port's DiT -> the Wan torch layout (the inverse of convert_dit)
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return x.detach().to(device="cpu", dtype=torch.float32).contiguous()


def _ex_lin(sd, name, p):
    sd[f"{name}.weight"] = _f32(p["w"])
    if "b" in p:
        sd[f"{name}.bias"] = _f32(p["b"])


def _ex_ln(sd, name, p):
    sd[f"{name}.weight"] = _f32(p["w"])
    sd[f"{name}.bias"] = _f32(p["b"])


def export_vocal_projector(params, cfg, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    pp = params["proj"]
    if "fc" in pp:
        _ex_lin(sd, f"{prefix}proj_model.proj", pp["fc"])
        _ex_ln(sd, f"{prefix}proj_model.norm", pp["norm"])
    else:
        _ex_lin(sd, f"{prefix}proj_model.proj_1", pp["fc1"])
        _ex_ln(sd, f"{prefix}proj_model.norm_1", pp["norm1"])
        _ex_lin(sd, f"{prefix}proj_model.proj_2", pp["fc2"])
        _ex_ln(sd, f"{prefix}proj_model.norm_2", pp["norm"])
    for i, bp in enumerate(params["blocks"]):
        b = f"{prefix}blocks.{i}"
        _ex_ln(sd, f"{b}.norm3", bp["norm3"])
        ca = bp["cross_attn"]
        for n in ("q", "k", "v", "o"):
            _ex_lin(sd, f"{b}.cross_attn.{n}", ca[n])
        sd[f"{b}.cross_attn.norm_q.weight"] = _f32(ca["norm_q"]["w"])
        sd[f"{b}.cross_attn.norm_k.weight"] = _f32(ca["norm_k"]["w"])
        _ex_lin(sd, f"{b}.ffn.0", bp["ffn"]["fc1"])
        _ex_lin(sd, f"{b}.ffn.2", bp["ffn"]["fc2"])
        sd[f"{b}.modulation"] = _f32(bp["modulation"])
    _ex_lin(sd, f"{prefix}final_head.final_proj", params["final_head"]["final_proj"])
    sd[f"{prefix}final_head.modulation"] = _f32(params["final_head"]["modulation"])
    return sd


def export_dit_to_torch_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """The port's DiT tree (unprepared: int8 leaves must be dequantised
    first) -> the Wan torch key layout, fp32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}
    pt, ph, pw = cfg.patch_size
    pe = _f32(params["patch_embedding"]["w"])  # [O, I * k]
    sd["patch_embedding.weight"] = pe.reshape(pe.shape[0], cfg.in_dim, pt, ph, pw)
    sd["patch_embedding.bias"] = _f32(params["patch_embedding"]["b"])
    _ex_lin(sd, "text_embedding.0", params["text_embedding"]["fc1"])
    _ex_lin(sd, "text_embedding.2", params["text_embedding"]["fc2"])
    _ex_lin(sd, "time_embedding.0", params["time_embedding"]["fc1"])
    _ex_lin(sd, "time_embedding.2", params["time_embedding"]["fc2"])
    _ex_lin(sd, "time_projection.1", params["time_projection"]["fc"])
    _ex_ln(sd, "img_emb.proj.0", params["img_emb"]["norm1"])
    _ex_lin(sd, "img_emb.proj.1", params["img_emb"]["fc1"])
    _ex_lin(sd, "img_emb.proj.3", params["img_emb"]["fc2"])
    _ex_ln(sd, "img_emb.proj.4", params["img_emb"]["norm2"])
    for i, bp in enumerate(params["blocks"]):
        b = f"blocks.{i}"
        sa, ca = bp["self_attn"], bp["cross_attn"]
        for n in ("q", "k", "v", "o"):
            _ex_lin(sd, f"{b}.self_attn.{n}", sa[n])
        sd[f"{b}.self_attn.norm_q.weight"] = _f32(sa["norm_q"]["w"])
        sd[f"{b}.self_attn.norm_k.weight"] = _f32(sa["norm_k"]["w"])
        _ex_ln(sd, f"{b}.norm3", bp["norm3"])
        for n in ("q", "k", "v", "o", "k_img", "v_img", "k_vocal", "v_vocal"):
            _ex_lin(sd, f"{b}.cross_attn.{n}", ca[n])
        for n in ("norm_q", "norm_k", "norm_k_img"):
            sd[f"{b}.cross_attn.{n}.weight"] = _f32(ca[n]["w"])
        _ex_lin(sd, f"{b}.ffn.0", bp["ffn"]["fc1"])
        _ex_lin(sd, f"{b}.ffn.2", bp["ffn"]["fc2"])
        sd[f"{b}.modulation"] = _f32(bp["modulation"])
    _ex_lin(sd, "head.head", params["head"]["head"])
    sd["head.modulation"] = _f32(params["head"]["modulation"])
    sd.update(export_vocal_projector(params["vocal_projector"], cfg, prefix="vocal_projector."))
    return sd


def save_torch_dit(path: str, params, cfg) -> str:
    """Write the exported state dict as `.safetensors` or as a `.pt`
    (torch.save); returns the path."""
    sd = export_dit_to_torch_state_dict(params, cfg)
    if path.endswith(".safetensors"):
        save_safetensors(sd, path)
    else:
        torch.save(sd, path)
    return path
