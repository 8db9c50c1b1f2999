"""A cell at a size the CPU holds: the port's tiny debug configurations
through the benchmark's own files and code."""

from __future__ import annotations

import dataclasses

from avatar_bench import core


def as_dict(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def tiny_config(dtypes=("bfloat16", "bfloat16", "bfloat16", "float32")) -> dict:
    from stableavatar_tpu_torch.config import tiny_debug_configs

    dit, vae, _, clip, w2v = tiny_debug_configs()
    return {"dit": as_dict(dit), "vae": as_dict(vae), "clip": as_dict(clip),
            "wav2vec": as_dict(w2v),
            "dtypes": dict(zip(("dit", "vae", "clip", "wav2vec"), dtypes))}


def tiny_cell(name="gen-1.3b-euler") -> core.Cell:
    """The named cell's traffic and limits on the tiny models at 32 x 32."""
    cell = core.load_cell(name)
    traffic = dict(cell.traffic, image_size=[32, 32], prompt_tokens=5, negative_tokens=7)
    return dataclasses.replace(cell, config=tiny_config(), traffic=traffic)
