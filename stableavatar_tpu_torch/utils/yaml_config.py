"""YAML config loader honoring the reference key names (port of
`stableavatar_tpu/utils/yaml_config.py`, held equal by tests/test_torch_data.py).

Consumes the reference's OmegaConf YAML schema
(`deepspeed_config/wan2.1/wan_civitai.yaml`) — transformer/vae/text-encoder/
scheduler kwargs with the `dict_mapping` rename table — and produces our
typed dataclass configs.  Also accepts the misspelled
`spacial_compression_ratio` alongside the YAML's `spatial_compression_ratio`
(the reference silently drops the correctly-spelled key through
`filter_kwargs`, SURVEY.md §2.4 gotchas; we accept both).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from stableavatar_tpu_torch.config import (
    DiTConfig,
    SchedulerConfig,
    T5Config,
    VAEConfig,
    WAN_1_3B,
)


def _load_yaml(path: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError("pyyaml is required for YAML configs") from e
    with open(path) as f:
        return yaml.safe_load(f)


def _filtered(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


def load_config(path: str) -> Dict[str, Any]:
    """Returns dict with keys: dit (DiTConfig), vae (VAEConfig),
    t5 (T5Config), scheduler (SchedulerConfig), raw (the YAML dict)."""
    raw = _load_yaml(path) or {}

    tk = dict(raw.get("transformer_additional_kwargs") or {})
    tk.pop("transformer_subpath", None)
    tk.pop("dict_mapping", None)  # renames apply to checkpoint config.json keys
    dit = dataclasses.replace(WAN_1_3B, **_filtered(DiTConfig, tk))

    vk = dict(raw.get("vae_kwargs") or {})
    vk.pop("vae_subpath", None)
    if "spatial_compression_ratio" in vk:
        vk.setdefault("spacial_compression_ratio", vk["spatial_compression_ratio"])
    vk.pop("spacial_compression_ratio", None)
    vae = dataclasses.replace(VAEConfig(), **_filtered(VAEConfig, vk))

    tek = dict(raw.get("text_encoder_kwargs") or {})
    tek.pop("text_encoder_subpath", None)
    tek.pop("tokenizer_subpath", None)
    if "text_length" in tek:
        tek["text_len"] = tek.pop("text_length")
    t5 = dataclasses.replace(T5Config(), **_filtered(T5Config, tek))

    sk = dict(raw.get("scheduler_kwargs") or {})
    sk.pop("scheduler_subpath", None)
    sched = dataclasses.replace(SchedulerConfig(), **_filtered(SchedulerConfig, sk))

    return {"dit": dit, "vae": vae, "t5": t5, "scheduler": sched, "raw": raw}
