"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (AttnCfg, FTCfg, ModelConfig, MoECfg, SSMCfg,
                                reduced)
from repro_torch.configs.shapes import SHAPES, ShapeCfg, cell_applicable

_MODULES = {
    # assigned pool (10)
    "arctic-480b": "arctic_480b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-12b": "stablelm_12b",
    "gemma3-1b": "gemma3_1b",
    "rwkv6-7b": "rwkv6_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-base": "whisper_base",
    # paper's own models (Table 3)
    "gpt2": "gpt2",
    "bert-base": "bert_base",
    "bert-large": "bert_large",
    "t5-small": "t5_small",
}

ASSIGNED_ARCHS = list(_MODULES)[:10]
PAPER_ARCHS = list(_MODULES)[10:]


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_MODULES)
