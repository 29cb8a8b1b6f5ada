"""Architecture registry: ``--arch <id>`` lookup for every assigned config.

A copy of ``repro.configs``: the same ten architectures, the same
variant and input shapes, as data. Which families the port can build a
model from is decided in ``repro_torch.models.params``; the rest raise
there, not here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25_14b
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_15b
from repro_torch.configs.jamba_1_5_large import CONFIG as _jamba
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32, CONFIG_SWA as _llama32_swa
from repro_torch.configs.phi3_5_moe import CONFIG as _phi35
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.shapes import SHAPES, InputShape

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _qwen25_14b,
        _llava,
        _whisper,
        _qwen2_15b,
        _jamba,
        _mixtral,
        _glm4,
        _llama32,
        _phi35,
        _mamba2,
    ]
}

# beyond-assignment variants (selectable but not part of the 10x4 matrix)
VARIANTS: Dict[str, ModelConfig] = {_llama32_swa.name: _llama32_swa}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in VARIANTS:
        return VARIANTS[name]
    raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS) + sorted(VARIANTS)}")


__all__ = ["ARCHS", "VARIANTS", "SHAPES", "InputShape", "get_config"]
