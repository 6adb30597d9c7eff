"""Architecture registry: ``--arch <id>`` -> ModelConfig.

A copy of ``repro/configs/registry.py``: it knows every arch id of the JAX
package, so ``--arch`` takes the same choices. Only ``yi-6b`` (the llama
family: attention and SwiGLU) builds a model in the port;
``repro_torch.models.build_model`` refuses the others, naming the ROADMAP
item that holds them."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

# assigned-architecture id -> module under repro_torch.configs
_ARCH_MODULES = {
    "grok-1-314b":          "grok_1_314b",
    "internvl2-2b":         "internvl2_2b",
    "rwkv6-7b":             "rwkv6_7b",
    "command-r-plus-104b":  "command_r_plus_104b",
    "whisper-tiny":         "whisper_tiny",
    "minitron-4b":          "minitron_4b",
    "yi-6b":                "yi_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "kimi-k2-1t-a32b":      "kimi_k2_1t_a32b",
    "granite-34b":          "granite_34b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    arch = arch.strip()
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {list(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
