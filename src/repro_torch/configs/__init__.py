"""Architecture registry: one module per assigned architecture
(``--arch <id>`` in the launchers).

Port note: a copy of ``repro.configs`` (data only), importing the port's
own ``ModelConfig``."""

from importlib import import_module
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-8b": "granite_8b",
    "qwen3-1.7b": "qwen3_1p7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-76b": "internvl2_76b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
