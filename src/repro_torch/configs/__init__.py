"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

The families ported so far: the dense ``paper-lm``, the MoE
``olmoe-1b-7b`` and the MLA + MoE ``deepseek-v2-lite-16b``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (BlockDef, ControllerConfig, InputShape,
                                      LocalSGDConfig, MLAConfig, ModelConfig,
                                      MoEConfig, OptimConfig, RunConfig)

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "paper-lm": "paper_lm",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke()
