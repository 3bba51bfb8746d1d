"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Only ``paper-lm`` is registered in this slice."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (BlockDef, ControllerConfig, InputShape,
                                      LocalSGDConfig, ModelConfig,
                                      OptimConfig, RunConfig)

_MODULES = {"paper-lm": "paper_lm"}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke()
