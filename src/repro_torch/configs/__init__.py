"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``
/ ``ARCHS`` / ``runnable_pairs()``.

The families ported so far: the dense decoders ``paper-lm``, qwen3-32b,
phi4-mini-3.8b, minitron-4b and gemma3-1b (sliding-window attention,
GeGLU, post-norm), the MoE ``olmoe-1b-7b``, the MLA + MoE
``deepseek-v2-lite-16b``, the recurrent ``xlstm-1.3b`` (mLSTM +
sLSTM) and ``zamba2-7b`` (mamba2 + a shared attention block), the
encoder-decoder ``whisper-small`` (a non-causal encoder over stubbed
frame embeddings, cross-attention in every decoder layer) and the VLM
``internvl2-76b`` (stubbed patch embeddings projected into a prefix):
every model the reference's registry holds."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, BlockDef, ControllerConfig,
                                      InputShape, LocalSGDConfig, MLAConfig,
                                      ModelConfig, MoEConfig, OptimConfig,
                                      RunConfig, SSMConfig)

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "gemma3-1b": "gemma3_1b",
    "internvl2-76b": "internvl2_76b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "whisper-small": "whisper_small",
    "zamba2-7b": "zamba2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "phi4-mini-3.8b": "phi4_mini",
    "minitron-4b": "minitron_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "paper-lm": "paper_lm",
}

ARCHS = tuple(k for k in _MODULES if k != "paper-lm")


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke()


# (arch, shape) pairs left out of the arch x shape matrix, with the
# reference's reasons
SKIPS: dict[tuple[str, str], str] = {
    ("qwen3-32b", "long_500k"): "pure full attention (no sub-quadratic variant)",
    ("internvl2-76b", "long_500k"): "pure full attention",
    ("deepseek-v2-lite-16b", "long_500k"): "MLA is full attention over cache",
    ("whisper-small", "long_500k"): "enc-dec full attention; 500k decoder "
                                    "positions unsupported by family",
    ("phi4-mini-3.8b", "long_500k"): "pure full attention",
    ("minitron-4b", "long_500k"): "pure full attention",
    ("olmoe-1b-7b", "long_500k"): "pure full attention",
}


def runnable_pairs():
    """Every (arch, shape name) pair of the matrix, skips removed."""
    return [(a, s) for a in ARCHS for s in INPUT_SHAPES if (a, s) not in SKIPS]
