"""Shared set-up of the benchmark's tests: the repository root and the
port's sources on the path, and a cell's files cut to a size the CPU
runs in seconds."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from lsgd_bench import run as R  # noqa: E402

CELLS = tuple(w["name"] for w in
              json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
SMALL = dict(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
             num_key_value_heads=4, head_dim=32, vocab_size=512)
SMALL_FFN = {"qwen3-32b.l2.v8": dict(intermediate_size=256,
                                     num_key_value_heads=2)}
# the MoE kind (``reference/moe.py``), which no cell runs yet: OLMoE's
# layer as the port computes it (the chosen weights renormalised,
# capacity-routed), at a CPU size
MOE = {"name": "moe-small", "source": "OLMoE-1B-7B's layer kinds at a CPU size",
       "layer_pattern": [["attn", "moe"]], "hidden_act": "silu",
       "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
       "tie_word_embeddings": False, "qk_norm": True, "param_dtype": "float32",
       "num_experts": 64, "num_experts_per_tok": 8, "norm_topk_prob": True,
       "router_aux_loss_coef": 0.01, "capacity_factor": 1.25,
       "intermediate_size": 1024, "hidden_size": 2048,
       "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 128,
       "num_hidden_layers": 2, "vocab_size": 50304}
SMALL_FFN["moe-small"] = dict(intermediate_size=64, num_experts=8,
                              num_experts_per_tok=2)


def small(cfg: dict, traffic: dict):
    """A configuration and traffic mix cut to a CPU size: the same kinds,
    schedule, optimizer and sync."""
    cfg.update(SMALL, **SMALL_FFN[cfg["name"]])
    traffic.update(workers=2, local_batch=2, seq_len=64)
    traffic["data"]["pool_steps"] = 4
    return cfg, traffic


def small_files(cell: str) -> dict:
    """The cell's files cut to a CPU size, with the cell's limits."""
    files = R.cell_files(R.load_json(ROOT / "BENCHMARK.json"), cell)
    small(files["config"], files["traffic"])
    return files


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return "cuda"
