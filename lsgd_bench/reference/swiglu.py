"""The gated SiLU feed-forward: silu(x Wg) * (x Wu), then Wd."""
from __future__ import annotations

import torch.nn.functional as F


def shapes(cfg) -> dict:
    E, Fd = cfg["hidden_size"], cfg["intermediate_size"]
    return {"wg": (E, Fd), "wu": (E, Fd), "wd": (Fd, E)}


def apply(cfg, p, x, positions):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"], 0.0
