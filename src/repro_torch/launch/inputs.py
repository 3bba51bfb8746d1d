"""Training and serving inputs per (arch x input shape) (the port of
``repro.launch.inputs``, concrete batches and abstract specs; the
reference's mesh partition specs wait for the multi-card port).

Modality stubs, as in the reference:

* audio (whisper): ``frames`` = precomputed mel / conv frame embeddings
  (B, seq, d_model); decoder tokens are capped at 448 positions.
* vlm (internvl2): ``prefix_embed`` = ViT patch embeddings
  (B, num_prefix_tokens, d_model); text fills the rest of seq_len.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.base import ShapeDtype

WHISPER_MAX_DECODER = 448


def train_batch_shapes(cfg: ModelConfig, shape: InputShape, num_workers: int):
    """``{field: (shape, kind)}`` of one (W, B_loc, ...) training batch;
    kind is ``"tok"`` (int token ids) or ``"act"`` (float embeddings)."""
    W = max(num_workers, 1)
    assert shape.global_batch % W == 0, (shape.global_batch, W)
    B = shape.global_batch // W
    S = shape.seq_len
    out = {}
    if cfg.family == "audio":
        Sd = min(WHISPER_MAX_DECODER, S)
        out["frames"] = ((W, B, S, cfg.d_model), "act")
        out["tokens"] = ((W, B, Sd), "tok")
        out["labels"] = ((W, B, Sd), "tok")
    elif cfg.family == "vlm":
        Np = cfg.num_prefix_tokens
        out["prefix_embed"] = ((W, B, Np, cfg.d_model), "act")
        out["tokens"] = ((W, B, S - Np), "tok")
        out["labels"] = ((W, B, S - Np), "tok")
    else:
        out["tokens"] = ((W, B, S), "tok")
        out["labels"] = ((W, B, S), "tok")
    return out


def make_train_batch(cfg: ModelConfig, shape: InputShape, num_workers: int,
                     *, seed=0, act_dtype=torch.float32, device=None):
    """A random (W, B_loc, ...) batch: the reference's draws (one
    ``numpy.random.default_rng(seed)``, the fields in the same order,
    token ids uniform over the vocabulary, embeddings standard normal), as
    tensors on ``device`` (int32 token ids, ``act_dtype`` embeddings)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, kind) in train_batch_shapes(cfg, shape, num_workers).items():
        if kind == "tok":
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, size=s).astype(np.int32)).to(device)
        else:
            out[k] = torch.from_numpy(rng.normal(size=s)).to(device, act_dtype)
    return out


def serve_token_specs(cfg: ModelConfig, shape: InputShape, *, prefill: bool):
    """Abstract serving inputs (:class:`~repro_torch.models.base.ShapeDtype`):
    a prefill's prompt (with its frames or prefix embeddings, bfloat16 as
    in the reference) or a decode step's (B, 1) tokens."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda *s: ShapeDtype(s, torch.int32)
    act = lambda *s: ShapeDtype(s, torch.bfloat16)
    if not prefill:
        return {"tokens": tok(B, 1)}
    if cfg.family == "audio":
        return {"frames": act(B, S, cfg.d_model),
                "tokens": tok(B, min(WHISPER_MAX_DECODER, S))}
    if cfg.family == "vlm":
        Np = cfg.num_prefix_tokens
        return {"prefix_embed": act(B, Np, cfg.d_model), "tokens": tok(B, S - Np)}
    return {"tokens": tok(B, S)}
