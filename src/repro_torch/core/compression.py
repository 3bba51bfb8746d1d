"""Sync-payload compression on flat-bus buckets (paper Alg. 3 / Alg. 4):
the port of the bucket compressors of ``repro.core.compression``.

The compressed quantity is the model difference accumulated over H
local steps; workers exchange sign(Delta) with one L1 scale per leaf
(signSGD), optionally with an error-feedback memory (EF-signSGD).
"""
from __future__ import annotations

import math

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops


def sign_compress_bucket(layout, b: int, x, *, leading: int = 0):
    """sign(x) * mean|x| per leaf segment of bucket ``b``, straight on a
    ``(*lead, rows, 128)`` buffer; returns f32 of x's shape.

    With ``leading=1`` the per-leaf scale averages |x| over ALL workers
    (the reference tiles the row map W times and divides by size * W),
    so one scale per leaf is shared by every worker.  Padding compresses
    to sign(0) * scale = 0.
    """
    seg = flatbuf.const("row_segments", layout, b, x.device)
    sizes = flatbuf.const("segment_sizes", layout, b, x.device)
    W = math.prod(x.shape[:leading])
    y, _ = kops.bucket_sign_compress(x.float().contiguous(), seg, sizes * W)
    return y


def ef_compress_bucket(layout, b: int, d, e, *, leading: int = 0):
    """EF compression of one bucket: returns (compressed, new_memory,
    input) with input = d + e and new_memory = input - compressed."""
    inp = d.float() + e.float()
    out = sign_compress_bucket(layout, b, inp, leading=leading)
    return out, inp - out, inp


def compress_stage(layout, stage, d, e=None, *, leading: int = 0):
    """Apply a pack stage's declared mode to its bucket's delta ``d``
    (``e`` is the EF memory for ``ef_sign``).  Returns (compressed,
    new_memory, input) uniformly; for ``none`` that is (d, e, d)."""
    assert stage.kind == "pack" and len(stage.buckets) == 1, stage
    b = stage.buckets[0]
    mode = stage.compression
    if mode == "none":
        return d, e, d
    if mode == "sign":
        return sign_compress_bucket(layout, b, d, leading=leading), e, d
    if mode == "ef_sign":
        return ef_compress_bucket(layout, b, d, e, leading=leading)
    raise ValueError(f"unknown stage compression {mode!r}")
