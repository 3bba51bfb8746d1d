"""Worker-axis resize of one stacked array (the port of
``repro.core.elastic.resize_axis`` with ``fold="slice"``, the fold of
the checkpoint restore; resizing a live run comes with workers across
GPUs).

The worker axis is the leading dim of every stacked buffer: ``(W,) +
shape`` on a tree, ``(W, rows, 128)`` for a resident bucket.
"""
from __future__ import annotations

import torch


def resize_axis(x: torch.Tensor, new_w: int) -> torch.Tensor:
    """Resize the leading (worker) axis of ``x`` to ``new_w``: shrink
    (``W % new_w == 0``) keeps the first ``new_w`` workers bit for bit,
    grow (``new_w % W == 0``) repeats each worker ``new_w // W`` times."""
    w = int(x.shape[0])
    if new_w == w:
        return x
    if new_w < w:
        if w % new_w:
            raise ValueError(
                f"cannot shrink worker axis {w} -> {new_w}: not divisible")
        return x[:new_w]
    if new_w % w:
        raise ValueError(
            f"cannot grow worker axis {w} -> {new_w}: not divisible")
    return torch.repeat_interleave(x, new_w // w, dim=0)
