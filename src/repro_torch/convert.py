"""Carry weights and optimizer state over from the JAX package.

The reference's param pytree, converted to numpy arrays (for example
``jax.tree.map(np.asarray, params)``), becomes the port's param tree with
the same nesting; a resident ``LocalSGDState`` of the reference whose
bucket buffers are numpy arrays becomes the port's resident state.  The
bucket layouts agree row for row (``core/flatbuf``), so buffers move
as they are.  Nothing here imports JAX: the inputs are numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import flatbuf
from repro_torch.core.local_sgd import LocalSGDState


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_reference(np_tree, device):
    """Nested dict/tuple/list of numpy arrays -> the same nesting of
    tensors on ``device``."""
    if isinstance(np_tree, dict):
        return {k: params_from_reference(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (tuple, list)):
        return type(np_tree)(params_from_reference(v, device) for v in np_tree)
    if np_tree is None:
        return None
    return _tensor(np_tree, device)


def state_from_reference(ref_state, *, layout: flatbuf.FlatLayout, device,
                         ) -> LocalSGDState:
    """A resident ``LocalSGDState`` of the reference (fields ``params``,
    ``momentum``, ``anchor``, ``global_u``, ``ef_memory`` with numpy
    ``.buckets``, and ``step``) -> the port's state on ``device``.

    ``layout`` is the port's layout for the same model (e.g.
    ``TrainBundle.layout``); every buffer must have its bucket rows.
    """
    def conv(field, leading):
        if field is None:
            return None
        bufs = tuple(_tensor(b, device) for b in field.buckets)
        for b, buf in enumerate(bufs):
            want = layout.bucket_rows[b]
            if buf.shape[leading:] != (want, flatbuf.LANE):
                raise ValueError(f"bucket {b}: shape {tuple(buf.shape)} does "
                                 f"not match the layout's ({want}, 128)")
        return flatbuf.BucketState(layout, bufs, leading=leading)

    return LocalSGDState(params=conv(ref_state.params, 1),
                         momentum=conv(ref_state.momentum, 1),
                         anchor=conv(ref_state.anchor, 0),
                         global_u=conv(ref_state.global_u, 0),
                         ef_memory=conv(ref_state.ef_memory, 1),
                         step=int(np.asarray(ref_state.step)))
