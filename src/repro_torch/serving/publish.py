"""Trainer -> server weight channel: versioned bucket snapshots (the port of
``repro.serving.publish``).

:class:`WeightPublisher` is the trainer's side: at a checkpoint the
resident training state holds the parameters as worker-stacked ``(W,
rows, 128)`` buckets (``BucketState`` with ``leading=1``); it reduces them
to one copy bucket by bucket (a float32 mean over the worker axis: the
consensus after a global sync, the safe average between syncs) and
snapshots them through :func:`repro_torch.checkpoint.checkpoint.publish_flat`
(``weights_v{n}.npz`` and an atomically advanced ``manifest.json``).  No
per-leaf view is built on the way.

:class:`WeightSubscriber` is the server's side: it polls the manifest and
restores a new version into a ``BucketState`` of
:func:`repro_torch.core.flatbuf.abstract_buckets` templates — buckets in,
buckets out; the engine's ``install_weights`` does the one ``unpack()``.
The files are the reference's, so either package can publish to the
other.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.core import flatbuf
from repro_torch.models import base as mbase
from repro_torch.utils import tree_leaves


def consensus_buckets(state: flatbuf.BucketState) -> flatbuf.BucketState:
    """Reduce a worker-stacked (``leading=1``) state to one copy, bucket by
    bucket (float32 mean, cast back).  Identity on single-copy states."""
    if state.leading == 0:
        return state
    if state.leading != 1:
        raise ValueError(f"expected worker-stacked leading=1 state, "
                         f"got leading={state.leading}")
    return state.with_buckets(
        [b.float().mean(0).to(b.dtype) for b in state.buckets], leading=0)


class WeightPublisher:
    """Versioned weight publishing for the serving hot-swap channel."""

    def __init__(self, dir: str):
        self.dir = dir
        self.last_version: int | None = None

    def publish(self, weights, *, step: int | None = None) -> int:
        """Publish ``weights`` (a param tree, or a resident ``BucketState``,
        worker-stacked or single-copy) as the next version; returns the
        version number."""
        if flatbuf.is_bucket_state(weights):
            weights = consensus_buckets(weights)
        else:       # enter bucket form so every snapshot has one layout
            weights = flatbuf.BucketState.pack(weights)
        version, _ = checkpoint.publish_flat(self.dir, weights, step=step)
        self.last_version = version
        return version


class WeightSubscriber:
    """Server-side poller: manifest -> ``BucketState`` buffers on ``device``.

    ``template`` fixes the expected bucket layout: a param tree, a
    ``ParamSpec`` tree (``lm.param_specs``, taken at float32), or a
    ``FlatLayout``.
    """

    def __init__(self, dir: str, template, *, device=None):
        self.dir = dir
        self.device = device
        if isinstance(template, flatbuf.FlatLayout):
            layout = template
        else:
            if any(mbase.is_spec(x) for x in
                   tree_leaves(template, is_leaf=mbase.is_spec)):
                template = mbase.abstract(template, torch.float32)
            layout = flatbuf.build_layout(template)
        self._template = flatbuf.BucketState(
            layout=layout, buckets=tuple(flatbuf.abstract_buckets(layout)),
            leading=0)

    def latest_version(self) -> int | None:
        got = checkpoint.latest_flat(self.dir)
        return None if got is None else got[0]

    def poll(self, *, newer_than: int = -1):
        """``(version, BucketState)`` of the latest published version if it
        is ``> newer_than``, else None."""
        got = checkpoint.latest_flat(self.dir)
        if got is None or got[0] <= newer_than:
            return None
        version, path = got
        return version, checkpoint.restore_flat(path, self._template,
                                                device=self.device)
