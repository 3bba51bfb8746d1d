"""Serving: continuous batching over a paged KV cache, with live weight
hot-swap from the trainer (the port of ``repro.serving``).

* :mod:`repro_torch.serving.paged` — fixed-size KV pages as flatbuf
  bucket rows, per-sequence page tables, the all-zero null page.
* :mod:`repro_torch.serving.engine` — :class:`DecodeEngine`: admission
  queue, slots, interleaved prefill / decode, retirement, greedy
  sampling, live weight install.
* :mod:`repro_torch.serving.publish` — versioned weight publishing by the
  trainer and subscription by the server (the manifest protocol).

Build an engine from a config with :func:`repro_torch.launch.steps.build_engine`.
"""
from repro_torch.serving.engine import DecodeEngine, Request, Result
from repro_torch.serving.paged import (NULL_PAGE, PageLayout, build_page_layout,
                                       gather, init_pool, paged_decode_step,
                                       scatter_prefill, scatter_token)
from repro_torch.serving.publish import (WeightPublisher, WeightSubscriber,
                                         consensus_buckets)

__all__ = [
    "DecodeEngine", "Request", "Result",
    "PageLayout", "build_page_layout", "init_pool", "gather",
    "scatter_token", "scatter_prefill", "paged_decode_step", "NULL_PAGE",
    "WeightPublisher", "WeightSubscriber", "consensus_buckets",
]
