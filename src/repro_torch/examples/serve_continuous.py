"""Continuous batching + live weight hot-swap on the paged KV cache (the
twin of the reference's ``examples/serve_continuous.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous --arch gemma3-1b
    PYTHONPATH=src python -m repro_torch.examples.serve_continuous --device cpu

The static wave of ``serve_lm`` holds every decode slot until the last
sequence of the batch finishes.  Here the same model serves a mixed
workload through ``serving.engine.DecodeEngine``
(``launch.steps.build_engine``): short requests retire early, their slots
and KV pages go back to the pool, and queued work is admitted between
decode steps.  Mid-run a trainer's snapshot is published
(``serving.publish.WeightPublisher``, versioned flat buckets) and the
engine installs it without stopping (``poll_weights``): the resident
sequences continue on the new version.  Runs on the card unless
``--device`` says otherwise; both weight versions come from the specs
through ``torch.Generator``s seeded with 0 and 1 on that device
(``params0`` / ``params1``, numpy trees such as the reference's
``PRNGKey(0)`` / ``PRNGKey(1)`` draws, replace them).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import build_engine
from repro_torch.models import base as mbase
from repro_torch.models import lm
from repro_torch.serving.publish import WeightPublisher, WeightSubscriber
from repro_torch.utils import resolve_device


def _weights(cfg, given, seed: int, dev, log):
    if given is not None:
        return params_from_reference(given, dev)
    log(f"weights v{seed}: {cfg.name}'s specs drawn from "
        f"torch.Generator(seed {seed}) on {dev}")
    return mbase.materialize(lm.param_specs(cfg),
                             torch.Generator(device=dev).manual_seed(seed), dev)


def main(argv=None, *, params0=None, params1=None, log=print) -> dict:
    """Serve the workload with a hot-swap halfway; returns every completed
    request (uid, tokens, finish reason, weight versions), the residents
    at the swap, the counts and the device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke(args.arch)
    shape = InputShape("serve", args.max_len, args.batch, "decode")
    eng = build_engine(cfg, shape, _weights(cfg, params0, 0, dev, log),
                       page_size=8, prefill_len=8, device=dev)
    log(f"engine: {eng.describe()}")

    # mixed workload: one long generation per wave of shorts
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(3, 7)))
        eng.submit(prompt, max_new=24 if i % args.batch == 0 else 3)

    # a second "trained" snapshot, published the way the trainer does it:
    # bucket buffers at a sync boundary, a versioned manifest
    swap = None
    with tempfile.TemporaryDirectory() as d:
        pub = WeightPublisher(d)
        sub = WeightSubscriber(d, lm.param_specs(cfg), device=dev)
        pub.publish(_weights(cfg, params1, 1, dev, log), step=100)

        t0 = time.perf_counter()
        swap_at = args.requests // 2
        while not eng.idle:
            eng.step()
            if len(eng.completed) >= swap_at and eng.weight_version < 0:
                residents = [r.uid for r in eng.slot_req if r is not None]
                got = eng.poll_weights(sub)
                swap = {"version": got, "residents": residents,
                        "completed_before": len(eng.completed)}
                log(f"hot-swap -> version {got} with {eng.num_active} "
                    f"residents mid-generation")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0

    done = eng.completed
    log(f"served {len(done)} requests, {eng.tokens_out} tokens in "
        f"{eng.steps} steps ({eng.tokens_out / dt:.0f} tok/s)")
    for r in done[:4]:
        log(f"  uid={r.uid} finish={r.finish_reason} "
            f"versions={r.weight_versions} tokens={r.tokens[:8]}"
            f"{'...' if len(r.tokens) > 8 else ''}")
    return {"completed": [{"uid": r.uid, "tokens": list(map(int, r.tokens)),
                           "finish_reason": r.finish_reason,
                           "weight_versions": tuple(r.weight_versions)}
                          for r in done],
            "swap": swap, "tokens_out": eng.tokens_out, "steps": eng.steps,
            "seconds": dt, "arch": cfg.name, "device": str(dev)}


if __name__ == "__main__":
    main()
