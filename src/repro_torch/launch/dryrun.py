"""Dry run on the ``meta`` device (the GPU analogue of
``repro.launch.dryrun``).

The reference lowers and compiles every (architecture x input shape) on
its production TPU meshes and records memory, cost and collectives.  The
port traces one step of every pair on the ``meta`` device, which needs no
card and no memory, and records for each:

* **FLOPs** (``torch.utils.flop_counter.FlopCounterMode``, matmul-family
  ops) of one worker's loss and gradient at the published width and full
  depth (train), or of one prefill / decode step;
* **activations**: the bytes autograd saves for the backward
  (``torch.autograd.graph.saved_tensors_hooks``), each storage alive at
  the end of the forward counted once, the parameters and the batch left
  out; and the logits' gradient the loss's backward makes beside them
  (B x S x V float32);
* **state**: :func:`m_reckon`'s copies of the flat-bus buckets;
* **the sync**: its collective bytes under the ring model of the layout
  (``telemetry.ledger.analytic_sync_cost``), and the local step's
  within-worker gathers (and FSDP's reduce-scatter) on a grid;
* **per card**: the reckoned peak, and the deepest depth that fits one
  card at the run's W and batch (FLOPs and activations extrapolated over
  layer periods, as ``roofline.probe`` does; the state exact).

On a production grid (``launch.mesh``: 16 x 16, ``--multi-pod`` 2 x 16
x 16; ``--layout tp|fsdp``; W from ``sharding.layout.choose_worker_axes``)
a card holds its shard's rows and computes as the port computes: a tensor
parallel shard rank the whole worker batch, an FSDP shard rank its share.
On one card (``--workers``, ``--local-batch``, ``--seq``, ``--layers``,
``--sync``) all W workers share the card and run one after another, as
``chip_smoke.py``'s phases run them.

The trace costs time where a model loops in Python.  The sLSTM cell runs
once a token and layer, so a model with sLSTM blocks (xlstm-1.3b) is
traced at ``SEQ_PROBE`` and twice that many positions and its counts
extrapolated to the pair's length: its step is affine in the length
(no attention; the mLSTM's chunks and the loss's blocks divide both
lengths), so the extrapolation is the full trace's count
(``tests/test_torch_dryrun.py`` holds it at smoke size).  mamba2's chunk
loop runs once a chunk and is traced in full.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --device meta
    python -m repro_torch.launch.dryrun --all --device meta [--multi-pod] [--layout fsdp]
    python -m repro_torch.launch.dryrun --arch paper-lm --workers 4 \\
        --local-batch 8 --seq 512 [--layers 2] [--sync ef_sign] \\
        [--remat block] --device meta

Records go to ``--out`` (default ``build/dryrun/``), one JSON file a pair.
Without ``--device`` the trace runs on the card (and raises without one).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, RunConfig
from repro_torch.core import flatbuf
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import HBM_BYTES, make_production_grid
from repro_torch.models import base as mbase
from repro_torch.models import lm
from repro_torch.roofline.hlo import _ring_bytes
from repro_torch.sharding.layout import (choose_worker_axes,
                                         fsdp_within_worker_layout,
                                         train_layout)
from repro_torch.telemetry.ledger import analytic_sync_cost
from repro_torch.utils import resolve_device, tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
ROW = flatbuf.LANE * 4           # bytes of one f32 bucket row
# mixers whose step loops in Python once a token, and the lengths a model
# with one is traced at (its counts extrapolated to the pair's length)
TOKEN_LOOP_MIXERS = ("slstm",)
SEQ_PROBE = 256
# the state a cut depth's m_reckon peak must stay under on one card: the
# card's 80 GB less 8 GB for the activations m_reckon leaves out
X_CAP_BYTES = 72e9


# ---------------------------------------------------------------------------
# state copies (the flat-bus buckets)
# ---------------------------------------------------------------------------

def m_reckon(cfg, workers: int, mode: str) -> dict:
    """Memory reckoned from the layout's rows before the run: one param
    copy's bucket bytes, and the copies resident at once.  Resident:
    params and momentum (W each), plus EF memory (W) and the anchor under
    EF-sign.  A local step adds the grad buckets (W); a sync adds its
    temporaries: the mean's (the W-wide broadcast mean and the mean
    itself, W + 1), EF-sign's (delta, compressor input, output and new
    memory, 4W).  Activations are not in the sum (:func:`reckon_card`
    adds them)."""
    specs = lm.param_specs(cfg)
    copy = flatbuf.build_layout(mbase.abstract(specs)).total_bytes()
    ef = mode == "ef_sign"
    resident = 2 * workers + (workers + 1 if ef else 0)
    step = resident + workers
    sync = resident + (4 * workers if ef else workers + 1)
    return {"params": mbase.count_params(specs), "copy_bytes": copy,
            "resident_copies": resident, "step_copies": step,
            "sync_copies": sync, "reckoned_peak_bytes": max(step, sync) * copy}


def deepest(num_layers: int, fits) -> int:
    """The most layers (at least 1, at most ``num_layers``) whose depth
    ``fits(L)``, counting up from 1."""
    depth = 1
    while depth < num_layers and fits(depth + 1):
        depth += 1
    return depth


def x_depth(published, workers: int, mode: str, cap: float = X_CAP_BYTES) -> int:
    """The deepest cut of ``published`` (at least 1 layer) whose m_reckon
    peak stays under ``cap`` bytes."""
    return deepest(published.num_layers, lambda L: m_reckon(
        published.replace(num_layers=L), workers, mode)
        ["reckoned_peak_bytes"] <= cap)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def trace_params(cfg: ModelConfig, device, *, requires_grad: bool = True):
    """The model's parameters on ``device``: uninitialized on ``meta``,
    drawn from seed 0 elsewhere."""
    specs = lm.param_specs(cfg)
    dtype = flatbuf.torch_dtype(cfg.param_dtype)
    if torch.device(device).type == "meta":
        params = tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                                device="meta"),
                          specs, is_leaf=mbase.is_spec)
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        params = mbase.materialize(specs, gen, device, dtype)
    return tree_map(lambda t: t.requires_grad_(requires_grad), params)


def worker_batch(cfg: ModelConfig, local_batch: int, seq: int, device) -> dict:
    """One worker's training batch of ``local_batch`` x ``seq``
    (``inputs.train_batch_shapes``: whisper's frames, internvl2's
    prefix): zero token ids and zero embeddings, data-free shapes."""
    shape = InputShape("dryrun", seq, local_batch, "train")
    out = {}
    for k, (s, kind) in inp.train_batch_shapes(cfg, shape, 1).items():
        dt = torch.int64 if kind == "tok" else torch.float32
        out[k] = torch.zeros(s[1:], dtype=dt, device=device)
    return out


def logits_rows(batch: dict) -> int:
    """Positions the loss's logits cover: tokens after the prefix."""
    B, S = batch["tokens"].shape
    return B * (S + (batch["prefix_embed"].shape[1] if "prefix_embed" in batch
                     else 0))


def _flops(fc: FlopCounterMode) -> dict:
    by_op = {str(k).split(".")[-1] if "." in str(k) else str(k): int(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "flops_by_op": by_op}


def _loops_per_token(cfg: ModelConfig, seq: int) -> bool:
    return (any(b.mixer in TOKEN_LOOP_MIXERS for b in cfg.blocks)
            and seq > 2 * SEQ_PROBE and seq % SEQ_PROBE == 0)


def _affine_in_seq(trace, seq: int) -> dict:
    """``trace(n)`` at ``SEQ_PROBE`` and twice it, each count taken to
    ``seq`` positions as ``f(s1) + (f(2 s1) - f(s1)) (seq - s1) / s1``."""
    s1 = SEQ_PROBE
    a, b = trace(s1), trace(2 * s1)
    k = (seq - s1) // s1

    def ext(x, y):
        if isinstance(x, dict):
            return {op: ext(x.get(op, 0), y.get(op, 0)) for op in {**x, **y}}
        return x + (y - x) * k

    # the count of saved storages is not affine (the loss's blocks of up
    # to 512 positions): it is left out
    out = {key: ext(a[key], b[key]) for key in a
           if key not in ("trace_s", "saved_storages")}
    out["trace_s"] = a["trace_s"] + b["trace_s"]
    out["seq_extrapolated_from"] = [s1, 2 * s1]
    return out


def trace_train(cfg: ModelConfig, local_batch: int, seq: int, *,
                device="meta", flops: bool = True, remat: str = "none") -> dict:
    """One worker's loss and gradient: FLOPs, the bytes saved for the
    backward (each storage alive at the end of the forward once; the
    parameters' and the batch's left out), and the logits' gradient.
    ``flops=False`` traces the forward alone (the saved bytes are known at
    its end) and counts no FLOPs.  A model that loops once a token is
    traced at two shorter lengths and extrapolated (``_affine_in_seq``).

    ``remat="block"`` (``lm.loss_fn``'s): the saved bytes are what the
    outer hook sees (the ops outside the checkpointed layers) plus what
    checkpoint keeps (each layer's input and the tensors it reads, which
    checkpoint's own hooks hide from the outer one), and
    ``recompute_bytes`` is the backward's transient of the replayed
    layer: the most one period layer saves when it runs without
    checkpoint.  The FLOPs count the replay (one more forward of the
    period layers)."""
    if _loops_per_token(cfg, seq):
        return _affine_in_seq(lambda n: _trace_train(
            cfg, local_batch, n, device=device, flops=flops, remat=remat), seq)
    return _trace_train(cfg, local_batch, seq, device=device, flops=flops,
                        remat=remat)


def _storages(tensors, skip: set) -> dict:
    """{storage id: bytes} of the tensors among ``tensors`` (trees
    allowed) whose storage is not in ``skip``."""
    out = {}
    for t in tree_leaves(list(tensors)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in skip:
                out[st._cdata] = st.nbytes()
    return out


def _saved_by(fn, skip: set) -> dict:
    """{storage id: bytes} of what autograd saves while ``fn()`` runs
    and still holds at its end, storages in ``skip`` left out."""
    refs = []

    def pack(t):
        refs.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, _storages([r() for r in refs if r() is not None], skip)


def _trace_train(cfg: ModelConfig, local_batch: int, seq: int, *,
                 device="meta", flops: bool = True, remat: str = "none") -> dict:
    device = torch.device(device)
    params = trace_params(cfg, device)
    batch = worker_batch(cfg, local_batch, seq, device)
    own = {t.untyped_storage()._cdata
           for t in tree_leaves(params) + list(batch.values())}

    t0 = time.perf_counter()
    fc = FlopCounterMode(display=False) if flops else None
    with fc or contextlib.nullcontext(), lm.record_remat() as layers:
        (loss, _), saved = _saved_by(
            lambda: lm.loss_fn(cfg, params, batch, remat=remat), own)
        for _, args, keep in layers:
            saved.update(_storages((args, keep), own))
        if flops:
            torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    rows = logits_rows(batch)
    rec = {**(_flops(fc) if flops else {}),
           "saved_bytes": int(sum(saved.values())),
           "saved_storages": len(saved),
           "logits_grad_bytes": rows * cfg.vocab_size * 4}
    if remat == "block":
        # each period layer once more, without checkpoint: what its replay
        # in the backward saves beside the kept inputs
        transient = 0
        for fn, args, keep in layers[:len(cfg.blocks)]:
            skip = own | set(_storages((args, keep), set()))
            transient = max(transient, sum(_saved_by(
                lambda: fn(*args), skip)[1].values()))
        rec["recompute_bytes"] = int(transient)
    rec["trace_s"] = time.perf_counter() - t0
    return rec


def trace_serve(cfg: ModelConfig, shape: InputShape, *, device="meta") -> dict:
    """One prefill of ``shape`` (B x S prompt), or one decode step over a
    cache of S positions (whisper: its 448 decoder positions over an
    encoder of S frames): FLOPs and the cache's bytes.  A prefill of a
    model that loops once a token is extrapolated in its length."""
    if shape.kind == "prefill" and _loops_per_token(cfg, shape.seq_len):
        return _affine_in_seq(lambda n: _trace_serve(
            cfg, InputShape(shape.name, n, shape.global_batch, shape.kind),
            device=device), shape.seq_len)
    return _trace_serve(cfg, shape, device=device)


def _trace_serve(cfg: ModelConfig, shape: InputShape, *, device="meta") -> dict:
    device = torch.device(device)
    dtype = flatbuf.torch_dtype(cfg.param_dtype)
    params = trace_params(cfg, device, requires_grad=False)
    B, S = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if shape.kind == "prefill":
            spec = inp.serve_token_specs(cfg, shape, prefill=True)
            batch = {k: torch.zeros(v.shape, device=device,
                                    dtype=torch.int64 if k == "tokens" else dtype)
                     for k, v in spec.items()}
            _, cache = lm.prefill(cfg, params, batch["tokens"],
                                  prefix_embed=batch.get("prefix_embed"),
                                  enc_frames=batch.get("frames"))
        else:
            enc_len = S if cfg.cross_attention else None
            self_len = (min(inp.WHISPER_MAX_DECODER, S) if cfg.cross_attention
                        else S)
            cache = lm.init_cache(cfg, B, self_len, dtype=dtype, device=device,
                                  enc_len=enc_len)
            tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
            # one length a row: a 0-d position would be read on the host,
            # which a meta tensor cannot be
            lens = torch.full((B,), self_len, dtype=torch.int64, device=device)
            lm.decode_step(cfg, params, tok, cache, lens)
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    return {**_flops(fc), "cache_bytes": int(cache_bytes),
            "param_bytes": int(sum(p.numel() * p.element_size()
                                   for p in tree_leaves(params))),
            "trace_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# per-card reckoning
# ---------------------------------------------------------------------------

def period_probe(cfg: ModelConfig, local_batch: int, seq: int, *,
                 device="meta", remat: str = "none") -> dict:
    """One worker's step at 1 and 2 layer-periods (``len(cfg.blocks)``
    layers): its FLOPs and saved bytes as ``fixed + slope x (L /
    period)`` (``roofline.probe.extrapolate``), and under ``remat`` the
    replayed layer's transient (the same at any depth)."""
    from repro_torch.roofline.probe import extrapolate
    period = len(cfg.blocks)
    m1, m2 = (trace_train(cfg.replace(num_layers=n), local_batch, seq,
                          device=device, remat=remat)
              for n in (period, 2 * period))
    return {"period": period, "recompute_bytes": m1.get("recompute_bytes", 0),
            **extrapolate(m1, m2, cfg.num_layers / period,
                          ("flops", "saved_bytes"))}


def _at_depth(probe: dict, key: str, layers: int) -> float:
    return probe[f"{key}_fixed"] + probe[f"{key}_per_period"] * (
        layers / probe["period"])


def reckon_card(cfg: ModelConfig, trace: dict, *, workers: int,
                mode: str) -> dict:
    """One card holding all ``workers`` (``chip_smoke.py``'s phases): the
    state copies (:func:`m_reckon`) and, during a local step, one
    worker's activations and its logits' gradient (``trace``, of
    :func:`trace_train`; the workers run one after another), and under
    ``remat="block"`` the replayed layer's transient (the trace's
    ``recompute_bytes``).  The logits' gradient is the backward's largest
    transient without remat: B x S x V float32 next to the saved logits
    (qwen3-32b's 152k vocabulary puts its 1-layer step at 73.9 GB against
    57.2 GB of state copies)."""
    m = m_reckon(cfg, workers, mode)
    t = trace
    copy = m["copy_bytes"]
    recompute = t.get("recompute_bytes", 0)
    step = (m["step_copies"] * copy + t["saved_bytes"] + t["logits_grad_bytes"]
            + recompute)
    sync = m["sync_copies"] * copy
    return {"state_bytes": m["reckoned_peak_bytes"],
            "copy_bytes": copy, "step_copies": m["step_copies"],
            "sync_copies": m["sync_copies"],
            "activation_bytes": t["saved_bytes"],
            "logits_grad_bytes": t["logits_grad_bytes"],
            "recompute_bytes": recompute,
            "step_peak_bytes": step, "sync_peak_bytes": sync,
            "peak_bytes": max(step, sync), "fits": max(step, sync) <= HBM_BYTES,
            "flops_worker": t.get("flops")}


def card_depth(cfg: ModelConfig, *, workers: int, local_batch: int, seq: int,
               mode: str, probe: dict, cap: float = HBM_BYTES) -> int:
    """The deepest cut (at least 1 layer) whose one-card reckoning stays
    under ``cap``: the state exact at each depth, the activations from the
    period probe, the logits' gradient as it is at any depth."""
    rows_v = worker_batch(cfg, local_batch, seq, "meta")
    logits = logits_rows(rows_v) * cfg.vocab_size * 4

    def peak(L):
        m = m_reckon(cfg.replace(num_layers=L), workers, mode)
        step = (m["step_copies"] * m["copy_bytes"]
                + _at_depth(probe, "saved_bytes", L) + logits
                + probe.get("recompute_bytes", 0))
        return max(step, m["sync_copies"] * m["copy_bytes"])

    return deepest(cfg.num_layers, lambda L: peak(L) <= cap)


def pick_train_layout(grid, cfg: ModelConfig, kind: str = "tp"):
    n_params = mbase.count_params(lm.param_specs(cfg))
    worker_axes, fsdp_axes = choose_worker_axes(grid, n_params)
    if kind == "fsdp":
        lay = fsdp_within_worker_layout(tuple(grid.axis_names),
                                        worker_axes=worker_axes)
    else:
        lay = train_layout(tuple(grid.axis_names), worker_axes=worker_axes,
                           fsdp_axes=fsdp_axes)
    return lay.with_sizes(grid.shape), n_params


def _coll(cost_bytes: float, count: int, by_op: dict, crosses: bool = False):
    return {"count": count, "moved_bytes": float(cost_bytes),
            "moved_bytes_cross_pod": float(cost_bytes) if crosses else 0.0,
            "by_op": by_op}


def _sync_coll(flay, W: int, mode: str, wire_pack: bool = False,
               crosses: bool = False) -> dict:
    """One sync's collectives under the ring model of the layout
    (``telemetry.ledger.analytic_sync_cost``): the wire pack's gathers,
    or a dense all-reduce a bucket."""
    sync = analytic_sync_cost(flay, group=W, modes=(mode,) * flay.num_buckets,
                              wire_pack=wire_pack)
    op = "all-gather" if wire_pack and mode != "none" else "all-reduce"
    return _coll(sync.bytes_on_wire, sync.collectives,
                 {op: sync.bytes_on_wire}, crosses)


def grid_state(cfg: ModelConfig, lay, run: RunConfig, W: int) -> dict:
    """A card's bytes on the grid by the flat-bus layout: its worker's
    state on its shard's rows (params, momentum, EF memory, anchor), and
    the local step's whole-row buffers (the gathered sharded bucket, the
    gradient, FSDP's reduce-scatter input and output); the local step's
    within-worker collectives and the sync's, under the ring model."""
    specs = lm.param_specs(cfg)
    flay = flatbuf.build_layout(mbase.abstract(specs),
                                wd_mask=mbase.norm_param_mask(specs),
                                shard_classes=flatbuf.shard_classes(specs, lay))
    ls = run.local_sgd
    S = lay.within_worker_size()
    split = lay.batch_split() > 1
    nb = flay.num_buckets
    held = sum(flay.bucket_local_rows(b) for b in range(nb))
    sharded = sum(flay.bucket_rows[b] for b in range(nb)
                  if flay.bucket_shard_count(b) > 1)
    whole = sum(flay.bucket_rows)
    state = ((2 + (ls.sync_compression == "ef_sign")) * held * ROW
             + (ls.sync_compression != "none") * held * ROW)
    bufs = (2 * sharded + whole + split * (sharded + held)) * ROW
    step_ops, step_bytes = {}, 0.0
    if S > 1 and sharded:
        g = _ring_bytes("all-gather", sharded * ROW, S)
        step_ops["all-gather"] = g
        step_bytes += g
        if split:
            rs = _ring_bytes("reduce-scatter", sharded * ROW // S, S)
            step_ops["reduce-scatter"] = rs
            step_bytes += rs
    # a group over the "pod" axis crosses pods: the sync's over the worker
    # axes, the local step's over the rest
    within = [a for a in lay.mesh_axes if a not in lay.worker_axes]
    return {"state_bytes": state, "buffer_bytes": bufs, "shard_ranks": S,
            "batch_split": lay.batch_split(), "rows_held": held,
            "rows_whole": whole,
            "step_collectives": _coll(step_bytes, len(step_ops), step_ops,
                                      "pod" in within),
            "sync_collectives": _sync_coll(flay, W, ls.sync_compression,
                                           ls.wire_pack,
                                           "pod" in lay.worker_axes)}


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def grid_step(cfg: ModelConfig, shape: InputShape, grid, layout_kind: str,
              *, device="meta") -> dict:
    """A card's share of one local step of ``cfg`` at ``shape`` on
    ``grid``: the layout, W, a worker's batch and trace, the card's
    state (:func:`grid_state`), and the share of the batch it computes
    (an FSDP shard rank's 1/S; a tensor-parallel one computes it
    whole)."""
    lay, n_params = pick_train_layout(grid, cfg, layout_kind)
    lay.validate()
    W = max(lay.axis_size(lay.worker_axes), 1)
    B = shape.global_batch // W
    g = grid_state(cfg, lay, RunConfig(model=cfg, shape=shape), W)
    return {"layout": lay, "n_params": n_params, "W": W, "B": B, "state": g,
            "trace": trace_train(cfg, B, shape.seq_len, device=device),
            "share": 1.0 / g["batch_split"]}


def dryrun_train(arch: str, shape: InputShape, grid, layout_kind: str = "tp",
                 *, device="meta") -> dict:
    """One local step and one sync of ``arch`` at ``shape`` on ``grid``."""
    cfg = configs.get(arch)
    run = RunConfig(model=cfg, shape=shape)
    gs = grid_step(cfg, shape, grid, layout_kind, device=device)
    lay, W, B, t, g, share = (gs[k] for k in ("layout", "W", "B", "trace",
                                             "state", "share"))
    probe = period_probe(cfg, B, shape.seq_len, device=device)
    act = t["saved_bytes"] * share
    logits = t["logits_grad_bytes"] * share
    peak = g["state_bytes"] + g["buffer_bytes"] + act + logits

    def peak_at(L):
        gl = grid_state(cfg.replace(num_layers=L), lay, run, W)
        return (gl["state_bytes"] + gl["buffer_bytes"] + logits
                + _at_depth(probe, "saved_bytes", L) * share)

    depth = deepest(cfg.num_layers, lambda L: peak_at(L) <= HBM_BYTES)
    return {"arch": arch, "shape": shape.name, "kind": "train",
            "mesh": grid.shape, "num_workers": W, "layout": layout_kind,
            "worker_axes": list(lay.worker_axes), "n_params": gs["n_params"],
            "local_batch": B, "seq": shape.seq_len,
            "sync_compression": run.local_sgd.sync_compression,
            "local_step": {"name": "local_step", "flops": t["flops"] * share,
                           "flops_worker": t["flops"],
                           "flops_by_op": t["flops_by_op"],
                           "saved_bytes": act, "logits_grad_bytes": logits,
                           "trace_s": t["trace_s"],
                           "collectives": g["step_collectives"]},
            "sync": {"name": "sync", "flops": 0.0,
                     "collectives": g["sync_collectives"]},
            "per_card": {"state_bytes": g["state_bytes"],
                         "buffer_bytes": g["buffer_bytes"],
                         "activation_bytes": act, "logits_grad_bytes": logits,
                         "peak_bytes": peak, "fits": peak <= HBM_BYTES,
                         "shard_ranks": g["shard_ranks"],
                         "batch_split": g["batch_split"],
                         "max_layers": depth},
            "probe": probe}


def dryrun_serve(arch: str, shape: InputShape, grid, *, device="meta") -> dict:
    """One prefill or decode step of ``arch`` at ``shape``: the port serves
    on one card (no sharded serving), so the card holds the weights and
    the whole cache."""
    cfg = configs.get(arch)
    n_params = mbase.count_params(lm.param_specs(cfg))
    t = trace_serve(cfg, shape, device=device)
    peak = t["param_bytes"] + t["cache_bytes"]
    rep = {"name": "prefill" if shape.kind == "prefill" else "decode_step",
           "flops": t["flops"], "flops_by_op": t["flops_by_op"],
           "cache_bytes": t["cache_bytes"], "param_bytes": t["param_bytes"],
           "trace_s": t["trace_s"], "collectives": _coll(0.0, 0, {})}
    return {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "mesh": grid.shape, "n_params": n_params,
            "prefill" if shape.kind == "prefill" else "decode": rep,
            "per_card": {"peak_bytes": peak, "fits": peak <= HBM_BYTES}}


def dryrun_card(arch: str, *, workers: int, local_batch: int, seq: int,
                layers: int | None = None, mode: str = "none",
                remat: str = "none", device="meta") -> dict:
    """One card at ``workers`` x ``local_batch`` x ``seq`` (the phases of
    ``chip_smoke.py``), ``arch`` cut to ``layers``, under ``remat``."""
    published = configs.get(arch)
    cfg = (published if layers is None or layers >= published.num_layers
           else published.replace(num_layers=layers))
    t = trace_train(cfg, local_batch, seq, device=device, remat=remat)
    probe = period_probe(published, local_batch, seq, device=device,
                         remat=remat)
    rc = reckon_card(cfg, t, workers=workers, mode=mode)
    specs = lm.param_specs(cfg)
    flay = flatbuf.build_layout(mbase.abstract(specs))
    return {"arch": arch, "shape": f"card_{workers}x{local_batch}x{seq}",
            "kind": "train", "mesh": {"card": 1}, "num_workers": workers,
            "layout": "one_card", "worker_axes": [], "layers": cfg.num_layers,
            "n_params": mbase.count_params(specs), "local_batch": local_batch,
            "seq": seq, "sync_compression": mode, "remat": remat,
            "local_step": {"name": "local_step",
                           "flops": t["flops"] * workers,
                           "flops_worker": t["flops"],
                           "flops_by_op": t["flops_by_op"],
                           "saved_bytes": t["saved_bytes"],
                           "logits_grad_bytes": t["logits_grad_bytes"],
                           "trace_s": t["trace_s"],
                           "collectives": _coll(0.0, 0, {})},
            "sync": {"name": "sync", "flops": 0.0,
                     "collectives": _sync_coll(flay, workers, mode)},
            "per_card": {**rc, "max_layers": card_depth(
                published, workers=workers, local_batch=local_batch, seq=seq,
                mode=mode, probe=probe)},
            "probe": probe}


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool,
                layout_kind: str = "tp", device="meta") -> dict:
    grid = make_production_grid(multi_pod=multi_pod)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return dryrun_train(arch, shape, grid, layout_kind, device=device)
    return dryrun_serve(arch, shape, grid, device=device)


def record_path(out: Path, arch: str, shape: str, mesh_tag: str) -> Path:
    return Path(out) / f"{arch}__{shape}__{mesh_tag}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--workers", type=int, help="one card: W workers on it")
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--sync", default="none", choices=["none", "sign", "ef_sign"])
    ap.add_argument("--remat", default="none", choices=["none", "block"],
                    help="one card: recompute each layer in the backward")
    ap.add_argument("--device", help="meta | cpu | cuda (default: the card)")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.workers:
        if not args.arch:
            ap.error("--workers needs --arch")
        rep = dryrun_card(args.arch, workers=args.workers,
                          local_batch=args.local_batch, seq=args.seq,
                          layers=args.layers, mode=args.sync,
                          remat=args.remat, device=device)
        path = record_path(out, args.arch, rep["shape"],
                           f"card_L{rep['layers']}_{args.sync}"
                           + ("_remat" if args.remat == "block" else ""))
        path.write_text(json.dumps(rep, indent=1))
        pc = rep["per_card"]
        print(json.dumps({"record": str(path), "peak_GB": pc["peak_bytes"] / 1e9,
                          "max_layers": pc["max_layers"],
                          "flops": rep["local_step"]["flops"]}))
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, --arch and --shape, or --arch and --workers")
    pairs = configs.runnable_pairs() if args.all else [(args.arch, args.shape)]
    mesh_tag = ("2x16x16" if args.multi_pod else "16x16") + (
        "" if args.layout == "tp" else f"_{args.layout}")
    failures = []
    t_all = time.perf_counter()
    for arch, shape in pairs:
        tag = f"{arch}__{shape}__{mesh_tag}"
        path = record_path(out, arch, shape, mesh_tag)
        if path.exists():
            print(f"[skip] {tag} (exists)")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        t0 = time.perf_counter()
        try:
            rep = dryrun_pair(arch, shape, multi_pod=args.multi_pod,
                              layout_kind=args.layout, device=device)
            rep["wall_s"] = round(time.perf_counter() - t0, 1)
            path.write_text(json.dumps(rep, indent=1))
            key = ("local_step" if "local_step" in rep
                   else "prefill" if "prefill" in rep else "decode")
            r = rep[key]
            print(f"  ok {rep['wall_s']}s flops={r['flops']:.3e} "
                  f"peak={rep['per_card']['peak_bytes'] / 1e9:.2f}GB/card "
                  f"coll={r['collectives']['moved_bytes'] / 1e6:.1f}MB",
                  flush=True)
        except Exception:
            failures.append(tag)
            print(f"  FAIL {tag}")
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} dry-run failures: {', '.join(failures)}")
        return 1
    print(f"all dry runs passed ({time.perf_counter() - t_all:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
