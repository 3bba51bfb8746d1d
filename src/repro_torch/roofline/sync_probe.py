"""Sync collective probe (the port of ``repro.roofline.sync_probe``): the
wire cost of the paper's sync variants -- Alg. 1 plain averaging, Alg. 3
signSGD, the 1-bit packed wire format -- on the resident flat-bus path
and on the per-leaf tree path, measured on ``torch.distributed`` ranks.

Each of the reference's five rows (compression x ``wire_pack`` x
``bucket_sync``; ``bucket_sync=False`` is the port's per-leaf tree path,
``build_train(use_kernel=False)``) builds a bundle on the ranks, draws
its weights, and runs one global sync under ``torch.profiler``.  For each
row: the collectives :func:`repro_torch.roofline.hlo.parse_collectives`
reads from the trace (count, ring-model bytes, bytes handed by op), the
bytes ``backend.collectives.Collectives`` counted for the same sync (the
ledger's measured bytes: what each single-call collective was handed;
and ``Collectives.sent``: what the ordered mean's point-to-point sends
carried), and the plan's ring model (``SyncPlan.scope_cost``, the
ledger's).  ``held`` says whether the trace's bytes equal the counted
ones, each by its own definition.

    PYTHONPATH=src python -m repro_torch.roofline.sync_probe --arch paper-lm \\
        --ranks 2 [--smoke] [--device cpu]

Spawns ``--ranks`` gloo ranks (on card 0 unless ``--device cpu``);
writes ``--out`` (default ``build/probes/sync__<arch>.json``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch.configs.base import InputShape, LocalSGDConfig, RunConfig
from repro_torch.roofline.hlo import parse_collectives, profile_records

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "probes"
# (sync_compression, wire_pack, bucket_sync): the reference's rows
ROWS = (("none", False, False), ("none", False, True), ("sign", False, True),
        ("sign", True, False), ("sign", True, True))
# the trace's ring op -> the Collectives op whose count it is held to, and
# which count: the bytes handed ("totals") or the bytes sent ("sent")
HELD_TO = {"all-gather": ("all_gather", "totals"),
           "broadcast": ("broadcast", "totals"),
           "all-reduce": ("all_reduce", "totals"),
           "reduce-scatter": ("reduce_scatter", "totals"),
           "gather": ("gather", "totals"),
           "collective-permute": ("ordered_mean", "sent")}


def _by_op(counts: dict, field: str | None = None) -> dict:
    """``"op/scope"`` counters summed over scopes, by op."""
    out: dict = {}
    for k, v in counts.items():
        op = k.split("/")[0]
        out[op] = out.get(op, 0) + (v[field] if field else v)
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def held(handed: dict, totals: dict, sent: dict) -> dict:
    """Each traced op's handed bytes beside what Collectives counted for
    it: ``{ring op: [traced, counted]}``."""
    out = {}
    for op, b in handed.items():
        name, which = HELD_TO.get(op, (op, "totals"))
        out[op] = [b, (sent if which == "sent" else totals).get(name, 0)]
    for name, b in totals.items():          # counted ops the trace missed
        op = next((o for o, (n, w) in HELD_TO.items()
                   if n == name and w == "totals"), name)
        if op not in out and name != "ordered_mean":
            out[op] = [0, b]
    if sent and "collective-permute" not in out:
        out["collective-permute"] = [0, sent.get("ordered_mean", 0)]
    return out


def measure_sync(be, cfg, *, compression: str, wire_pack: bool,
                 bucket_sync: bool = True, local_batch: int = 8, seq: int = 512,
                 seed: int = 0) -> dict:
    """One global sync of a fresh state of ``cfg`` on this rank of the
    ``DistributedBackend`` ``be`` (every rank calls it alike)."""
    import torch.distributed as dist
    from repro_torch.models import base as mbase
    W = be.num_workers
    run = RunConfig(
        model=cfg, shape=InputShape("sync_probe", seq, W * local_batch, "train"),
        local_sgd=LocalSGDConfig(local_steps=8, sync_compression=compression,
                                 wire_pack=wire_pack))
    bundle = be.build(run, **({} if bucket_sync else dict(use_kernel=False)))
    dev = bundle.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = bundle.init(mbase.materialize(bundle.specs, gen, dev), seed=seed)
    col, plan = bundle.dist, bundle.sync_plan
    col.take_stage_bytes("global", len(plan.collective_stages("global")))
    totals0, sent0 = _by_op(col.totals, "bytes"), _by_op(col.sent)
    fence = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (
        lambda: None)
    fence()
    dist.barrier()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        state = bundle.sync(state, plan=plan, scope="global")
        fence()
    s = parse_collectives(profile_records(prof),
                          group_size=col.layout.num_groups)
    measured = col.take_stage_bytes("global",
                                    len(plan.collective_stages("global")))
    totals = _delta(_by_op(col.totals, "bytes"), totals0)
    sent = _delta(_by_op(col.sent), sent0)
    handed = s.handed_by_op()
    pairs = held(handed, totals, sent)
    ring, count = plan.scope_cost("global")
    del state, bundle
    return {"compression": compression, "wire_pack": wire_pack,
            "bucket_sync": bucket_sync, "workers": W,
            "ranks": col.size, "rank": col.rank,
            "count": s.count(), "coll_bytes": s.total_bytes(),
            "by_op": s.by_op(), "handed_by_op": handed,
            "c10d_calls": sorted({o.name for o in s.ops}),
            "collectives_handed": totals, "collectives_sent": sent,
            "ledger_measured_bytes": measured,
            "ring_model_bytes": ring, "ring_model_collectives": count,
            "held": pairs,
            "held_equal": all(a == b for a, b in pairs.values())}


def probe_rows(be, cfg, *, local_batch: int = 8, seq: int = 512,
               rows=ROWS) -> list:
    """:func:`measure_sync` of each row, on this rank."""
    out = []
    for compression, pack, bucket in rows:
        out.append(measure_sync(be, cfg, compression=compression,
                                wire_pack=pack, bucket_sync=bucket,
                                local_batch=local_batch, seq=seq))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _rank(r: int, port: int, P: int, spec: dict, out: str):
    """One rank of the probe (``torch.multiprocessing.spawn``'s target)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.backend.distributed import DistributedBackend
    cfg = (configs.get_smoke if spec["smoke"] else configs.get)(spec["arch"])
    be = DistributedBackend(spec["workers"], backend="gloo", process_id=r,
                            num_processes=P,
                            coordinator_address=f"localhost:{port}",
                            local_rank=r, device=spec["device"])
    try:
        rows = probe_rows(be, cfg, local_batch=spec["local_batch"],
                          seq=spec["seq"])
        Path(out, f"rank{r}.json").write_text(json.dumps(rows))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_probe(arch: str, *, ranks: int, workers: int, device: str,
              smoke: bool = False, local_batch: int = 8, seq: int = 512,
              scratch: Path) -> list:
    """Spawn ``ranks`` gloo ranks, each probing the five rows; returns
    every rank's rows."""
    import torch.multiprocessing as mp
    scratch.mkdir(parents=True, exist_ok=True)
    spec = dict(arch=arch, smoke=smoke, workers=workers, device=device,
                local_batch=local_batch, seq=seq)
    mp.spawn(_rank, args=(_free_port(), ranks, spec, str(scratch)),
             nprocs=ranks)
    return [json.loads((scratch / f"rank{r}.json").read_text())
            for r in range(ranks)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--workers", type=int, help="default: one a rank")
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", help="cpu | cuda (default: the card)")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to probe on "
                               "the CPU")
        device = "cuda:0"
    out = Path(args.out)
    rows = run_probe(args.arch, ranks=args.ranks,
                     workers=args.workers or args.ranks, device=device,
                     smoke=args.smoke, local_batch=args.local_batch,
                     seq=args.seq, scratch=out / f"sync__{args.arch}_ranks")
    for r in rows[0]:
        print(json.dumps({k: r[k] for k in (
            "compression", "wire_pack", "bucket_sync", "count", "coll_bytes",
            "handed_by_op", "ring_model_bytes", "held_equal")}))
    (out / f"sync__{args.arch}.json").write_text(json.dumps(rows[0], indent=1))
    bad = [r for rk in rows for r in rk if not r["held_equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
