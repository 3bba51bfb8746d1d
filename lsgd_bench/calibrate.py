"""Readings that the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, in one process (the bundle's kernels built once):

- the program against the reference on each of ``--seeds``;
- the control: the reference with TF32 matmuls put in the program's
  place, against the reference, on the same seeds;
- the planted faults (``faults.py``) on the first ``--fault-seeds``.

    python3 lsgd_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--fault-seeds 3] [--out chiprun_out/calibrate.jsonl]

One JSON line a seed to ``--out`` and standard output, then a summary:
the largest program reading and the smallest control and fault readings
of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from lsgd_bench import check, faults  # noqa: E402
from lsgd_bench import run as R  # noqa: E402


def program_readings(cfg, traffic, seed, device, tamper=None):
    bundle, state, bats, readings = R.setup(cfg, traffic, seed, device, tamper)
    out = R.to_host(readings)
    del bundle, state, readings
    gc.collect()
    torch.cuda.empty_cache()
    return out, bats


def control_readings(cfg, traffic, seed, bats, device):
    """The reference with TF32 matmuls: the precision below float32."""
    return R.reference_readings(cfg, traffic, seed, bats, device, tf32=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/calibrate.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 1
    files = R.cell_files(R.load_json(R.ROOT / "BENCHMARK.json"), args.workload)
    cfg, traffic = files["config"], files["traffic"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    with open(out, "a") as f:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            prog, bats = program_readings(cfg, traffic, seed, "cuda")
            t1 = time.perf_counter()
            ref = R.reference_readings(cfg, traffic, seed, bats, "cuda")
            t2 = time.perf_counter()
            row = {"cell": args.workload, "seed": seed,
                   "program": check.numbers(prog, ref),
                   "control": check.numbers(
                       control_readings(cfg, traffic, seed, bats, "cuda"), ref),
                   "seconds": {"program": t1 - t0, "reference": t2 - t1,
                               "control": time.perf_counter() - t2},
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "faults": {}}
            if i < args.fault_seeds:
                for name in ("half_batch", "no_exchange"):
                    got, _ = program_readings(cfg, traffic, seed, "cuda",
                                              faults.FAULTS[name])
                    row["faults"][name] = check.numbers(got, ref)
            row["losses"] = {"program": prog["loss"], "reference": ref["loss"]}
            row["worst_leaf"] = {k: check.worst_leaf(prog[k], ref[k])
                                 for k in ("grad", "change")}
            row["leaf_gaps"] = {k: {n: max(v) for n, v in check.leaf_gaps(
                prog[k], ref[k]).items()} for k in ("grad", "change")}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
            del bats
            gc.collect()
            torch.cuda.empty_cache()
    summary = {"cell": args.workload, "seeds": len(rows)}
    for k in check.NUMBERS:
        summary[k] = {
            "program_max": max(r["program"][k] for r in rows),
            "control_min": min(r["control"][k] for r in rows),
            **{f"{n}_min": min(r["faults"][n][k] for r in rows if n in r["faults"])
               for n in ("half_batch", "no_exchange") if any(n in r["faults"] for r in rows)}}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
