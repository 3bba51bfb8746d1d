"""Roofline report (the port of ``repro.roofline.report``): the analytic
model on the card's constants, with the port's dry-run records
(``launch.dryrun``) where they exist, as ``roofline.json`` and a
markdown table.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dryrun DIR] [--out DIR]

Reads ``--dryrun`` (default ``build/dryrun/``), writes only under
``--out`` (default ``build/``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.roofline.analysis import serve_roofline, train_roofline

BUILD = Path(__file__).resolve().parents[3] / "build"
DRYRUN = BUILD / "dryrun"

IMPROVE = {
    "compute": ("compute-bound: raise tensor-core utilization (bf16 / TF32 "
                "GEMMs; the port's f32 matmuls run on the CUDA cores at 67 "
                "of 989 TFLOP/s) or cut recompute"),
    "memory": ("HBM-bound: fuse elementwise chains (the fused bucket "
               "kernels), cut activation traffic (bf16 stashing, flash "
               "attention on the training path)"),
    "collective": ("collective-bound: raise H (the paper's knob - sync cost "
                   "amortizes 1/H), overlap within-worker gathers with "
                   "compute, or shrink the payload with sign compression "
                   "(Alg. 3/4, the 1-bit wire pack)"),
}


def _dryrun_rep(arch, shape, mesh="16x16", dryrun=DRYRUN):
    p = Path(dryrun) / f"{arch}__{shape}__{mesh}.json"
    return json.loads(p.read_text()) if p.exists() else None


def _key(rep) -> str:
    return ("local_step" if "local_step" in rep else
            "prefill" if "prefill" in rep else "decode")


def build_rows(H: int = 8, dryrun=DRYRUN):
    rows = []
    for arch, shape_name in configs.runnable_pairs():
        cfg = configs.get(arch)
        shape = INPUT_SHAPES[shape_name]
        rep = _dryrun_rep(arch, shape_name, dryrun=dryrun)
        if shape.kind == "train":
            W = rep["num_workers"] if rep else 16
            sync_bytes = (rep["sync"]["collectives"]["moved_bytes"]
                          if rep else None)
            r = train_roofline(cfg, shape, num_workers=max(W, 1), H=H,
                               sync_coll_bytes=sync_bytes)
            r.notes = f"K={W}, H={H}"
        else:
            r = serve_roofline(cfg, shape, kind=shape.kind)
        row = {
            "arch": arch, "shape": shape_name, "kind": r.kind,
            "t_compute_s": r.t_compute, "t_memory_s": r.t_memory,
            "t_collective_s": r.t_collective, "dominant": r.dominant,
            "model_flops_per_dev": r.model_flops,
            "flops_per_dev": r.flops_device,
            "useful_ratio": (r.model_flops / r.flops_device
                             if r.flops_device else 0.0),
            "improve": IMPROVE[r.dominant],
            "notes": r.notes,
        }
        if rep:
            key = _key(rep)
            row["dryrun_flops_per_card"] = rep[key]["flops"]
            row["dryrun_peak_gb"] = rep["per_card"]["peak_bytes"] / 1e9
            row["dryrun_fits"] = rep["per_card"]["fits"]
            row["dryrun_trace_s"] = rep[key].get("trace_s")
        rows.append(row)
    return rows


def markdown(rows) -> str:
    out = ["| arch | shape | kind | compute (ms) | memory (ms) | collective (ms) "
           "| dominant | useful FLOP ratio |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f} "
            f"| {r['t_collective_s']*1e3:.2f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default=str(DRYRUN))
    ap.add_argument("--out", default=str(BUILD))
    args = ap.parse_args(argv)
    rows = build_rows(dryrun=args.dryrun)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "roofline.json").write_text(json.dumps(rows, indent=1))
    print(markdown(rows))
    # summary of the most interesting pairs for hillclimbing
    worst = min((r for r in rows if r["kind"] == "train"),
                key=lambda r: r["useful_ratio"])
    coll = max(rows, key=lambda r: r["t_collective_s"] /
               max(r["t_compute_s"], r["t_memory_s"], 1e-12))
    print("\nworst useful-FLOP ratio (train):", worst["arch"], worst["shape"],
          f"{worst['useful_ratio']:.2f}")
    print("most collective-bound:", coll["arch"], coll["shape"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
