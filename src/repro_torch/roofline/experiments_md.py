"""The dry-run and roofline sections as markdown (the port of
``repro.roofline.experiments_md``), from the port's dry-run records
(``launch.dryrun``) and the analytic roofline on the card's constants.

    PYTHONPATH=src python -m repro_torch.roofline.experiments_md [--dryrun DIR] [--out DIR]

Prints the sections and writes them to ``--out`` (default ``build/``)
as ``experiments.md``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import configs
from repro_torch.roofline.report import BUILD, DRYRUN, _key, build_rows


def dryrun_table(mesh_tag: str, dryrun=DRYRUN) -> str:
    rows = ["| arch | shape | kind | trace (s) | GFLOPs a card (FlopCounterMode) "
            "| peak GB a card | fits 80 GB | step collective MB | sync MB "
            "| notes |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for arch, shape in configs.runnable_pairs():
        p = Path(dryrun) / f"{arch}__{shape}__{mesh_tag}.json"
        if not p.exists():
            rows.append(f"| {arch} | {shape} | - | MISSING | | | | | | |")
            continue
        rep = json.loads(p.read_text())
        k = _key(rep)
        r = rep[k]
        pc = rep["per_card"]
        sync = note = ""
        if k == "local_step":
            sync = f"{rep['sync']['collectives']['moved_bytes'] / 1e6:.0f}"
            note = (f"K={rep['num_workers']}; {pc['max_layers']} of "
                    f"{configs.get(arch).num_layers} layers fit a card")
        else:
            note = f"cache {r['cache_bytes'] / 1e9:.2f} GB"
        rows.append(
            f"| {arch} | {shape} | {rep['kind']} | {r['trace_s']:.1f} "
            f"| {r['flops'] / 1e9:.0f} | {pc['peak_bytes'] / 1e9:.2f} "
            f"| {'yes' if pc['fits'] else 'no'} "
            f"| {r['collectives']['moved_bytes'] / 1e6:.0f} | {sync} | {note} |")
    return "\n".join(rows)


def roofline_table(dryrun=DRYRUN) -> str:
    rows = build_rows(dryrun=dryrun)
    out = ["| arch | shape | kind | compute (ms) | memory (ms) | collective "
           "(ms) | dominant | MODEL/analytic FLOPs | what moves the dominant "
           "term |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f} "
            f"| {r['t_collective_s']*1e3:.2f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['improve']} |")
    return "\n".join(out)


def skips_table() -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    for (a, s), why in configs.SKIPS.items():
        rows.append(f"| {a} | {s} | {why} |")
    return "\n".join(rows)


def sections(dryrun=DRYRUN) -> str:
    return "\n".join([
        "### Dry-run — single-pod 16x16 (256 H100s)\n",
        dryrun_table("16x16", dryrun),
        "\n### Dry-run — multi-pod 2x16x16 (512 H100s)\n",
        dryrun_table("2x16x16", dryrun),
        "\n### Skipped (arch x shape) combinations\n",
        skips_table(),
        "\n### Roofline (single-pod, analytic, H100 SXM constants)\n",
        roofline_table(dryrun)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default=str(DRYRUN))
    ap.add_argument("--out", default=str(BUILD))
    args = ap.parse_args(argv)
    text = sections(args.dryrun)
    print(text)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "experiments.md").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
