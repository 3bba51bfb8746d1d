"""Exporters for the trace and metrics streams, and the run manifest (the
port of ``repro.telemetry.export``).

* :func:`perfetto_trace` — Chrome trace-event JSON (``traceEvents`` of
  ``ph="X"`` complete events, microsecond timebase) for
  https://ui.perfetto.dev or ``chrome://tracing``.
* :func:`write_prometheus` — the registry's Prometheus text.
* :func:`run_manifest` — the reproducibility sidecar beside the fit
  JSONL: config hash, ``plan.describe()``, git sha, and the torch / CUDA
  versions, device name and count (where the reference names jax, its
  backend and its device count).
* :func:`validate_chrome_trace` / :func:`validate_round_jsonl` /
  :func:`check_trace_dir` — the schema checks run against the artifacts
  (``python -m repro_torch.telemetry.export --check DIR``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
from typing import Any

import torch

# ---------------------------------------------------------------------------
# Perfetto / Chrome trace-event JSON
# ---------------------------------------------------------------------------


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def perfetto_trace(tracer, *, extra: dict | None = None) -> dict:
    """A Tracer's finished spans as a Chrome trace-event object: one
    ``ph="X"`` event per span, ``ts``/``dur`` in microseconds from the
    tracer's origin, thread ids compacted to small ints."""
    tids: dict[int, int] = {}
    events = []
    pid = os.getpid()
    for sp in tracer.spans:
        if sp.dur_s is None:
            continue                       # still open / null span
        tid = tids.setdefault(sp.tid, len(tids))
        events.append({
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": sp.ts_s * 1e6, "dur": sp.dur_s * 1e6,
            "pid": pid, "tid": tid,
            "args": _jsonable(sp.attrs),
        })
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if extra:
        out["otherData"] = _jsonable(extra)
    return out


def write_perfetto(path: str, tracer, *, extra: dict | None = None) -> dict:
    obj = perfetto_trace(tracer, extra=extra)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return obj


def write_prometheus(path: str, registry) -> str:
    text = registry.exposition()
    with open(path, "w") as f:
        f.write(text)
    return text


# ---------------------------------------------------------------------------
# Run manifest
# ---------------------------------------------------------------------------

def _git_sha() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def config_hash(run) -> str:
    """Stable short hash of the full RunConfig tree (the reference's
    function: the same run hashes the same in both packages)."""
    blob = json.dumps(dataclasses.asdict(run), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def run_manifest(run=None, *, plan=None, device=None,
                 extra: dict | None = None) -> dict:
    """The reproducibility sidecar for one traced run.  ``device`` is the
    torch device the run trained on (default: the card if there is one,
    else the CPU)."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    on_card = dev.type == "cuda"
    m: dict = {
        "schema": "repro_torch.run_manifest/1",
        "git_sha": _git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "device": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "device_count": torch.cuda.device_count() if on_card else 1,
    }
    if run is not None:
        m["config_hash"] = config_hash(run)
        m["model"] = run.model.name
        m["steps"] = run.steps
        m["local_sgd"] = dataclasses.asdict(run.local_sgd)
        m["controller"] = dataclasses.asdict(run.controller)
    if plan is not None:
        m["plan"] = {
            "describe": plan.describe(),
            "topology": plan.topology.describe(),
            "modes": list(plan.modes),
            "num_buckets": plan.num_buckets,
            "num_workers": plan.num_workers,
            "coalesce": plan.coalesce,
            "wire_pack": plan.wire_pack,
        }
    if extra:
        m.update(_jsonable(extra))
    return m


def write_run_manifest(path: str, **kw) -> dict:
    m = run_manifest(**kw)
    with open(path, "w") as f:
        json.dump(m, f, indent=1, default=str)
    return m


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

def validate_chrome_trace(obj) -> list[str]:
    """Check a dict against the Chrome trace-event subset we emit.
    Returns a list of problems (empty = valid)."""
    errs = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    ev = obj.get("traceEvents")
    if not isinstance(ev, list):
        return ["missing/invalid 'traceEvents' list"]
    for i, e in enumerate(ev):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                errs.append(f"{where}: missing '{k}'")
        if not isinstance(e.get("name"), str):
            errs.append(f"{where}: 'name' must be a string")
        for k in ("ts", "dur"):
            if k in e and not isinstance(e[k], (int, float)):
                errs.append(f"{where}: '{k}' must be a number")
        if e.get("ph") == "X":
            if "dur" not in e:
                errs.append(f"{where}: complete event missing 'dur'")
            elif e["dur"] < 0:
                errs.append(f"{where}: negative 'dur'")
        if "args" in e and not isinstance(e["args"], dict):
            errs.append(f"{where}: 'args' must be an object")
    return errs


# the fit JSONL schema: one record per global sync round
JSONL_REQUIRED = ("round", "step", "h", "loss", "wire_bytes", "collectives",
                  "cum_wire_bytes", "next_h", "next_compression",
                  "next_batch_scale", "next_lr_scale", "topology")
# present iff the run was traced (the seconds extension)
JSONL_TRACED = ("round_s", "sync_s", "stage_s")


def validate_round_jsonl(lines, *, traced: bool | None = None) -> list[str]:
    """Validate fit telemetry JSONL records against the schema.
    ``traced=True`` also requires the ``*_s`` timing fields; ``None``
    decides from the first record."""
    errs = []
    recs = []
    for i, ln in enumerate(lines):
        ln = ln.strip()
        if not ln:
            continue
        try:
            recs.append((i, json.loads(ln)))
        except json.JSONDecodeError as e:
            errs.append(f"line {i}: not JSON ({e})")
    if traced is None:
        traced = bool(recs) and "round_s" in recs[0][1]
    for i, r in recs:
        for k in JSONL_REQUIRED:
            if k not in r:
                errs.append(f"line {i}: missing '{k}'")
        if traced:
            for k in JSONL_TRACED:
                if k not in r:
                    errs.append(f"line {i}: traced run missing '{k}'")
            if "stage_s" in r:
                st = r["stage_s"]
                if not isinstance(st, dict) or not all(
                        isinstance(v, (int, float)) for v in st.values()):
                    errs.append(f"line {i}: 'stage_s' must map stage id -> "
                                "seconds")
        for k in ("loss", "wire_bytes", "cum_wire_bytes", "next_lr_scale"):
            if k in r and not isinstance(r[k], (int, float)):
                errs.append(f"line {i}: '{k}' must be a number")
    return errs


MANIFEST_REQUIRED = ("schema", "torch", "device", "config_hash", "plan")


def check_trace_dir(path: str) -> list[str]:
    """Validate a ``--trace-dir`` directory: trace.json against the Chrome
    schema, telemetry.jsonl against the traced JSONL schema, manifest.json
    for the required fields."""
    errs = []
    tj = os.path.join(path, "trace.json")
    if os.path.exists(tj):
        with open(tj) as f:
            obj = json.load(f)
        errs += [f"trace.json: {e}" for e in validate_chrome_trace(obj)]
        if not obj.get("traceEvents"):
            errs.append("trace.json: no events recorded")
    else:
        errs.append("trace.json missing")
    jl = os.path.join(path, "telemetry.jsonl")
    if os.path.exists(jl):
        with open(jl) as f:
            errs += [f"telemetry.jsonl: {e}"
                     for e in validate_round_jsonl(f, traced=True)]
    else:
        errs.append("telemetry.jsonl missing")
    mf = os.path.join(path, "manifest.json")
    if os.path.exists(mf):
        with open(mf) as f:
            m = json.load(f)
        for k in MANIFEST_REQUIRED:
            if k not in m:
                errs.append(f"manifest.json: missing '{k}'")
    else:
        errs.append("manifest.json missing")
    return errs


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="validate traced-run artifacts")
    ap.add_argument("--check", metavar="DIR",
                    help="validate a launch.train --trace-dir directory")
    args = ap.parse_args(argv)
    if args.check:
        errs = check_trace_dir(args.check)
        for e in errs:
            print(f"SCHEMA ERROR: {e}")
        if not errs:
            print(f"{args.check}: trace + jsonl + manifest valid")
        return 1 if errs else 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
