"""Run one cell of the benchmark and print its result line.

    python3 lsgd_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with an NVIDIA card.  Set-up builds the
port's training bundle for the cell's configuration and traffic mix,
makes the weights and the token stream on the card from the seed, and
drives the bundle through its first steps, reading what the comparison
needs.  The window then runs local steps, with a global sync where the
schedule puts one, for ``--seconds`` (``--trace 0``), or (``--trace 1``)
over whole sync periods, once untraced for their wall time and once
more under ``torch.profiler``, with no host sync inside.  Once it has closed, the program is freed and the plain
reference follows the same first steps on the same weights and tokens;
the numbers compared, each beside its limit, end standard error and the
result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "lsgd_bench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from lsgd_bench import check, data, flops, program, trace, weights  # noqa: E402
from lsgd_bench.reference import lm as ref_lm  # noqa: E402
from lsgd_bench.reference import train as ref_train  # noqa: E402

CHECKED_STEPS = 3           # the first steps the reference follows
TRACE_MIN_STEPS = 16        # a traced window: whole sync periods, >= this
BENCH_RANGES = ("bench.local_step", "bench.sync")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Failure(Exception):
    """A run that cannot give a result: no result line, exit code 1."""


# ---------------------------------------------------------------------------
# the cell's files, found by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, cell: str, root: Path = ROOT) -> dict:
    """The workload entry, configuration, traffic mix and limits of
    ``cell``; the end-to-end and per-layer metric entries it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise Failure(f"unknown workload {cell!r}; the cells are {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise Failure(f"{cell}: unknown config {w['config']!r}")
    reports = lambda m: "workloads" not in m or cell in m["workloads"]
    return {"workload": w,
            "config": load_json(root / configs[w["config"]]["file"]),
            "traffic": load_json(root / "lsgd_bench" / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(root / "lsgd_bench" / "limits" / f"{cell}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def metric_reader(name: str, root: Path = ROOT):
    path = root / "lsgd_bench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise Failure(f"no reader for the per-layer metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"lsgd_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------------

def device_sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def local_step(bundle, state, batch):
    with torch.profiler.record_function("bench.local_step"):
        return bundle.local_step(state, batch)


def global_sync(bundle, state):
    with torch.profiler.record_function("bench.sync"):
        return bundle.sync(state, plan=bundle.sync_plan, scope="global")


def sync_after(traffic) -> list:
    """Whether a global sync follows each checked step: where the schedule
    puts one, and after the last (the set-up's one sync)."""
    H = traffic["local_steps"]
    return [(t + 1) % H == 0 or t == CHECKED_STEPS - 1
            for t in range(CHECKED_STEPS)]


def _worker_norms(x, base=None, scale: float = 1.0):
    """(W,) norms of x[w] - scale * base for each worker w."""
    if base is None:
        return torch.stack([r.float().norm() for r in x])
    return torch.stack([(r.float() - scale * base).norm() for r in x])


def first_grad(state, shapes, w0, traffic) -> dict:
    """The first step's gradient as the optimizer got it (after the clip),
    from the momentum after one step: u = g + wd * p0 on decayed weights."""
    wd = traffic["weight_decay"]
    mom = program.leaves(state.momentum)
    return {n: _worker_norms(mom[n], w0[n] if ref_train.decays(shapes[n]) else None,
                             wd) for n in shapes}


def setup(cfg, traffic, seed: int, device, tamper=None):
    """Build the bundle, make the weights and batches, and drive the first
    steps through the window's own calls and feed.  Returns (bundle,
    state, batches, readings); ``tamper(bundle)``, where given, breaks
    the timed path before any step (tests and the fault readings)."""
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 as stated
    torch.backends.cudnn.allow_tf32 = False
    bundle = program.build(cfg, traffic, device)
    shapes = ref_lm.param_shapes(cfg)
    got = program.spec_shapes(bundle)
    if got != shapes:
        raise Failure(f"the program's parameters {sorted(got.items())} are not "
                      f"the configuration's {sorted(shapes.items())}")
    state = bundle.init(program.tree_of(bundle, weights.make(shapes, seed, device)),
                        seed=seed)
    bats = data.batches(cfg, traffic, seed, device)
    if tamper is not None:
        tamper(bundle)
    readings = {"loss": []}
    for t, sync in enumerate(sync_after(traffic)):
        state, m = local_step(bundle, state, bats[t])
        readings["loss"].append(m["loss"].detach())
        if t == 0:
            w0 = weights.make(shapes, seed, device)
            readings["grad"] = first_grad(state, shapes, w0, traffic)
            del w0
        if sync:
            state = global_sync(bundle, state)
    w0 = weights.make(shapes, seed, device)
    params = program.leaves(state.params)
    readings["change"] = {n: _worker_norms(params[n], w0[n]) for n in shapes}
    del w0, params
    return bundle, state, bats, readings


def window(bundle, state, bats, traffic, *, seconds=None, steps=None,
           device="cuda"):
    """Local steps from batch CHECKED_STEPS on, a global sync after every
    ``local_steps``-th, until ``seconds`` have passed on the host clock
    or ``steps`` have run; ends with a device synchronize.  Returns
    (state, steps, syncs, seconds, last metrics)."""
    H = traffic["local_steps"]
    device_sync(device)
    t0 = time.perf_counter()
    n = syncs = 0
    while True:
        state, m = local_step(bundle, state, bats[(CHECKED_STEPS + n) % len(bats)])
        n += 1
        if n % H == 0:
            state = global_sync(bundle, state)
            syncs += 1
        if steps is not None:
            if n >= steps:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    device_sync(device)
    return state, n, syncs, time.perf_counter() - t0, m


def trace_steps(traffic) -> int:
    """Whole sync periods of at least TRACE_MIN_STEPS steps."""
    H = traffic["local_steps"]
    return H * -(-TRACE_MIN_STEPS // H)


def to_host(readings) -> dict:
    return {"loss": [float(x) for x in readings["loss"]],
            **{k: {n: v.cpu().tolist() for n, v in readings[k].items()}
               for k in ("grad", "change")}}


def reference_readings(cfg, traffic, seed: int, bats, device, *,
                       tf32: bool = False) -> dict:
    """The reference over the first steps, from weights made anew (with
    ``tf32``: the control, its matmuls in TF32)."""
    w0 = weights.make(ref_lm.param_shapes(cfg), seed, device)
    return to_host(ref_train.follow(cfg, traffic, w0, bats[:CHECKED_STEPS],
                                    sync_after(traffic), tf32=tf32))


def forbidden_modules() -> list:
    """JAX, flax and the JAX package among the loaded modules, by whole
    top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(files: dict, cell: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", t_start: float = T_START, tamper=None,
        out_dir: Path = BENCH / "out") -> dict:
    """One run of ``cell``; the result dict (its ``checks`` last)."""
    cfg, traffic, limits = files["config"], files["traffic"], files["limits"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bundle, state, bats, readings = setup(cfg, traffic, seed, device, tamper)
    device_sync(device)
    setup_s = time.perf_counter() - t_start

    W, B, S = traffic["workers"], traffic["local_batch"], traffic["seq_len"]
    prof = None
    if traced:
        # the profiler slows the host (some microseconds an op), so the
        # same steps run first untraced: their wall time is the step's
        from torch.profiler import ProfilerActivity, profile
        state, _, _, wall_s, _ = window(bundle, state, bats, traffic,
                                        steps=trace_steps(traffic), device=device)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            state, n, syncs, dt, last = window(bundle, state, bats, traffic,
                                               steps=trace_steps(traffic),
                                               device=device)
    else:
        state, n, syncs, dt, last = window(bundle, state, bats, traffic,
                                           seconds=seconds, device=device)
    last_loss = float(last["loss"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prog = to_host(readings)
    elements = program.bucket_elements(bundle)
    del state, bundle, readings, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if traced:
        t_reduce = time.perf_counter()
        readers = {m["name"]: metric_reader(m["name"]) for m in files["per_layer"]}
        acts = trace.reduce(prof.profiler.kineto_results.events(),
                            set(BENCH_RANGES) | {r for mod in readers.values()
                                                 for r in getattr(mod, "RANGES", ())})
        out_dir.mkdir(parents=True, exist_ok=True)
        t_export = time.perf_counter()
        prof.export_chrome_trace(str(out_dir / f"{cell}.seed{seed}.trace.json.gz"))
        print(f"trace: {len(acts)} device activities, reduced in "
              f"{t_export - t_reduce:.1f} s, written in "
              f"{time.perf_counter() - t_export:.1f} s", file=sys.stderr)
        win = trace.Window(acts=acts, window_s=dt, wall_s=wall_s, steps=n,
                           syncs=syncs, workers=W,
                           step_flops=W * flops.worker_step_flops(cfg, B, S),
                           bucket_elements=elements)
        for m in files["per_layer"]:
            v = readers[m["name"]].read(win)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"].update(busy_s=win.busy_s(), window_s=dt)
        result["breakdown"] = trace.breakdown(acts)
        del prof, acts, win
    else:
        values = {"tokens_per_s": n * W * B * S / dt,
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        for m in files["end_to_end"]:
            if m["name"] not in values:
                raise Failure(f"no measurement for the end-to-end metric {m['name']!r}")
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}

    nums = check.numbers(prog, reference_readings(cfg, traffic, seed, bats, device))
    ok, failed = check.judge(nums, limits)
    finite = math.isfinite(last_loss)
    names = check.compared(limits)
    result.update(correct=ok and finite, attempted=len(names) + 1,
                  failed=failed + (not finite))
    result["checks"] = {**{k: {"value": nums[k], "limit": limits[k]}
                           for k in names},
                        "window_last_loss": {"value": last_loss, "limit": "finite"}}
    # last, once the readers, the reference and the comparison have run
    found = forbidden_modules()
    if found:
        raise Failure(f"modules loaded in this process: {found}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(ROOT / "BENCHMARK.json")
        files = cell_files(bench, args.workload)
        chips = files["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Failure(f"{args.workload} needs {chips} CUDA device(s); "
                          f"this machine has "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        result = run(files, args.workload, args.seed, args.seconds, bool(args.trace))
    except (Failure, FileNotFoundError, ImportError) as e:
        print(f"lsgd_bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
