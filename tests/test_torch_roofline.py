"""Port parity: the roofline and collective census (``repro_torch.roofline``,
``launch.mesh``, the grid functions of ``sharding.layout``) against the
reference's ``repro.roofline`` and ``repro.sharding.layout``.

* ``analysis``: every count equals the reference's for every registry
  arch and paper-lm at every ``INPUT_SHAPES`` entry, with ``==``; the
  times equal the reference's rescaled by the ratio of the card's
  constants to the TPU's (rtol 1e-12), and ``dominant`` is the largest
  rescaled term.  ``report.build_rows`` with no dry-run records equals
  the reference's rows field for field, rescaled the same way.
* ``hlo``: ``_ring_bytes`` equals the reference's; ``parse_collectives``
  on synthetic profiler records, and on 2 ``gloo`` ranks of a profiled
  ``Collectives`` run, where the bytes handed to each single-call
  collective equal ``Collectives``' measured bytes and the ordered mean's
  sends its ``sent``.
* ``op_counts`` on the reference's census config (the MLP of
  ``tests/_bucket_sync_probe.py``): the kernel launches of a local step
  and of a sync equal the reference's ``pallas_call`` counts, resident
  and with telemetry; the resident step dispatches no ``cat`` /
  ``constant_pad_nd`` between syncs.
* ``layout``: ``choose_worker_axes`` / ``param_bytes_per_chip`` equal the
  reference's at the reference's arguments on both production grids.
* ``sync_probe``: the five rows on 2 ``gloo`` ranks at smoke width.
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.launch import mesh as jmesh
from repro.roofline import analysis as ja
from repro.roofline import hlo as jhlo
from repro.roofline import report as jreport
from repro.sharding import layout as jlayout
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.launch import mesh as tmesh
from repro_torch.roofline import analysis as ta
from repro_torch.roofline import hlo as thlo
from repro_torch.roofline import report as treport
from repro_torch.sharding import layout as tlayout

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tuple(tconfigs.ARCHS) + ("paper-lm",)
SHAPES = tuple(tcb.INPUT_SHAPES)
# the card's times are the TPU's times x these (same counts, other rates)
SCALE = {"t_compute": jmesh.PEAK_FLOPS_BF16 / tmesh.PEAK_FLOPS_BF16,
         "t_memory": jmesh.HBM_BW / tmesh.HBM_BW,
         "t_collective": jmesh.ICI_BW / tmesh.NVLINK_BW}
COUNT_FIELDS = ("arch", "shape", "kind", "flops_device", "bytes_device",
                "coll_bytes_device", "model_flops", "hlo_flops_total", "notes")


def _close(a, b, rtol=1e-12):
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-300)


def _rooflines(arch, shape_name):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    js, ts = jcb.INPUT_SHAPES[shape_name], tcb.INPUT_SHAPES[shape_name]
    if js.kind == "train":
        return [(ja.train_roofline(jcfg, js, num_workers=16, **kw),
                 ta.train_roofline(tcfg, ts, num_workers=16, **kw))
                for kw in ({}, {"H": 4, "sync_coll_bytes": 123456789.0})]
    return [(ja.serve_roofline(jcfg, js, kind=js.kind),
             ta.serve_roofline(tcfg, ts, kind=ts.kind))]


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_counts_equal_reference(arch, shape_name):
    """Every analytic count of the port equals the reference's, exactly;
    the times are the reference's over the card's rates."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shape = tcb.INPUT_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    assert ta.banded_area(S, tcfg.sliding_window) == ja.banded_area(
        S, jcfg.sliding_window)
    assert ta.forward_flops(tcfg, B, S) == ja.forward_flops(jcfg, B, S)
    assert ta.forward_flops(tcfg, B, 1, decode_cache=S) == ja.forward_flops(
        jcfg, B, 1, decode_cache=S)
    assert ta.num_params(tcfg) == ja.num_params(jcfg)
    assert ta.active_params(tcfg) == ja.active_params(jcfg)
    assert ta.cfg_moe_layers(tcfg) == ja.cfg_moe_layers(jcfg)
    assert ta.kv_cache_bytes(tcfg, B, S) == ja.kv_cache_bytes(jcfg, B, S)
    for jr, tr in _rooflines(arch, shape_name):
        for f in COUNT_FIELDS:
            assert getattr(tr, f) == getattr(jr, f), f
        terms = {}
        for f, k in SCALE.items():
            assert _close(getattr(tr, f), getattr(jr, f) * k), f
            terms[f[2:]] = getattr(tr, f)
        assert tr.dominant == max(terms, key=terms.get)


def test_banded_area_and_constants():
    for S, w in ((4, 0), (4, 2), (8, 8), (8, 100), (4096, 512), (1, 0)):
        assert ta.banded_area(S, w) == ja.banded_area(S, w)
    assert ta.banded_area(4, 2) == 3 + 2 * 2
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_TF32, tmesh.PEAK_FLOPS_F32,
            tmesh.HBM_BW, tmesh.NVLINK_BW) == (989e12, 495e12, 67e12, 3.35e12,
                                               450e9)
    assert tmesh.card_rates("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12,
                                                         989e12, 495e12)
    assert tmesh.card_rates("NVIDIA H100 PCIe")[0] == 2.0e12


def test_report_rows_equal_reference_without_records(tmp_path, monkeypatch):
    """``build_rows`` with no dry-run record: the reference's rows field for
    field, its times rescaled to the card's rates."""
    monkeypatch.setattr(jreport, "DRYRUN", str(tmp_path))
    jrows = jreport.build_rows()
    trows = treport.build_rows(dryrun=tmp_path)
    assert len(trows) == len(jrows) == len(tconfigs.runnable_pairs())
    for jr, tr in zip(jrows, trows):
        assert set(tr) == set(jr)
        for k in ("arch", "shape", "kind", "model_flops_per_dev",
                  "flops_per_dev", "useful_ratio", "notes"):
            assert tr[k] == jr[k], k
        for f, s in SCALE.items():
            assert _close(tr[f + "_s"], jr[f + "_s"] * s), f
        assert tr["improve"] == treport.IMPROVE[tr["dominant"]]


def test_report_reads_dryrun_records(tmp_path):
    """A record's W and sync bytes reach the train row; its peak and
    FLOPs are reported beside it."""
    from repro_torch.roofline import experiments_md
    rec = {"arch": "gemma3-1b", "shape": "train_4k", "kind": "train",
           "num_workers": 8, "local_step": {"flops": 5.0e14, "trace_s": 1.0,
                                            "collectives": {"moved_bytes": 0.0}},
           "sync": {"collectives": {"moved_bytes": 2.0e9}},
           "per_card": {"peak_bytes": 6.0e10, "fits": True, "max_layers": 26}}
    (tmp_path / "gemma3-1b__train_4k__16x16.json").write_text(json.dumps(rec))
    rows = treport.build_rows(dryrun=tmp_path)
    row = next(r for r in rows if (r["arch"], r["shape"]) ==
               ("gemma3-1b", "train_4k"))
    want = ta.train_roofline(tconfigs.get("gemma3-1b"),
                             tcb.INPUT_SHAPES["train_4k"], num_workers=8,
                             sync_coll_bytes=2.0e9)
    assert row["notes"] == "K=8, H=8"
    assert row["t_collective_s"] == want.t_collective
    assert row["dryrun_peak_gb"] == 60.0 and row["dryrun_fits"]
    table = experiments_md.dryrun_table("16x16", tmp_path)
    assert "| gemma3-1b | train_4k | train | 1.0 | 500000 | 60.00 | yes |" in table
    assert table.count("MISSING") == len(tconfigs.runnable_pairs()) - 1


# ---------------------------------------------------------------------------
# hlo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 16, 256])
@pytest.mark.parametrize("op", list(jhlo.COLLECTIVES) + ["broadcast"])
def test_ring_bytes_equal_reference(op, n):
    for b in (0, 1, 100, 478_228_480):
        assert thlo._ring_bytes(op, b, n) == jhlo._ring_bytes(op, b, n)


def test_parse_collectives_synthetic_records():
    """c10d records open calls; the backend record after each carries the
    handed tensors; a receive is left out; ``_allgather_base_`` reads its
    own input."""
    ev = [("c10d::allreduce_", 0, [[], []], ["TensorList", ""]),
          ("gloo:all_reduce", 1, [[1000]], ["float"]),
          ("c10d::allgather_", 2, [[], []], ["", "TensorList"]),
          ("gloo:all_gather", 3, [[16, 8]], ["unsigned char"]),
          ("c10d::_allgather_base_", 4, [[2000], [1000]], ["float", "float"]),
          ("gloo:all_gather", 5, [[1000]], ["float"]),
          ("c10d::send", 6, [[]], ["TensorList"]),
          ("gloo:send", 7, [[300]], ["c10::BFloat16"]),
          ("c10d::recv_", 8, [[]], ["TensorList"]),
          ("gloo:recv", 9, [[300]], ["float"]),
          ("c10d::broadcast_", 10, [[]], ["TensorList"]),
          ("gloo:broadcast", 11, [[5]], ["float"]),
          ("aten::add", 12, [[3], [3]], ["float", "float"])]
    s = thlo.parse_collectives(ev, group_size=4, pod_size=2)
    assert [(o.op, o.handed_bytes, o.result_bytes) for o in s.ops] == [
        ("all-reduce", 4000, 4000), ("all-gather", 128, 512),
        ("all-gather", 4000, 16000), ("collective-permute", 600, 600),
        ("broadcast", 20, 20)]
    assert s.count() == 5 and all(o.crosses_pod for o in s.ops)
    assert s.total_bytes() == 1.5 * 4000 + 0.75 * 512 + 0.75 * 16000 + 600 + 20
    assert s.handed_by_op() == {"all-reduce": 4000, "all-gather": 4128,
                                "collective-permute": 600, "broadcast": 20}
    assert thlo.parse_collectives(ev, group_size=4).total_bytes(
        cross_pod=True) == 0.0


_COLLECTIVES_SCRIPT = textwrap.dedent('''
    import json, socket, sys
    import torch, torch.distributed as dist, torch.multiprocessing as mp
    from repro_torch.backend.collectives import Collectives
    from repro_torch.roofline.hlo import parse_collectives, profile_records
    from repro_torch.sharding.layout import WorkerLayout

    def rank(r, port, out):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=r, world_size=2)
        col = Collectives(WorkerLayout(4, 2, r))
        x = torch.arange(2 * 3000, dtype=torch.float32).reshape(2, 3000) + r
        with torch.profiler.profile(record_shapes=True) as prof:
            col.all_gather(x[0, :700].to(torch.uint8), scope="global")
            col.broadcast(x[0, :40].clone(), 0, scope="global")
            col.ordered_mean(x, scope="global")
            col.gather_ranks(x[:, :100], scope="checkpoint")
        s = parse_collectives(profile_records(prof), group_size=2)
        json.dump({"handed": s.handed_by_op(), "count": s.count(),
                   "ring": s.total_bytes(),
                   "totals": col.totals, "sent": col.sent},
                  open(f"{out}/rank{r}.json", "w"))
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        mp.spawn(rank, args=(port, sys.argv[1]), nprocs=2)
''')


def test_parse_collectives_equal_collectives_counts(tmp_path):
    """On 2 ``gloo`` ranks: what the trace says each call was handed equals
    what ``Collectives`` counted (its measured bytes) for the single-call
    ops, and the ordered mean's traced sends equal ``Collectives.sent``."""
    script = tmp_path / "spawn.py"
    script.write_text(_COLLECTIVES_SCRIPT)
    res = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        tot = {k.split("/")[0]: v["bytes"] for k, v in got["totals"].items()}
        h = got["handed"]
        assert h["all-gather"] == tot["all_gather"] == 700
        assert h["broadcast"] == tot["broadcast"] == 160
        assert h["gather"] == tot["gather"] == 800
        assert h["collective-permute"] == got["sent"]["ordered_mean/global"]
        # the chain: rank 0 sends its partial, rank 1 the result back
        assert h["collective-permute"] == 3000 * 4
        assert got["count"] == 4


# ---------------------------------------------------------------------------
# op census
# ---------------------------------------------------------------------------

def _census_run(cb, W=4):
    """The reference's census config (``tests/_bucket_sync_probe.py``)."""
    return cb.RunConfig(
        model=cb.ModelConfig(name="probe", family="dense", citation=""),
        shape=cb.InputShape("t", 8, W * 4, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, sync_compression="sign",
                                    wire_pack=True, local_momentum=0.9,
                                    nesterov=True),
        optim=cb.OptimConfig(base_lr=0.05, base_batch=W * 4, weight_decay=1e-3,
                             grad_clip=0.5, lr_decay_steps=()))


def _reference_census(telemetry: bool):
    from repro.core.local_sgd import make_local_sgd
    W = 4

    def loss(p, b):
        pred = jnp.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"]
        l = jnp.mean((pred - b["y"]) ** 2)
        return l, {"xent": l}

    init, local_step, sync = make_local_sgd(
        _census_run(jcb), loss, num_workers=W,
        wd_mask={"w1": False, "b1": True, "w2": False}, use_kernel=True,
        resident=True, telemetry=telemetry)
    params = {"w1": jax.ShapeDtypeStruct((6, 5), jnp.float32),
              "b1": jax.ShapeDtypeStruct((5,), jnp.float32),
              "w2": jax.ShapeDtypeStruct((5, 2), jnp.float32)}
    batch = {"x": jax.ShapeDtypeStruct((W, 4, 6), jnp.float32),
             "y": jax.ShapeDtypeStruct((W, 4, 2), jnp.float32)}
    state = jax.eval_shape(init, jax.random.PRNGKey(0), params)
    return (jhlo.jaxpr_op_counts(jax.make_jaxpr(local_step)(state, batch)),
            jhlo.jaxpr_op_counts(jax.make_jaxpr(lambda s: sync(s))(state)))


@pytest.mark.parametrize("telemetry", [False, True])
def test_op_counts_census_equals_reference(telemetry):
    """One local step and one sync of the census MLP: the port's launches
    of the TPU kernels' ports equal the reference's ``pallas_call`` count
    in each, and the resident step packs nothing (no ``cat`` /
    ``constant_pad_nd``) between syncs.  The wire-packed sync launches
    ``row_abs_sum`` once more a bucket than the reference's kernels: the
    reference's pack takes its per-leaf scales' row sums with plain jnp
    ops (``repro.core.compression.pack_bucket_signs``), the port's with
    kernel 3, the compressor's own row sums (``PERF.md`` section 3)."""
    from repro_torch.core.local_sgd import make_local_sgd
    from repro_torch.kernels import fused_bucket as fb
    W = 4

    def loss(p, b):
        pred = torch.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"]
        l = torch.mean((pred - b["y"]) ** 2)
        return l, {"xent": l}

    init, local_step, sync = make_local_sgd(
        _census_run(tcb), loss, num_workers=W,
        wd_mask={"w1": False, "b1": True, "w2": False}, telemetry=telemetry)
    g = torch.Generator().manual_seed(0)
    state = init({"w1": torch.randn(6, 5, generator=g),
                  "b1": torch.randn(5, generator=g),
                  "w2": torch.randn(5, 2, generator=g)})
    batch = {"x": torch.randn(W, 4, 6, generator=g),
             "y": torch.randn(W, 4, 2, generator=g)}
    step_counts = thlo.op_counts(local_step, state, batch)
    state, _ = local_step(state, batch)
    # the first sync builds each bucket's segment index (a few tiny ops,
    # cached per bucket and device); the census takes the next one
    state = sync(state)
    sync_counts = thlo.op_counts(lambda s: sync(s), state)
    jstep, jsync = _reference_census(telemetry)
    kernels = lambda c: sum(c.get(k, 0) for k in fb.LAUNCHES)
    assert kernels(step_counts) == jstep["pallas_call"] == 2
    packed_buckets = 1
    assert kernels(sync_counts) - packed_buckets == jsync["pallas_call"] == 2
    assert (sync_counts["row_abs_sum"], sync_counts["scale_sign_rows"]) == (2, 1)
    assert sync_counts["segment_sum"] == jsync["scatter-add"] == 2
    assert step_counts["fused_sgd_bucket"] == step_counts["sq_sum"] == 1
    for counts in (step_counts, sync_counts):
        assert counts.get("cat", 0) == 0 and counts.get("constant_pad_nd", 0) == 0
    # the kernels are leaves: no plain version's op is counted inside them
    assert "abs" not in step_counts


def test_op_counts_tree_kernel_form_packs():
    """The tree-in/tree-out kernel form (``resident=False``) pays the pack
    the resident path removes: ``flatbuf.flatten`` fills a zeroed buffer a
    bucket (``zeros``) and writes each leaf into it (``copy_``), for p, g
    and u every step; the resident step allocates none (its one
    ``zeros_like`` is the gradient buckets the workers' gradients land
    in)."""
    from repro_torch.core.local_sgd import make_local_sgd

    def loss(p, b):
        l = torch.mean((torch.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"]
                        - b["y"]) ** 2)
        return l, {"xent": l}

    out = {}
    for resident in (True, False):
        init, local_step, _ = make_local_sgd(_census_run(tcb), loss,
                                             num_workers=4, resident=resident)
        g = torch.Generator().manual_seed(0)
        state = init({"w1": torch.randn(6, 5, generator=g),
                      "b1": torch.randn(5, generator=g),
                      "w2": torch.randn(5, 2, generator=g)})
        batch = {"x": torch.randn(4, 4, 6, generator=g),
                 "y": torch.randn(4, 4, 2, generator=g)}
        out[resident] = thlo.op_counts(local_step, state, batch)
    assert out[False]["zeros"] == 3 and out[False]["copy_"] >= 9
    assert "zeros" not in out[True] and out[True]["zeros_like"] == 1
    for c in out.values():
        assert (c["fused_sgd_bucket"], c["sq_sum"]) == (1, 1)


def test_kernel_leaves_cover_every_counter():
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import sign_compress as sc
    from repro_torch.kernels import flash_attention as fa
    assert set(thlo.kernel_names()) == (set(fb.LAUNCHES) | set(fb.PORT_LAUNCHES)
                                        | set(fs.LAUNCHES) | set(sc.LAUNCHES)
                                        | set(fa.LAUNCHES))
    from repro_torch.kernels import ops
    q = torch.randn(1, 8, 2, 16)
    # resolved at call time: the census wraps the module attribute
    c = thlo.op_counts(lambda: ops.flash_attention(q, q, q))
    assert c == {"flash_attention_bhsd": 1}
    assert ops.flash_attention is fa.flash_attention     # restored


# ---------------------------------------------------------------------------
# layout on a grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_choose_worker_axes_equal_reference(arch, multi_pod):
    """At the reference's arguments (6 bytes a param, 13e9 of a 16 GB
    chip) the port's choice equals the reference's on the same grid; the
    port's defaults (f32 weight, momentum, gradient; the card's 60e9)."""
    grid = tmesh.make_production_grid(multi_pod=multi_pod)
    mesh = types.SimpleNamespace(axis_names=grid.axis_names, shape=grid.shape)
    n = ta.num_params(tconfigs.get(arch))
    assert tlayout.choose_worker_axes(grid, n, bytes_per_param=6,
                                      hbm_budget=13e9) == \
        jlayout.choose_worker_axes(mesh, n)
    assert tlayout.choose_worker_axes(grid, n) == jlayout.choose_worker_axes(
        mesh, n, bytes_per_param=12, hbm_budget=60e9)
    assert tlayout.param_bytes_per_chip(n, bytes_per_param=12,
                                        chips_per_worker=16) == \
        jlayout.param_bytes_per_chip(n, bytes_per_param=12, chips_per_worker=16)
    assert grid.size == (512 if multi_pod else 256)


# ---------------------------------------------------------------------------
# sync probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sync_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("sync_probe")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.sync_probe", "--arch",
         "paper-lm", "--ranks", "2", "--smoke", "--device", "cpu", "--seq",
         "32", "--local-batch", "2", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    ranks = [json.loads((out / "sync__paper-lm_ranks" / f"rank{r}.json")
                        .read_text()) for r in range(2)]
    assert json.loads((out / "sync__paper-lm.json").read_text()) == ranks[0]
    return ranks


@pytest.mark.parametrize("row", range(5))
def test_sync_probe_rows(sync_rows, row):
    """Each of the reference's five rows on 2 ranks: the traced bytes
    equal the counted ones on both ranks; the wire-packed rows gather
    (uint8 payload, f32 scales) and move 1/16 or less of the dense rows'
    ring bytes; a dense row is the ordered mean's chain."""
    from repro_torch.roofline.sync_probe import ROWS
    comp, pack, bucket = ROWS[row]
    for rk in sync_rows:
        r = rk[row]
        assert (r["compression"], r["wire_pack"], r["bucket_sync"]) == ROWS[row]
        assert r["held_equal"], r["held"]
        assert r["workers"] == 2 and r["ranks"] == 2
        assert r["ledger_measured_bytes"] and r["ring_model_collectives"] >= 1
        if pack:
            assert "all-gather" in r["handed_by_op"]
            assert "collective-permute" not in r["handed_by_op"]
            assert r["ring_model_bytes"] * 16 <= sync_rows[0][1]["ring_model_bytes"]
        else:
            assert r["handed_by_op"]["collective-permute"] > 0
            assert r["collectives_sent"]["ordered_mean"] == \
                r["handed_by_op"]["collective-permute"]
    if comp == "none":
        # one f32 bucket a rank handed, whatever the form
        assert sync_rows[0][row]["ledger_measured_bytes"] == \
            sync_rows[0][1]["ledger_measured_bytes"]
