"""Port parity: resizes, demotion and checkpoints across
``torch.distributed`` ranks (CPU, ``gloo``), against the port's
one-process run and the reference's ``fit``.

Two spawns, each a subprocess that first runs every run in one process
(one thread, as the ranks have) and then ``mp.spawn``s the ranks:

* P=2 ranks x 2 workers: W 4 -> 2 -> 4 by ``ElasticController(resize_at=
  RESIZE)`` in three variants (mean; EF-sign + ``wire_pack``; LARS +
  EF-sign with telemetry), the EF-sign + wire-pack run with a
  ``checkpoint_fn`` after step ``CKPT_STEP``; then, on the same ranks, the
  snapshot restored at W=4 and the run resumed for its last two steps, the
  snapshot restored at W=2 through the elastic restore, and a resize to
  W'=1 (not a multiple of the 2 worker groups) refused.
* P=4 ranks: 2 worker groups x 2 shard ranks, W 4 -> 2 -> 4 under tensor
  parallel (EF-sign + wire pack, with a checkpoint) and FSDP (mean); 4
  ranks x 1 worker, a straggler demoted (Alg. 5 blocks of 2 that span two
  ranks) and promoted back, its latency modelled equally on every rank
  (``SimulatedDistributedBackend``); and the P=2 snapshot restored on 4
  ranks at W=4.

Checks:

* Every rank holds the same losses, comm rounds, controller decisions and
  ledger; they equal the one-process run's.  Rows against the
  one-process rows: the wire-packed run bit for bit (its gathers add what
  one process adds), the mean runs within 1e-6 of the largest entry
  (momentum 1e-5: an all-reduce sums in another order), the LARS +
  EF-sign run's params and anchor with at most ``FLIP_FRAC`` of their
  elements beyond 1e-6 (the mean of +-scale values rounds in the
  all-reduce's order and a delta within that rounding of 0 flips), as
  ``tests/test_torch_distributed.py`` holds its static runs.  Sharded
  runs: tensor parallel bit for bit, FSDP (half a batch a shard rank)
  within 1e-5.
* The ledger's ``worker_sets``, the resize spans and the LR (x new/old W)
  equal the one-process run's.
* Against the reference's ``fit`` with the same controller (its per-leaf
  bundle under ``jax.jit``, ``_torch_family_runs.jit_builder``, from the
  same weights): losses rtol 2e-4 (its own tolerance for its sharded
  layouts), comm rounds, the sync pattern and the worker sets exact.
* ``publish_flat`` of the worker mean (``mean_params`` across ranks) from
  rank 0 writes the one-process publish's members byte for byte.
* The snapshot ``fit(checkpoint_fn=)`` saves from 2 ranks (and from 2 x 2
  tensor-parallel ranks, whose run is the one-process run's bit for bit)
  holds the one-process snapshot's members, byte for
  byte, and its sidecar; it restores in one process, on 2 ranks at W=2
  (the first two workers, bit for bit), on 4 ranks at W=4, and into the
  reference; a run resumed from it on 2 ranks takes the uninterrupted
  run's losses and ends with its rows, bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.backend.local import LocalBackend as JLocalBackend
from repro.backend.simulated import SimulatedBackend as JSimulatedBackend
from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.core import controller as jctl
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import load_meta, restore_flat
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core.schedule import lr_at
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.sharding import layout as tlayout

from _torch_elastic_variants import (B, CKPT_STEP, DEMOTE_HEAL,
                                     DEMOTE_LATENCY_S, RESIZE, SHARDED,
                                     VARIANTS, W, demote_run, make_data,
                                     make_run, mesh_layout)
from _torch_family_runs import jit_builder

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("params", "momentum", "anchor", "ef_memory")
# share of params / anchor elements a non-wire EF-sign run may move by a
# flip, as tests/test_torch_distributed.py allows its static runs
FLIP_FRAC = 2e-3

_SCRIPT = textwrap.dedent('''
    import dataclasses, json, socket, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, sys.argv[4])
    from _torch_elastic_variants import (
        B, CKPT_STEP, DEMOTE_HEAL, DEMOTE_LATENCY_S, RESIZE, SHARDED,
        SHARD_SIZES, TIMEOUT_S, VARIANTS, W, SimulatedDistributedBackend,
        demote_run, make_data, make_run, mesh_layout)
    from repro_torch import configs
    from repro_torch.backend.distributed import DistributedBackend
    from repro_torch.backend.local import LocalBackend
    from repro_torch.backend.simulated import SimulatedBackend
    from repro_torch.checkpoint.checkpoint import (publish_flat, restore_flat,
                                                   save_flat)
    from repro_torch.configs import base as tcb
    from repro_torch.core.controller import ElasticController
    from repro_torch.core.local_sgd import (local_state, mean_params,
                                            state_template)
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.launch import train as ttrain
    from repro_torch.sharding import layout as tlayout
    from repro_torch.telemetry.stats import round_summary
    from repro_torch.telemetry.trace import Tracer

    FIELDS = ("params", "momentum", "anchor", "ef_memory")
    quiet = lambda *a, **k: None
    smoke = lambda: configs.get_smoke("paper-lm")

    def rows(state, tag):
        out = {}
        for f in FIELDS:
            bs = getattr(state, f)
            if bs is not None:
                for b, x in enumerate(bs.buckets):
                    out[f"{tag}{f}.{b}"] = x.float().numpy().copy()
        return out

    def train(run, params0, backend, *, controller=None, ckpt=None,
              jsonl=None, heal=None):
        tracer = Tracer()
        kw = {}
        if ckpt:
            kw.update(checkpoint_every=CKPT_STEP + 1,
                      checkpoint_fn=lambda st, t: save_flat(ckpt, st, step=t))
        if heal is not None:
            def clear(state):
                backend.latency_s.clear()
                return {}
            kw.update(eval_fn=clear, eval_every=heal)
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(make_data(), W, B), backend=backend,
            params0=params0, controller=controller, tracer=tracer, log=quiet,
            telemetry_path=jsonl, **kw)
        dist = getattr(backend, "collectives", None)
        meta = {"loss": [h["loss"] for h in hist], "lr": [h["lr"] for h in hist],
                "synced": [h["synced"] for h in hist],
                "comm_rounds": summ["comm_rounds"], "resizes": summ["resizes"],
                "topology": summ["topology"], "backend": summ["backend"],
                "decisions": [sp.attrs for sp in tracer.spans
                              if sp.name == "controller"],
                "resize_spans": [[sp.attrs["from_workers"],
                                  sp.attrs["to_workers"]] for sp in tracer.spans
                                 if sp.name == "resize"],
                "ledger": {k: summ["ledger"][k] for k in summ["ledger"]
                           if k not in ("scaling", "sync_seconds")},
                "totals": dist.describe()["totals"] if dist else None}
        if state.stats is not None:
            meta["round_summary"] = round_summary(state.stats, dist=dist)
        return state, rows(state, ""), meta

    def save(out, tag, arrays, meta):
        np.savez(f"{out}/{tag}.npz", **arrays)
        with open(f"{out}/{tag}.json", "w") as f:
            json.dump(meta, f, default=str)

    def elastic(run):
        return ElasticController(run, resize_at=RESIZE)

    def dist_backend(r, port, P, **kw):
        return DistributedBackend(W, backend="gloo", device="cpu",
                                  coordinator_address=f"localhost:{port}",
                                  process_id=r, num_processes=P,
                                  timeout_s=TIMEOUT_S, **kw)

    def replay(run, upto):
        """The data iterator of the uninterrupted run after ``upto`` steps
        (it was resized at each resize round's sync)."""
        it = ShardedBatches(make_data(), W, B)
        w, t, rounds = W, 0, 0
        sched = [t for t in range(upto)]
        from repro_torch.core.schedule import DynamicSchedule, local_steps_at
        ds = DynamicSchedule(run.local_sgd,
                             lambda s: local_steps_at(run.local_sgd, s))
        for t in range(upto):
            next(it)
            if ds.advance(t) == 2:
                rounds += 1
                if rounds in RESIZE:
                    it.resize(RESIZE[rounds])
        return it

    def restored(backend, run, params0, path, device="cpu"):
        bundle = backend.build(run)
        st = bundle.init(params0)
        full = restore_flat(path, state_template(st, bundle.dist))
        return bundle, local_state(full, bundle.dist, device)

    def rank2(r, port, out, params0):
        torch.set_num_threads(1)
        import torch.distributed as dist
        try:
            for name in VARIANTS:
                run = make_run(tcb, smoke(), name)
                be = dist_backend(r, port, 2)
                ckpt = f"{out}/ckpt" if name == "ef_sign_wire" else None
                state, arrays, meta = train(run, params0, be,
                                            controller=elastic(run), ckpt=ckpt)
                if name == "ef_sign_wire":
                    # the worker mean, published from rank 0
                    params = mean_params(state, be.collectives)
                    if r == 0:
                        publish_flat(f"{out}/pub", params, step=run.steps)
                    dist.barrier()
                    # resume the last two steps from the snapshot at W=4
                    bundle, st = restored(be, run, params0, ckpt + ".npz")
                    arrays.update(rows(st, "restored."))
                    it = replay(run, CKPT_STEP + 1)
                    meta["resumed_loss"] = []
                    for t in range(CKPT_STEP + 1, run.steps):
                        st, m = bundle.local_step(st, next(it))
                        meta["resumed_loss"].append(float(m["loss"]))
                    st = bundle.sync(st, plan=bundle.sync_plan, scope="global")
                    arrays.update(rows(st, "resumed."))
                    # the elastic restore at W=2 on the same ranks
                    be.resize(run, 2)
                    _, st2 = restored(be, run, params0, ckpt + ".npz")
                    arrays.update(rows(st2, "w2."))
                save(out, f"r{r}.{name}", arrays, meta)
            # a checkpoint of a noisy run over two worker groups: refused
            # before any step (the snapshot holds group 0's stream only)
            run = make_run(tcb, smoke(), "mean", steps=2)
            run = dataclasses.replace(run, optim=dataclasses.replace(
                run.optim, noise_eta=0.01))
            try:
                train(run, params0, dist_backend(r, port, 2),
                      ckpt=f"{out}/noisy")
                got = "no error"
            except ValueError as e:
                got = str(e)
            save(out, f"r{r}.noisy", {}, {"error": got})
            # a width the two worker groups cannot take: refused first
            run = make_run(tcb, smoke(), "mean", steps=2)
            be = dist_backend(r, port, 2)
            try:
                train(run, params0, be, controller=ElasticController(
                    run, resize_at={1: 1}))
                got = "no error"
            except ValueError as e:
                got = str(e)
            save(out, f"r{r}.refused", {}, {
                "error": got, "census": list(be.worker_set.ids),
                "resizes": None})
        finally:
            dist.destroy_process_group()

    def rank4(r, port, out, params0, p2_ckpt):
        torch.set_num_threads(1)
        import torch.distributed as dist
        try:
            for kind, name in SHARDED:
                run = make_run(tcb, smoke(), name)
                be = dist_backend(r, port, 4, within_worker_size=2,
                                  layout=mesh_layout(tlayout, kind))
                ckpt = f"{out}/ckpt_{kind}" if kind == "tp" else None
                _, arrays, meta = train(run, params0, be,
                                        controller=elastic(run), ckpt=ckpt)
                save(out, f"r{r}.{kind}.{name}", arrays, meta)
            run = demote_run(tcb, smoke())
            be = SimulatedDistributedBackend(
                W, latency_s={W - 1: DEMOTE_LATENCY_S}, backend="gloo",
                device="cpu", timeout_s=TIMEOUT_S,
                coordinator_address=f"localhost:{port}", process_id=r,
                num_processes=4)
            _, arrays, meta = train(run, params0, be, heal=DEMOTE_HEAL,
                                    jsonl=f"{out}/r{r}.demote.jsonl")
            save(out, f"r{r}.demote", arrays, meta)
            # the 2-rank snapshot on 4 ranks at W=4
            run = make_run(tcb, smoke(), "ef_sign_wire")
            _, st = restored(dist_backend(r, port, 4), run, params0, p2_ckpt)
            save(out, f"r{r}.p4restore", rows(st, ""), {})
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        torch.set_num_threads(1)
        P, out, params0 = int(sys.argv[1]), sys.argv[2], torch.load(sys.argv[3])
        if P == 2:
            for name in VARIANTS:
                run = make_run(tcb, smoke(), name)
                ckpt = f"{out}/one_ckpt" if name == "ef_sign_wire" else None
                state, arrays, meta = train(run, params0,
                                            LocalBackend(W, device="cpu"),
                                            controller=elastic(run), ckpt=ckpt)
                if ckpt:
                    publish_flat(f"{out}/one_pub", mean_params(state),
                                 step=run.steps)
                save(out, f"one.{name}", arrays, meta)
            target, args = rank2, ()
        else:
            for kind, name in SHARDED:
                run = make_run(tcb, smoke(), name)
                lay = mesh_layout(tlayout, kind).with_sizes(SHARD_SIZES)
                ckpt = f"{out}/one_ckpt_{kind}" if kind == "tp" else None
                _, arrays, meta = train(
                    run, params0, LocalBackend(W, device="cpu", layout=lay),
                    controller=elastic(run), ckpt=ckpt)
                save(out, f"one.{kind}.{name}", arrays, meta)
            run = demote_run(tcb, smoke())
            _, arrays, meta = train(
                run, params0, SimulatedBackend(
                    W, latency_s={W - 1: DEMOTE_LATENCY_S}, device="cpu"),
                heal=DEMOTE_HEAL, jsonl=f"{out}/one.demote.jsonl")
            save(out, "one.demote", arrays, meta)
            target, args = rank4, (sys.argv[5],)
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(target, args=(port, out, params0) + args, nprocs=P)
''')


@pytest.fixture(scope="module")
def ref_params():
    """The reference's weights (its fit's own draw), as the port's tree."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), "mean")
    jb = jbuild(rj, num_workers=W, use_kernel=False)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    return params_from_reference(jax.tree.map(np.asarray, p0), "cpu")


def _load(d: Path, tag: str):
    meta = json.loads((d / f"{tag}.json").read_text())
    return dict(np.load(d / f"{tag}.npz")), meta


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, ref_params):
    """Run both spawns; {"P2": dir, "P4": dir}."""
    root = tmp_path_factory.mktemp("elastic")
    script = root / "spawn.py"
    script.write_text(_SCRIPT)
    p0 = root / "params0.pt"
    torch.save(ref_params, p0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for P in (2, 4):
        d = root / f"P{P}"
        d.mkdir()
        args = [sys.executable, str(script), str(P), str(d), str(p0),
                str(ROOT / "tests")]
        if P == 4:
            args.append(str(out["P2"] / "ckpt.npz"))
        res = subprocess.run(args, capture_output=True, text=True, env=env,
                             timeout=240)
        assert res.returncode == 0, res.stderr[-4000:]
        out[f"P{P}"] = d
    return out


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= rel * scale


def _rank_rows(one, key, r, groups, shards=1, sharded=False):
    """The rows of the one-process array ``key`` that rank ``r`` holds."""
    g, s = divmod(r, shards)
    x = one[key]
    if not key.startswith("anchor"):
        wl = x.shape[0] // groups
        x = x[g * wl:(g + 1) * wl]
    if sharded:
        lr = x.shape[-2] // shards
        x = x[..., s * lr:(s + 1) * lr, :]
    return x


def _same_across_ranks(metas, keys=("loss", "lr", "synced", "comm_rounds",
                                    "decisions", "ledger", "resize_spans",
                                    "topology")):
    for m in metas[1:]:
        for k in keys:
            assert m[k] == metas[0][k], k


def _same_as_one(m, one_m, loss_rtol):
    for k in ("synced", "comm_rounds", "resizes", "resize_spans", "lr",
              "topology"):
        assert m[k] == one_m[k], k
    assert m["ledger"]["worker_sets"] == one_m["ledger"]["worker_sets"]
    assert m["ledger"]["cost_sources"] == ["measured"]
    assert [d.get("workers") for d in m["decisions"]] == \
        [d.get("workers") for d in one_m["decisions"]]
    if loss_rtol == 0:
        assert m["loss"] == one_m["loss"]
    else:
        np.testing.assert_allclose(m["loss"], one_m["loss"], rtol=loss_rtol)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_resize_across_ranks_matches_one_process(spawned, name):
    d = spawned["P2"]
    one_a, one_m = _load(d, f"one.{name}")
    ranks = [_load(d, f"r{r}.{name}") for r in range(2)]
    metas = [m for _, m in ranks]
    _same_across_ranks(metas)
    m = metas[0]
    assert m["resizes"] == 2 and m["resize_spans"] == [[4, 2], [2, 4]]
    assert set(m["ledger"]["worker_sets"]) == {"W=2", "W=4"}
    # the LR co-scales with W: x 1/2 while W = 2, back to the schedule after
    run = make_run(tcb, tconfigs.get_smoke("paper-lm"), name)
    w_of = {2: 2, 3: 2, 4: 2, 5: 2}
    for t, lr in enumerate(m["lr"]):
        want = lr_at(run.optim, t, global_batch=run.shape.global_batch)
        if w_of.get(t, W) != W:
            want = want * np.float32(w_of[t] / W)
        assert lr == float(want), (t, lr, want)
    bitwise = name == "ef_sign_wire"
    _same_as_one(m, one_m, 0 if bitwise else (1e-6 if name == "mean" else 1e-5))
    for key in (k for k in one_a if not k.startswith(("restored.", "resumed.",
                                                      "w2."))):
        for r, (arrays, _) in enumerate(ranks):
            got, want = arrays[key], _rank_rows(one_a, key, r, 2)
            assert got.shape == want.shape, key
            if bitwise:
                assert np.array_equal(got, want), (key, r)
            elif name == "mean":
                rel = 1e-5 if key.startswith("momentum") else 1e-6
                assert _close(got, want, rel), (key, r)
            elif key.startswith(("params", "anchor")):
                frac = float((np.abs(got - want)
                              > 1e-6 * np.abs(want).max()).mean())
                assert frac <= FLIP_FRAC, (key, r, frac)
    if "round_summary" in one_m:
        assert m["round_summary"]["num_workers"] == \
            one_m["round_summary"]["num_workers"] == W


@pytest.mark.parametrize("name", list(VARIANTS))
def test_resize_across_ranks_matches_reference(spawned, ref_params, name):
    """The 2-rank run against the reference's elastic fit (its per-leaf
    bundle) with the same controller, from the same weights."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), name)
    _, jhist, jsum = jtrain.fit(
        rj, JBatches(make_data(), W, B),
        backend=JLocalBackend(W, build_fn=jit_builder),
        controller=jctl.ElasticController(rj, resize_at=RESIZE), seed=0,
        log=lambda *a: None)
    m = _load(spawned["P2"], f"r0.{name}")[1]
    assert m["comm_rounds"] == jsum["comm_rounds"]
    assert m["synced"] == [h["synced"] for h in jhist]
    assert m["resizes"] == jsum["resizes"] == 2
    assert m["ledger"]["worker_sets"].keys() == \
        jsum["ledger"]["worker_sets"].keys()
    for k, v in jsum["ledger"]["worker_sets"].items():
        assert m["ledger"]["worker_sets"][k]["rounds"] == v["rounds"], k
    np.testing.assert_allclose(m["loss"], [h["loss"] for h in jhist],
                               rtol=2e-4)


@pytest.mark.parametrize("kind,name", SHARDED)
def test_sharded_resize_across_ranks(spawned, kind, name):
    """2 worker groups x 2 shard ranks, W 4 -> 2 -> 4, against the
    one-process sharded run: tensor parallel bit for bit, FSDP within
    1e-5 (each shard rank differentiates half of a worker's batch)."""
    d = spawned["P4"]
    one_a, one_m = _load(d, f"one.{kind}.{name}")
    ranks = [_load(d, f"r{r}.{kind}.{name}") for r in range(4)]
    _same_across_ranks([m for _, m in ranks])
    rel = 0 if kind == "tp" else 1e-5
    _same_as_one(ranks[0][1], one_m, rel)
    lay = tbuild(make_run(tcb, tconfigs.get_smoke("paper-lm"), name),
                 num_workers=W, device="cpu",
                 layout=mesh_layout(tlayout, kind).with_sizes(
                     {"data": 2, "model": 2})).layout
    for key in one_a:
        b = int(key.split(".")[1])
        sharded = lay.bucket_shard_count(b) > 1
        for r, (arrays, _) in enumerate(ranks):
            got = arrays[key]
            want = _rank_rows(one_a, key, r, 2, shards=2, sharded=sharded)
            assert got.shape == want.shape, (key, r)
            if rel == 0:
                assert np.array_equal(got, want), (key, r)
            else:
                assert _close(got, want, rel), (key, r)
        if not sharded:     # a worker's shard ranks hold it alike
            for g in range(2):
                assert np.array_equal(ranks[2 * g][0][key],
                                      ranks[2 * g + 1][0][key]), key


def test_demotion_across_ranks(spawned):
    """A straggler demoted and promoted back across 4 ranks: the rounds,
    the switch to hierarchical(2) with its blocks on two-rank sub-groups,
    the JSONL and the decisions equal the one-process simulated run's and
    the reference's."""
    d = spawned["P4"]
    one_a, one_m = _load(d, "one.demote")
    ranks = [_load(d, f"r{r}.demote") for r in range(4)]
    _same_across_ranks([m for _, m in ranks])
    m = ranks[0][1]
    _same_as_one(m, one_m, 1e-6)
    assert m["decisions"] == one_m["decisions"]
    recs = [json.loads(l) for l in open(d / "r0.demote.jsonl")]
    one = [json.loads(l) for l in open(d / "one.demote.jsonl")]
    assert [sorted(r) for r in recs] == [sorted(r) for r in one]
    for r, o in zip(recs, one):
        for k in ("round", "step", "h", "num_workers", "worker_step_s",
                  "worker_step_skew", "worker_slowest", "worker_step_s_by_id",
                  "next_h", "topology", "demote", "promote", "decisions"):
            assert r.get(k) == o.get(k), (r["round"], k)
    assert [r["demote"] for r in recs if "demote" in r] == [W - 1]
    assert [r["promote"] for r in recs if "promote" in r] == [W - 1]
    assert m["comm_rounds"]["block"] > 0 and m["topology"] == "flat"
    assert m["backend"]["demoted"] == []
    # the blocks of two workers span two ranks: averaged on sub-groups
    assert m["totals"]["ordered_mean/block"]["calls"] == m["comm_rounds"]["block"]
    for key in one_a:
        for r, (arrays, _) in enumerate(ranks):
            rel = 1e-5 if key.startswith("momentum") else 1e-6
            assert _close(arrays[key], _rank_rows(one_a, key, r, 4), rel), key
    # the reference's simulated straggler, healed at the same step
    rj = demote_run(jcb, jconfigs.get_smoke("paper-lm"))
    jbe = JSimulatedBackend(W, latency_s={W - 1: DEMOTE_LATENCY_S},
                            build_fn=jit_builder)

    def heal(state):
        jbe.latency_s.clear()
        return {}
    _, jhist, jsum = jtrain.fit(
        rj, JBatches(make_data(), W, B), backend=jbe, seed=0,
        eval_fn=heal, eval_every=DEMOTE_HEAL,
        log=lambda *a: None)
    assert m["comm_rounds"] == jsum["comm_rounds"]
    assert m["synced"] == [h["synced"] for h in jhist]
    assert m["topology"] == jsum["topology"]
    np.testing.assert_allclose(m["loss"], [h["loss"] for h in jhist],
                               rtol=2e-4)


def _members(path):
    data = np.load(path)
    return {k: data[k].tobytes() for k in data.files}


def test_checkpoint_across_ranks_is_the_one_process_snapshot(spawned):
    """The files ``fit(checkpoint_fn=)`` saves from 2 ranks and from 2 x 2
    sharded ranks hold the one-process snapshot's members byte for byte,
    and its sidecar."""
    d2, d4 = spawned["P2"], spawned["P4"]
    for got, want in ((d2 / "ckpt", d2 / "one_ckpt"),
                      (d4 / "ckpt_tp", d4 / "one_ckpt_tp")):
        gm, wm = _members(f"{got}.npz"), _members(f"{want}.npz")
        assert gm.keys() == wm.keys()
        for k in wm:
            assert gm[k] == wm[k], (got, k)
        assert load_meta(str(got)) == load_meta(str(want))
        assert load_meta(str(got))["step"] == CKPT_STEP
    # publish_flat of the worker mean from rank 0: the one process's
    got, want = _members(d2 / "pub" / "weights_v0.npz"), \
        _members(d2 / "one_pub" / "weights_v0.npz")
    assert got.keys() == want.keys() and all(got[k] == want[k] for k in want)


def test_checkpoint_across_ranks_restores(spawned, ref_params):
    """The 2-rank snapshot restores in one process (W=4 and, through the
    elastic restore, W=2), on 2 ranks at W=4 and W=2, on 4 ranks at W=4
    and into the reference; the run resumed from it on 2 ranks equals the
    uninterrupted run."""
    d2, d4 = spawned["P2"], spawned["P4"]
    path = str(d2 / "ckpt")
    run = make_run(tcb, tconfigs.get_smoke("paper-lm"), "ef_sign_wire")
    b = tbuild(run, num_workers=W, device="cpu")
    st = restore_flat(path, b.init(ref_params))
    data = np.load(f"{path}.npz")
    whole = {f"{f}.0": getattr(st, f).buckets[0].numpy()
             for f in FIELDS if getattr(st, f) is not None}
    assert st.step == CKPT_STEP + 1
    b2 = tbuild(run, num_workers=2, device="cpu")
    st2 = restore_flat(path, b2.init(ref_params))
    for f in ("params", "momentum", "ef_memory"):
        assert np.array_equal(getattr(st2, f).buckets[0].numpy(),
                              whole[f"{f}.0"][:2])
    ranks = [_load(d2, f"r{r}.ef_sign_wire")[0] for r in range(2)]
    for key, x in whole.items():
        for r in range(2):
            assert np.array_equal(ranks[r][f"restored.{key}"],
                                  _rank_rows(whole, key, r, 2)), (key, r)
            w2 = {key: x[:2]} if not key.startswith("anchor") else {key: x}
            assert np.array_equal(ranks[r][f"w2.{key}"],
                                  _rank_rows(w2, key, r, 2)), (key, r)
        for r in range(4):
            got = _load(d4, f"r{r}.p4restore")[0][key]
            assert np.array_equal(got, _rank_rows(whole, key, r, 4)), (key, r)
    # the resumed run: the uninterrupted run's last losses and rows
    for r in range(2):
        arrays, meta = _load(d2, f"r{r}.ef_sign_wire")
        assert meta["resumed_loss"] == meta["loss"][CKPT_STEP + 1:]
        for key in (k for k in arrays if "." not in k.split(".", 1)[0]
                    and k.split(".")[0] in FIELDS):
            assert np.array_equal(arrays[f"resumed.{key}"], arrays[key]), key
    # into the reference: its restore of the same file, member for member
    jb = jbuild(make_run(jcb, jconfigs.get_smoke("paper-lm"), "ef_sign_wire"),
                num_workers=W, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    jst = jb.init(jax.random.PRNGKey(0), p0)
    tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jst)
    back = jckpt.restore_flat(path, tmpl)
    for f in FIELDS:
        jv = getattr(back, f)
        if jv is not None:
            assert np.array_equal(np.asarray(jv.buckets[0]), whole[f"{f}.0"]), f
    assert int(np.asarray(back.step)) == CKPT_STEP + 1
    assert data.files == np.load(str(d2 / "one_ckpt.npz")).files


def test_resize_refused_before_anything_changes(spawned):
    """W' = 1 across 2 worker groups: ValueError naming the rule, raised
    before the census, the state or the data change."""
    for r in range(2):
        meta = _load(spawned["P2"], f"r{r}.refused")[1]
        assert "W' % G must be 0" in meta["error"], meta["error"]
        assert meta["census"] == list(range(W))
    with pytest.raises(ValueError, match="W' % G must be 0"):
        tlayout.WorkerLayout(4, 2, 0).resized(1)
    with pytest.raises(ValueError, match="W' % G must be 0"):
        tlayout.WorkerLayout(8, 8, 3, within_worker_size=2).resized(6)
    with pytest.raises(ValueError, match="a grow W' % W"):
        tlayout.WorkerLayout(4, 2, 0).resized(6)
    lay = tlayout.WorkerLayout(4, 4, 1, within_worker_size=2).resized(2)
    assert (lay.num_workers, lay.group, lay.shard, lay.worker_ids) == \
        (2, 0, 1, (0,))


def test_noisy_checkpoint_across_worker_groups_refused(spawned):
    """A snapshot holds one noise stream, worker group 0's: ``fit(
    checkpoint_fn=)`` of a noisy run over 2 worker groups raises before any
    step, and ``local_state`` refuses a stream that has drawn for any other
    worker group (a new one would replay its draws), while group 0 keeps
    it as it is."""
    from repro_torch.core.local_sgd import local_state
    from repro_torch.models import base as tmbase
    for r in range(2):
        meta = _load(spawned["P2"], f"r{r}.noisy")[1]
        assert "noise stream" in meta["error"], meta["error"]
        assert not (spawned["P2"] / "noisy.npz").exists()
    run = make_run(tcb, tconfigs.get_smoke("paper-lm"), "mean")
    bundle = tbuild(run, num_workers=W, device="cpu")
    params0 = tmbase.materialize(bundle.specs,
                                 torch.Generator().manual_seed(0), "cpu")
    full = bundle.init(params0, seed=5)
    grid = lambda g: type("Dist", (), {"layout": tlayout.WorkerLayout(
        W, 2, g)})()
    assert local_state(full, grid(1), "cpu").rng.initial_seed() == 1_000_008
    torch.randn((3,), generator=full.rng)
    kept = local_state(full, grid(0), "cpu")
    assert kept.rng is full.rng
    with pytest.raises(ValueError, match="noise stream has drawn"):
        local_state(full, grid(1), "cpu")
