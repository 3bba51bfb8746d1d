"""Port parity: the twins of the reference's examples
(``repro_torch.examples``) against the reference's own runs.

Each twin's ``main(["--device", "cpu", "--steps", N], params0=...)`` is
held against the reference's ``build_train`` (or ``make_local_sgd``) and
``fit`` at the same ``RunConfig``, on the weights the reference's ``fit``
draws itself (``materialize(specs, PRNGKey(0))``, carried over as numpy)
and the same data.  The reference's scripts run its default, the per-leaf
tree path (``use_kernel=False``); the twins run the port's default, the
resident kernel path (on the CPU, the kernels' plain versions).  The
reference's bundle functions are jitted here (its bundles run op by op).
Per-step losses and held-out xent: rtol 1e-4 (float32, another path and
another order of sums over a run); comm rounds, the ledger's rounds,
bytes and collectives, and the controllers' decisions: exact.

The other six twins against the functions the reference's scripts call
at the same settings: ``convex_logreg`` (``_best_over_lrs``: the rows
equal), ``post_local_generalization`` (``train_local_sgd``: comm rounds
equal, test accuracy within 2 / n_test), ``noise_adaptive_frontier`` and
``traced_run`` (the reference's resident bundle and ``fit``: losses rtol
1e-4, rounds, wire bytes and the frontier's decisions exact; the traced
artifacts pass ``check_trace_dir``), ``serve_lm`` and
``serve_continuous`` (the reference's greedy tokens from the same
weights, token for token; the hot-swap's residents continue on the new
version, as the reference's do).

Also pinned: ``build_train()`` builds the resident path unless asked
(the port keeps ``use_kernel=True`` as its default, the reference
``False``), ``resident=False`` builds the tree-in/tree-out kernel form,
and the tree path across ranks builds with whole workers a rank and
refuses a worker split over shard ranks.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.configs import paper_lm as jpaper_lm
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import load_meta
from repro_torch.configs import base as tcb
from repro_torch.core import local_sgd as tsgd
from repro_torch.examples import (adaptive_local_sgd, convex_logreg,
                                  hierarchical_local_sgd,
                                  noise_adaptive_frontier,
                                  post_local_generalization, quickstart,
                                  serve_continuous, serve_lm, traced_run,
                                  train_lm)
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase

torch.set_num_threads(2)

QUIET = dict(log=lambda *a, **k: None)


def _jrun(run_t, model):
    """The reference's RunConfig with the port's fields, on the reference's
    ``model``."""
    conv = lambda obj, cls: cls(**{f.name: getattr(obj, f.name)
                                   for f in dataclasses.fields(obj)})
    return jcb.RunConfig(
        model=model, shape=conv(run_t.shape, jcb.InputShape),
        local_sgd=conv(run_t.local_sgd, jcb.LocalSGDConfig),
        optim=conv(run_t.optim, jcb.OptimConfig),
        controller=conv(run_t.controller, jcb.ControllerConfig),
        steps=run_t.steps, remat=run_t.remat)


def _jit(bundle):
    bundle.local_step = jax.jit(bundle.local_step)
    bundle.sync = jax.jit(bundle.sync, static_argnames=("group", "compression",
                                                        "plan", "scope"))
    return bundle


def _p0(specs):
    return jax.tree.map(np.asarray,
                        jmbase.materialize(specs, jax.random.PRNGKey(0)))


def _lm_data(vocab, num_seqs, seq, **kw):
    from repro.data.synthetic import lm_examples, markov_lm
    return lm_examples(markov_lm(vocab=vocab, num_seqs=num_seqs, seq_len=seq,
                                 **kw))


def test_quickstart_twin_matches_reference():
    steps = 12
    rj = _jrun(quickstart.make_run(steps), jconfigs.get_smoke("paper-lm"))
    K, B, S = quickstart.K, quickstart.B_LOC, quickstart.SEQ
    jb = _jit(jbuild(rj, num_workers=K))
    held = _lm_data(rj.model.vocab_size, 64, S, sample_seed=99)
    _, jh, js = jtrain.fit(rj, JBatches(_lm_data(rj.model.vocab_size, 512, S),
                                        K, B), bundle=jb, num_steps=steps,
                           eval_every=10, eval_fn=jtrain.eval_lm(jb, held),
                           log=lambda *a: None)
    out = quickstart.main(["--device", "cpu", "--steps", str(steps)],
                          params0=_p0(jb.specs), **QUIET)
    assert out["device"] == "cpu"
    np.testing.assert_allclose(out["losses"], [h["loss"] for h in jh],
                               rtol=1e-4)
    np.testing.assert_allclose(out["eval_xent"],
                               [h["eval_xent"] for h in jh if "eval_xent" in h],
                               rtol=1e-4)
    assert out["comm_rounds"] == js["comm_rounds"]
    assert js["comm_rounds"]["global"] < steps


def test_train_lm_twin_matches_reference(tmp_path):
    argv = ["--device", "cpu", "--steps", "8", "--ckpt", str(tmp_path / "lm")]
    args = train_lm.parse(argv)
    rj = _jrun(train_lm.make_run(args), jpaper_lm.tiny())
    jb = _jit(jbuild(rj, num_workers=args.workers))
    V = rj.model.vocab_size
    held = _lm_data(V, 64, args.seq, sample_seed=7)
    _, jh, js = jtrain.fit(rj, JBatches(_lm_data(V, 1024, args.seq),
                                        args.workers, args.local_batch),
                           bundle=jb, num_steps=args.steps,
                           eval_every=max(args.steps // 4, 1),
                           eval_fn=jtrain.eval_lm(jb, held),
                           log=lambda *a: None)
    out = train_lm.main(argv, params0=_p0(jb.specs), **QUIET)
    np.testing.assert_allclose(out["losses"], [h["loss"] for h in jh],
                               rtol=1e-4)
    np.testing.assert_allclose(out["eval_xent"],
                               [h["eval_xent"] for h in jh if "eval_xent" in h],
                               rtol=1e-4)
    assert out["comm_rounds"] == js["comm_rounds"]
    meta = load_meta(out["ckpt"])
    assert meta == {"step": args.steps, "arch": "paper-lm-tiny", "H": 4}


def test_hierarchical_twin_matches_reference():
    from repro.core.syncplan import hierarchical, make_sync_plan
    steps = 12
    H = hierarchical_local_sgd
    rj = _jrun(H.make_run(steps), jconfigs.get_smoke("paper-lm"))
    jb = jbuild(rj, num_workers=H.K)
    jb.sync_plan = make_sync_plan(jb, topology=hierarchical(H.BLOCK))
    jb = _jit(jb)
    jstate, jh, js = jtrain.fit(
        rj, JBatches(_lm_data(rj.model.vocab_size, 512, H.SEQ), H.K, H.B_LOC),
        bundle=jb, num_steps=steps, log=lambda *a: None)
    out = H.main(["--device", "cpu", "--steps", str(steps)],
                 params0=_p0(jb.specs), **QUIET)
    np.testing.assert_allclose(out["losses"], [h["loss"] for h in jh],
                               rtol=1e-4)
    assert out["comm_rounds"] == js["comm_rounds"] == {"block": 4, "global": 2}
    assert out["topology"] == js["topology"]
    for key, row in js["ledger"]["topologies"].items():
        got = out["ledger"][key]
        for f in ("rounds", "bytes_per_round", "collectives"):
            assert got[f] == row[f], (key, f)
    w = jax.tree.leaves(jstate.params)[0]
    assert out["spread"] == float(np.abs(np.float32(w[0])
                                         - np.float32(w[-1])).max()) == 0.0


def test_adaptive_twin_matches_reference(tmp_path):
    """The four runs of the adaptive example (constant H=1, H=8,
    ``diversity_h``, ``auto_compress`` with the 1-bit wire) against the
    reference's runs on its tree path: losses, sync rounds, wire bytes,
    the H and compressor trajectories, and test accuracy within one test
    example (a float32 near-tie at the argmax)."""
    import benchmarks.common as bc
    from repro.backend.base import WorkerSet as JWorkerSet
    from repro.core.local_sgd import make_local_sgd as jmake
    from repro.launch.steps import TrainBundle as JBundle
    from repro.models.base import ParamSpec as JSpec

    steps = 8
    A = adaptive_local_sgd
    jspecs = {k: JSpec(s.shape, s.axes, init=s.init)
              for k, s in A.mlp_specs().items()}
    out = A.main(["--device", "cpu", "--steps", str(steps),
                  "--telemetry-dir", str(tmp_path / "port")],
                 params0=_p0(jspecs), **QUIET)
    train, test = bc.dataset()
    tdir = tmp_path / "ref"
    tdir.mkdir()
    assert [r["name"] for r in out["rows"]] == [c[0] for c in A.CONFIGS]
    for row, (name, ls, cc, jsonl) in zip(out["rows"], A.CONFIGS):
        rj = _jrun(A.make_run(ls, cc, steps),
                   jcb.ModelConfig(name="mlp", family="dense", citation=""))
        c = rj.controller
        init, local_step, sync = jmake(
            rj, bc.mlp_loss, num_workers=A.K, telemetry=c.wants_telemetry,
            speculate_compression=c.wants_speculation)
        jb = JBundle(cfg=rj.model, run=rj, layout=None, num_workers=A.K,
                     specs=jspecs, init=init, local_step=jax.jit(local_step),
                     sync=jax.jit(sync, static_argnames=("group", "compression",
                                                         "plan", "scope")),
                     telemetry=c.wants_telemetry,
                     worker_set=JWorkerSet.of(A.K))
        jstate, jh, js = jtrain.fit(rj, JBatches(train, A.K, A.B_LOC),
                                    bundle=jb, num_steps=steps,
                                    telemetry_path=tdir / f"{jsonl}.jsonl",
                                    log=lambda *a: None)
        np.testing.assert_allclose(row["losses"], [h["loss"] for h in jh],
                                   rtol=1e-4, err_msg=name)
        assert row["rounds"] == js["ledger"]["sync_rounds"], name
        assert row["wire_mb"] == js["ledger"]["wire_bytes"] / 1e6, name
        assert abs(row["acc"] - bc.test_acc(jstate, test)) <= 1 / 2048, name
    import json
    for name, traj in out["trajectories"].items():
        recs = [json.loads(l) for l in open(tdir / f"{name}.jsonl")]
        assert traj["h"] == [r["h"] for r in recs], name
        if name == "auto_compress":
            assert traj["next_compression"] == [r["next_compression"]
                                                for r in recs]


def test_convex_logreg_twin_matches_reference():
    from benchmarks import bench_convex as jcv
    out = convex_logreg.main(["--device", "cpu", "--hs", "1", "2", "--k", "4"],
                             **QUIET)
    assert out["device"] == "cpu"
    for row in out["rows"]:
        want = jcv._best_over_lrs(K=4, H=row["H"], B_loc=16)
        got = (row["sim_time"], row["steps"], row["comm"], row["reached"])
        assert got == tuple(want), row


def test_post_local_generalization_twin_matches_reference():
    import benchmarks.common as bc
    steps = 12
    p0 = jax.tree.map(np.asarray, bc.mlp_init(jax.random.PRNGKey(0), 256))
    out = post_local_generalization.main(["--device", "cpu", "--steps",
                                          str(steps)], params0=p0, **QUIET)
    train, test = bc.dataset()
    rows = post_local_generalization.rows_for(steps)
    assert [r["name"] for r in out["rows"]] == [n for n, _ in rows]
    for got, (name, kw) in zip(out["rows"], rows):
        js, comm, _ = bc.train_local_sgd(steps=steps, train=train, **kw)
        assert got["comm"] == comm, name
        assert abs(got["acc"] - bc.test_acc(js, test)) <= 2 / len(test["y"]), \
            name


def _mlp_bundle(rj, K):
    """The reference's resident MLP bundle of the adaptive examples, its
    local step and sync jitted."""
    import benchmarks.common as bc
    from repro.backend.base import WorkerSet as JWorkerSet
    from repro.core.local_sgd import make_local_sgd as jmake
    from repro.launch.steps import TrainBundle as JBundle
    c = rj.controller
    init, local_step, sync = jmake(
        rj, bc.mlp_loss, num_workers=K, use_kernel=True,
        telemetry=c.wants_telemetry,
        speculate_compression=c.wants_speculation)
    return JBundle(cfg=rj.model, run=rj, layout=None, num_workers=K,
                   specs=_jspecs(), init=init, local_step=jax.jit(local_step),
                   sync=jax.jit(sync, static_argnames=("group", "compression",
                                                       "plan", "scope")),
                   telemetry=c.wants_telemetry, worker_set=JWorkerSet.of(K))


def _jspecs():
    from repro.models.base import ParamSpec as JSpec
    return {k: JSpec(s.shape, s.axes, init=s.init)
            for k, s in adaptive_local_sgd.mlp_specs().items()}


def test_noise_adaptive_frontier_twin_matches_reference(tmp_path):
    import json

    import benchmarks.common as bc
    from repro.core.local_sgd import mean_params as jmean
    steps = 16
    N = noise_adaptive_frontier
    out = N.main(["--device", "cpu", "--steps", str(steps), "--telemetry-dir",
                  str(tmp_path / "port")], params0=_p0(_jspecs()), **QUIET)
    train, test = bc.dataset()
    tdir = tmp_path / "ref"
    tdir.mkdir()
    for row, (name, ls, cc, jsonl) in zip(out["rows"], N.RUNS):
        rj = _jrun(N.make_run(ls, cc, steps),
                   jcb.ModelConfig(name="mlp", family="dense", citation=""))
        jstate, jh, js = jtrain.fit(rj, JBatches(train, N.K, N.B_LOC),
                                    bundle=_mlp_bundle(rj, N.K),
                                    num_steps=steps,
                                    telemetry_path=tdir / f"{jsonl}.jsonl",
                                    log=lambda *a: None)
        np.testing.assert_allclose(row["losses"], [h["loss"] for h in jh],
                                   rtol=1e-4, err_msg=name)
        assert row["rounds"] == js["ledger"]["sync_rounds"], name
        assert row["wire_mb"] == js["ledger"]["wire_bytes"] / 1e6, name
        assert row["controller"] == js["controller"], name
        assert abs(row["acc"] - bc.test_acc(jmean(jstate), test)) \
            <= 1 / 2048, name
    recs = [json.loads(ln) for ln in
            open(tdir / "frontier_noise_adaptive.jsonl")]
    for k in ("h", "next_compression", "next_batch_scale", "next_lr_scale"):
        assert [r[k] for r in out["frontier"]] == [r[k] for r in recs], k
    assert len(out["checks"]) == 6


def test_traced_run_twin_matches_reference(tmp_path):
    import benchmarks.common as bc
    from repro_torch.telemetry.export import check_trace_dir as tcheck
    steps = 12
    T = traced_run
    out = T.main(["--device", "cpu", "--steps", str(steps), "--fence",
                  "--out", str(tmp_path / "port")], params0=_p0(_jspecs()),
                 **QUIET)
    assert out["errors"] == [] and tcheck(out["out"]) == []
    assert {"round", "sync", "local_steps", "collective"} <= set(out["census"])
    rj = _jrun(T.make_run(steps),
               jcb.ModelConfig(name="mlp", family="dense", citation=""))
    train, _ = bc.dataset()
    _, jh, js = jtrain.fit(rj, JBatches(train, T.K, T.B_LOC),
                           bundle=_mlp_bundle(rj, T.K), num_steps=steps,
                           log=lambda *a: None)
    np.testing.assert_allclose(out["losses"], [h["loss"] for h in jh],
                               rtol=1e-4)
    assert out["rounds"] == js["ledger"]["sync_rounds"]
    assert out["wire_bytes"] == js["ledger"]["wire_bytes"]
    # every collective stage of the join has its bytes and its seconds
    assert out["join"] and all(b > 0 and s >= 0 for b, s in
                               out["join"].values())


def test_serve_lm_twin_matches_reference():
    """The twin's greedy tokens are the reference's, from the same weights
    and prompts (the reference script's own prefill + decode loop)."""
    import jax.numpy as jnp
    from repro.models import lm as jlm
    cfg = jconfigs.get_smoke("gemma3-1b")
    p0 = jmbase.materialize(jlm.param_specs(cfg), jax.random.PRNGKey(0))
    out = serve_lm.main(["--device", "cpu"], params0=jax.tree.map(np.asarray, p0),
                        **QUIET)
    B, P, G = 4, 32, 16
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)), jnp.int32)
    assert np.array_equal(out["prompts"], np.asarray(prompts))
    logits, cache = jlm.prefill(cfg, p0, prompts, scan=True, max_len=P + G)
    tok = logits.argmax(-1).astype(jnp.int32)
    toks = [tok]
    step = jax.jit(lambda p, t, c, n: jlm.decode_step(cfg, p, t, c, n))
    for i in range(G - 1):
        logits, cache = step(p0, tok, cache, jnp.int32(P + i + 1))
        tok = logits.argmax(-1).astype(jnp.int32)
        toks.append(tok)
    want = np.asarray(jnp.concatenate(toks, axis=1))
    assert out["tokens"].shape == (B, G)
    assert np.array_equal(out["tokens"], want)


def test_serve_continuous_twin_matches_reference(tmp_path):
    """The twin's engine serves the reference script's workload with the
    hot-swap at the same point: every request's tokens, finish reason and
    weight versions equal the reference engine's from the same two weight
    versions, and the residents at the swap continue on the new one."""
    from repro.configs.base import InputShape as JShape
    from repro.launch.steps import build_engine as jengine
    from repro.models import lm as jlm
    from repro.serving import WeightPublisher as JPub
    from repro.serving import WeightSubscriber as JSub
    cfg = jconfigs.get_smoke("gemma3-1b")
    specs = jlm.param_specs(cfg)
    p0 = jmbase.materialize(specs, jax.random.PRNGKey(0))
    p1 = jmbase.materialize(specs, jax.random.PRNGKey(1))
    out = serve_continuous.main(
        ["--device", "cpu"], params0=jax.tree.map(np.asarray, p0),
        params1=jax.tree.map(np.asarray, p1), **QUIET)
    # the reference script's run, from the same weights
    eng = jengine(cfg, JShape("serve", 48, 4, "decode"), params=p0,
                  page_size=8, prefill_len=8)
    rng = np.random.default_rng(0)
    for i in range(12):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(3, 7)))
        eng.submit(prompt, max_new=24 if i % 4 == 0 else 3)
    pub, sub = JPub(str(tmp_path)), JSub(str(tmp_path), specs)
    pub.publish(p1, step=100)
    version = None
    while not eng.idle:
        eng.step()
        if len(eng.completed) >= 6 and eng.weight_version < 0:
            version = eng.poll_weights(sub)
    want = [{"uid": r.uid, "tokens": list(map(int, r.tokens)),
             "finish_reason": r.finish_reason,
             "weight_versions": tuple(r.weight_versions)}
            for r in eng.completed]
    assert out["completed"] == want
    swap = out["swap"]
    assert swap["version"] == version and swap["residents"]
    by_uid = {r["uid"]: r for r in out["completed"]}
    for uid in swap["residents"]:
        assert by_uid[uid]["weight_versions"][-1] == version, uid
        assert len(by_uid[uid]["weight_versions"]) >= 2, uid


# ---------------------------------------------------------------------------
# Defaults and refusals
# ---------------------------------------------------------------------------

def _smoke_run(**ls):
    return tcb.RunConfig(model=tconfigs.get_smoke("paper-lm"),
                         shape=tcb.InputShape("t", 16, 4, "train"),
                         local_sgd=tcb.LocalSGDConfig(**ls))


def test_build_train_defaults_to_the_resident_path():
    """The port's ``use_kernel`` default is True (the reference's is
    False): ``build_train()``, ``make_local_sgd()`` and ``LocalBackend()``
    build the resident kernel path unless the tree path is asked for."""
    from repro_torch.backend.local import LocalBackend
    run = _smoke_run(sync_compression="ef_sign")
    p0 = lambda tb: tmbase.materialize(tb.specs,
                                       torch.Generator().manual_seed(0), "cpu")
    tb = tbuild(run, num_workers=2, device="cpu")
    assert tsgd.is_resident(tb.init(p0(tb))) and tb.n_comp == 1
    lb = LocalBackend(2, device="cpu")
    assert lb.use_kernel is True and tsgd.is_resident(lb.build(run).init(p0(tb)))
    tree = tbuild(run, num_workers=2, device="cpu", use_kernel=False)
    assert not tsgd.is_resident(tree.init(p0(tree)))
    kform = tbuild(run, num_workers=2, device="cpu", resident=False)
    s = kform.init(p0(kform))
    assert not tsgd.is_resident(s)
    tok = np.arange(2 * 2 * 16).reshape(2, 2, 16) % 512
    s, m = kform.local_step(s, {"tokens": tok, "labels": (tok + 1) % 512})
    s = kform.sync(s, plan=kform.sync_plan)
    assert torch.isfinite(m["loss"]) and s.ef_memory["embed"].dtype == torch.float32
    lt = LocalBackend(2, device="cpu", use_kernel=False)
    assert not tsgd.is_resident(lt.build(run).init(p0(tb)))


def test_build_train_defaults_to_no_recompute(monkeypatch):
    """The port's ``RunConfig.remat`` default is "none" (the reference's
    is "block"), as is ``lm.loss_fn``'s: no recompute unless asked for.
    ``build_train`` hands ``run.remat`` to ``lm.loss_fn``, as the
    reference's does; "block" gives the same loss."""
    import inspect

    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    assert tcb.RunConfig(model=tconfigs.get_smoke("paper-lm")).remat == "none"
    assert jcb.RunConfig(model=jconfigs.get_smoke("paper-lm")).remat == "block"
    assert inspect.signature(tlm.loss_fn).parameters["remat"].default == "none"
    assert inspect.signature(jlm.loss_fn).parameters["remat"].default == "block"
    seen = []
    loss_fn = tlm.loss_fn

    def spy(cfg, params, batch, **kw):
        seen.append(kw.get("remat"))
        return loss_fn(cfg, params, batch, **kw)

    monkeypatch.setattr(tlm, "loss_fn", spy)
    tok = np.arange(2 * 2 * 16).reshape(2, 2, 16) % 512
    batch = {"tokens": tok, "labels": (tok + 1) % 512}
    losses = []
    for remat in ("none", "block"):
        run = dataclasses.replace(_smoke_run(), remat=remat)
        tb = tbuild(run, num_workers=2, device="cpu")
        s = tb.init(tmbase.materialize(tb.specs, torch.Generator().manual_seed(0),
                                       "cpu"))
        seen.clear()
        losses.append(tb.local_step(s, batch)[1]["loss"])
        assert seen and set(seen) == {remat}
    assert torch.equal(losses[0], losses[1])


def test_tree_path_across_ranks_raises():
    """The tree path across ranks (``use_kernel=False``, or
    ``resident=False``) builds with whole workers a rank (S = 1) and with
    workers split over shard ranks (S > 1): the backend keeps the choice
    and S for every build, and ``build_train`` gives a tree state of the
    rank's workers, on a within-worker grid its shard's slice of every
    leaf the layout shards.  It still raises ``ValueError`` before any
    collective where a grid has no layout to shard the leaves by.
    (``tests/test_torch_tree_dist.py`` and
    ``tests/test_torch_tree_sharded_dist.py`` train it on ranks.)"""
    from types import SimpleNamespace

    from repro_torch.backend.distributed import DistributedBackend
    from repro_torch.sharding.layout import WorkerLayout, train_layout
    common = dict(device="cpu", coordinator_address="localhost:1",
                  process_id=0, num_processes=2)
    be = DistributedBackend(2, use_kernel=False, **common)
    assert be.use_kernel is False and be.collectives is None
    assert DistributedBackend(2, resident=False, **common).resident is False
    tp = train_layout(("data", "model"), worker_axes=("data",))
    for kw in (dict(use_kernel=False), dict(resident=False)):
        be = DistributedBackend(4, within_worker_size=2, layout=tp, **kw,
                                **{**common, "num_processes": 4})
        assert (be.use_kernel, be.resident, be.within_worker_size) == (
            kw.get("use_kernel", True), kw.get("resident"), 2)
        assert be.mesh_layout(4).sizes == {"data": 2, "model": 2}
        # rank 3: worker group 1, shard 1
        split = SimpleNamespace(layout=WorkerLayout(4, 4, 3,
                                                    within_worker_size=2))
        with pytest.raises(ValueError, match="MeshLayout"):
            tbuild(_smoke_run(), num_workers=4, device="cpu", dist=split,
                   **kw)
        tb = tbuild(_smoke_run(), num_workers=4, device="cpu", dist=split,
                    layout=be.mesh_layout(4), **kw)
        p0 = tmbase.materialize(tb.specs, torch.Generator().manual_seed(0),
                                "cpu")
        s = tb.init(p0)
        assert not tsgd.is_resident(s) and tb.shard_classes is not None
        # the vocab dim of the embedding is split: shard 1's half
        assert s.params["embed"].shape == (2, 256, 128)
        assert torch.equal(s.params["embed"][1], p0["embed"][256:])
        whole = SimpleNamespace(layout=WorkerLayout(2, 2, 1))
        tb = tbuild(_smoke_run(), num_workers=2, device="cpu", dist=whole,
                    **kw)
        s = tb.init(tmbase.materialize(tb.specs, torch.Generator(), "cpu"))
        assert not tsgd.is_resident(s) and s.params["embed"].shape[0] == 1


def test_twins_default_to_the_card():
    """Without ``--device`` every twin runs on the card, and raises without
    one, before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    for mod in (quickstart, train_lm, hierarchical_local_sgd,
                adaptive_local_sgd, post_local_generalization,
                noise_adaptive_frontier, traced_run):
        with pytest.raises(RuntimeError, match="no CUDA"):
            mod.main(["--steps", "1"], **QUIET)
    for mod, argv in ((convex_logreg, ["--hs", "1"]), (serve_lm, []),
                      (serve_continuous, [])):
        with pytest.raises(RuntimeError, match="no CUDA"):
            mod.main(argv, **QUIET)
