"""Port parity: the twins of the reference's training examples
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

Also pinned: ``build_train()`` builds the resident path unless asked
(the port keeps ``use_kernel=True`` as its default, the reference
``False``), ``resident=False`` builds the tree-in/tree-out kernel form,
and the tree path refuses to run across ranks.
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
from repro_torch.examples import (adaptive_local_sgd, hierarchical_local_sgd,
                                  quickstart, train_lm)
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


def test_tree_path_across_ranks_raises():
    """``use_kernel=False`` (or ``resident=False``) across ranks raises
    ``ValueError`` before any collective: ``DistributedBackend`` at
    construction, ``build_train`` at once with a ``dist``."""
    from repro_torch.backend.distributed import DistributedBackend
    with pytest.raises(ValueError, match="one process"):
        DistributedBackend(2, use_kernel=False, device="cpu",
                           coordinator_address="localhost:1",
                           process_id=0, num_processes=2)
    for kw in (dict(use_kernel=False), dict(resident=False)):
        with pytest.raises(ValueError, match="one process"):
            tbuild(_smoke_run(), num_workers=2, device="cpu", dist=object(),
                   **kw)


def test_twins_default_to_the_card():
    """Without ``--device`` every twin runs on the card, and raises without
    one, before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    for mod in (quickstart, train_lm, hierarchical_local_sgd,
                adaptive_local_sgd):
        with pytest.raises(RuntimeError, match="no CUDA"):
            mod.main(["--steps", "1"], **QUIET)
