"""Port parity: the tree path across ``torch.distributed`` ranks (CPU,
``gloo``): the reference's default path (``use_kernel=False``, per-leaf
plain PyTorch) and its tree-in/tree-out kernel form (``resident=False``),
each rank holding its workers' rows of the stacked trees.

Three processes run side by side, each with one thread: every run of
``tests/_torch_tree_variants.py`` in one process (``LocalBackend`` /
``SimulatedBackend``), on 4 ranks x 1 worker and on 2 ranks x 2 workers
(``DistributedBackend`` / a ``DistributedBackend`` with the simulated
latency model), in both forms: Alg. 5 blocks of two (across ranks on
four), sign, EF-sign with the wire pack and global momentum, LARS +
EF-sign with telemetry and a checkpoint, W 4 -> 2 -> 4 (on two ranks),
a straggler demoted and promoted back.

* Every rank holds the same losses, comm rounds, decisions, ledger and
  single-copy leaves; the ranks' rows of every stacked leaf, assembled in
  worker order, equal the one-process run's bit for bit, and so do the
  losses, the telemetry summary and ``mean_params`` across ranks: every
  mean adds the workers in worker order (``Collectives.ordered_mean``),
  every sign scale chains the workers' |x| totals in worker order, every
  per-worker value is gathered.
* The ledger's rows are ``measured``.
* The checkpoint ``fit(checkpoint_fn=)`` saves from rank 0 is the
  one-process snapshot member for member; it restores on the ranks that
  saved it (each rank its rows), in one process (where ``pack_state``
  turns it resident) and in the reference.
* Against the reference's one-process tree ``fit`` (its per-leaf bundle
  under ``jax.jit``) from the same weights: losses rtol 2e-4 (its own
  tolerance for its per-leaf and sharded layouts), comm rounds, the sync
  pattern and the worker sets exact.
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
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import local_sgd as tsgd
from repro_torch.launch.steps import build_train
from repro_torch.models import base as tmbase
from repro_torch.utils import tree_leaves

from _torch_family_runs import jit_builder
from _torch_tree_variants import (B, CKPT_RUN, DEMOTE_HEAL, DEMOTE_LATENCY_S,
                                  FORMS, RESIZE, RUNS, SPAWN_RUNS, W,
                                  make_data, make_run)

ROOT = Path(__file__).resolve().parents[1]
SPAWNS = (4, 2)        # ranks: 4 x 1 worker, 2 x 2 workers
SINGLE = ("anchor", "global_u")

_SCRIPT = textwrap.dedent('''
    import json, socket, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, sys.argv[4])
    from _torch_elastic_variants import SimulatedDistributedBackend
    from _torch_tree_variants import (B, CKPT_RUN, CKPT_STEP, DEMOTE_HEAL,
                                      DEMOTE_LATENCY_S, FORMS, RESIZE, RUNS,
                                      SPAWN_RUNS, TIMEOUT_S, W, make_data,
                                      make_run)
    from repro_torch import configs
    from repro_torch.backend.distributed import DistributedBackend
    from repro_torch.backend.local import LocalBackend
    from repro_torch.backend.simulated import SimulatedBackend
    from repro_torch.checkpoint.checkpoint import restore, save
    from repro_torch.configs import base as tcb
    from repro_torch.core.controller import ElasticController
    from repro_torch.core.local_sgd import (is_resident, local_state,
                                            mean_params, state_template)
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.launch import train as ttrain
    from repro_torch.telemetry.stats import round_summary
    from repro_torch.telemetry.trace import Tracer
    from repro_torch.utils import tree_leaves

    FIELDS = ("params", "momentum", "anchor", "global_u", "ef_memory")

    def rows(state, pre=""):
        out = {}
        for f in FIELDS:
            t = getattr(state, f)
            if t is not None:
                for i, x in enumerate(tree_leaves(t)):
                    out[f"{pre}{f}/{i}"] = x.float().numpy().copy()
        return out

    def train(name, params0, backend, out, tag):
        run = make_run(tcb, configs.get_smoke("paper-lm"), name)
        kw = {}
        if name == "resize":
            kw["controller"] = ElasticController(run, resize_at=RESIZE)
        if name == CKPT_RUN:
            path = f"{out}/{tag}.ckpt"
            kw.update(checkpoint_every=CKPT_STEP + 1,
                      checkpoint_fn=lambda st, t: save(path, st, step=t))
        if name == "demote":
            def clear(state):
                backend.latency_s.clear()
                return {}
            kw.update(eval_fn=clear, eval_every=DEMOTE_HEAL)
        tracer = Tracer()
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(make_data(), W, B), backend=backend,
            params0=params0, tracer=tracer, log=lambda *a, **k: None, **kw)
        assert not is_resident(state)
        dist = getattr(backend, "collectives", None)
        meta = {"loss": [h["loss"] for h in hist],
                "synced": [h["synced"] for h in hist],
                "comm_rounds": summ["comm_rounds"], "resizes": summ["resizes"],
                "topology": summ["topology"],
                "worker_sets": summ["ledger"]["worker_sets"],
                "decisions": [sp.attrs for sp in tracer.spans
                              if sp.name == "controller"],
                "ledger": {k: summ["ledger"][k] for k in summ["ledger"]
                           if k not in ("scaling", "sync_seconds")},
                "totals": dist.describe()["totals"] if dist else None}
        if state.stats is not None:
            meta["round_summary"] = round_summary(state.stats, dist=dist)
        arrays = rows(state)
        for i, x in enumerate(tree_leaves(mean_params(state, dist))):
            arrays[f"mean/{i}"] = x.float().numpy().copy()
        if name == CKPT_RUN and dist is not None:
            # the snapshot rank 0 saved, restored on these ranks
            full = restore(f"{out}/{tag.split('.')[0]}.r0.{tag.split('.', 2)[2]}"
                           ".ckpt", state_template(state, dist))
            arrays.update(rows(local_state(full, dist, "cpu"), "restored."))
        np.savez(f"{out}/{tag}.npz", **arrays)
        with open(f"{out}/{tag}.json", "w") as f:
            json.dump(meta, f, default=str)

    def rank(r, port, P, out, params0):
        torch.set_num_threads(1)
        import torch.distributed as dist
        common = dict(backend="gloo", device="cpu", timeout_s=TIMEOUT_S,
                      coordinator_address=f"localhost:{port}", process_id=r,
                      num_processes=P)
        try:
            for form, fkw in FORMS.items():
                for name in SPAWN_RUNS[P]:
                    be = (SimulatedDistributedBackend(
                              W, latency_s={W - 1: DEMOTE_LATENCY_S},
                              **common, **fkw)
                          if name == "demote" else
                          DistributedBackend(W, **common, **fkw))
                    train(name, params0, be, out, f"p{P}.r{r}.{form}.{name}")
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        torch.set_num_threads(1)
        mode, out, params0 = sys.argv[1], sys.argv[2], torch.load(sys.argv[3])
        if mode == "one":
            for form, fkw in FORMS.items():
                for name in RUNS:
                    be = (SimulatedBackend(W, latency_s={W - 1: DEMOTE_LATENCY_S},
                                           device="cpu", **fkw)
                          if name == "demote" else
                          LocalBackend(W, device="cpu", **fkw))
                    train(name, params0, be, out, f"one.{form}.{name}")
        else:
            s = socket.socket()
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
            s.close()
            mp.spawn(rank, args=(port, int(mode), out, params0),
                     nprocs=int(mode))
''')


@pytest.fixture(scope="module")
def ref_params():
    """The reference's weights (its fit's own draw), as the port's tree."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), "alg5")
    jb = jbuild(rj, num_workers=W, use_kernel=False)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    return params_from_reference(jax.tree.map(np.asarray, p0), "cpu")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, ref_params):
    """The one-process runs and both spawns, side by side; the directory
    of their files."""
    root = tmp_path_factory.mktemp("tree_dist")
    script = root / "spawn.py"
    script.write_text(_SCRIPT)
    p0 = root / "params0.pt"
    torch.save(ref_params, p0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), mode, str(root),
                               str(p0), str(ROOT / "tests")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for mode in ("one",) + tuple(str(P) for P in SPAWNS)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
    return root


def _load(d: Path, tag: str):
    return (dict(np.load(d / f"{tag}.npz")),
            json.loads((d / f"{tag}.json").read_text()))


def _assembled(ranks, key):
    """The ranks' rows of a stacked leaf in worker order; a single-copy
    leaf (the same bits on every rank) from rank 0."""
    parts = [a[key] for a, _ in ranks]
    if key.split("/")[0] in SINGLE or key.startswith("mean/"):
        assert all(np.array_equal(parts[0], p) for p in parts[1:]), key
        return parts[0]
    return np.concatenate(parts)


@pytest.mark.parametrize("P,name", [(P, n) for P in SPAWNS
                                    for n in SPAWN_RUNS[P]])
@pytest.mark.parametrize("form", list(FORMS))
def test_tree_ranks_match_one_process(spawned, P, form, name):
    one_a, one_m = _load(spawned, f"one.{form}.{name}")
    ranks = [_load(spawned, f"p{P}.r{r}.{form}.{name}") for r in range(P)]
    metas = [m for _, m in ranks]
    for m in metas[1:]:
        for k in ("loss", "synced", "comm_rounds", "decisions", "ledger",
                  "worker_sets", "round_summary"):
            assert m.get(k) == metas[0].get(k), k
    m = metas[0]
    for k in ("loss", "synced", "comm_rounds", "resizes", "topology",
              "worker_sets", "decisions", "round_summary"):
        assert m.get(k) == one_m.get(k), k
    assert m["ledger"]["cost_sources"] == ["measured"]
    for k in ("sync_rounds", "wire_bytes", "collectives", "topologies"):
        assert m["ledger"][k] == one_m["ledger"][k], k
    keys = [k for k in one_a]
    assert keys and sorted(keys) == sorted(k for k in ranks[0][0]
                                           if not k.startswith("restored."))
    for key in keys:
        got = _assembled(ranks, key)
        assert got.shape == one_a[key].shape, key
        assert np.array_equal(got, one_a[key]), key
    if name == "resize":
        assert m["resizes"] == 2 and sorted(m["worker_sets"]) == ["W=2", "W=4"]
    if name == "demote":
        assert m["comm_rounds"]["block"] > 0
        if P == 4:
            # the blocks of two span two ranks: averaged on sub-groups
            assert m["totals"]["ordered_mean/block"]["calls"] == \
                m["comm_rounds"]["block"]
    if name == "ef_wire_gm":
        # payload and scales gathered; nothing averaged densely
        assert "ordered_mean/global" not in m["totals"]
        assert m["totals"]["all_gather/global"]["calls"] > 0


def _members(path):
    data = np.load(path)
    return {k: data[k].tobytes() for k in data.files}


@pytest.mark.parametrize("form", list(FORMS))
def test_tree_checkpoint_across_ranks(spawned, form):
    """The snapshot rank 0 gathers is the one-process snapshot member for
    member, on 4 and on 2 ranks; each rank restored its rows of it; it
    restores in one process (``pack_state`` turns it resident, EF memory
    float32) and in the reference, member for member."""
    one = spawned / f"one.{form}.{CKPT_RUN}.ckpt"
    want = _members(f"{one}.npz")
    assert any("ef_memory" in k for k in want) and any("stats" in k
                                                       for k in want)
    for P in SPAWNS:
        got = _members(spawned / f"p{P}.r0.{form}.{CKPT_RUN}.ckpt.npz")
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (P, k)
        assert tckpt.load_meta(str(spawned / f"p{P}.r0.{form}.{CKPT_RUN}.ckpt")) \
            == tckpt.load_meta(str(one))
    # every rank's restored rows: its workers' rows of the snapshot
    tb = build_train(make_run(tcb, tconfigs.get_smoke("paper-lm"), CKPT_RUN),
                     num_workers=W, device="cpu", **FORMS[form])
    full = tckpt.restore(str(one), tb.init(tmbase.materialize(
        tb.specs, torch.Generator().manual_seed(0), "cpu")))
    for P in SPAWNS:
        wl = W // P
        for r in range(P):
            a, _ = _load(spawned, f"p{P}.r{r}.{form}.{CKPT_RUN}")
            for f in ("params", "momentum", "anchor", "ef_memory"):
                for i, x in enumerate(tree_leaves(getattr(full, f))):
                    want_rows = x if f == "anchor" else x[r * wl:(r + 1) * wl]
                    assert np.array_equal(a[f"restored.{f}/{i}"],
                                          want_rows.float().numpy()), (P, r, f)
    res = tsgd.pack_state(full)
    assert tsgd.is_resident(res)
    assert res.ef_memory.buckets[0].dtype == torch.float32
    # the reference restores it member for member
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), CKPT_RUN)
    jb = jbuild(rj, num_workers=W, use_kernel=False, jit=False)
    js = jb.init(jax.random.PRNGKey(0),
                 jmbase.materialize(jb.specs, jax.random.PRNGKey(0)))
    jtmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    back = jckpt.restore(str(one), jtmpl)
    assert int(back.step) == full.step
    for f in ("params", "momentum", "anchor", "ef_memory"):
        for x, y in zip(jax.tree.leaves(getattr(back, f)),
                        tree_leaves(getattr(full, f))):
            assert np.array_equal(np.asarray(x, np.float32),
                                  y.float().numpy()), f


def _jfit(name):
    """The reference's one-process tree fit of run ``name``."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), name)
    kw = {}
    if name == "demote":
        be = JSimulatedBackend(W, latency_s={W - 1: DEMOTE_LATENCY_S},
                               build_fn=jit_builder)

        def heal(state):
            be.latency_s.clear()
            return {}
        kw.update(eval_fn=heal, eval_every=DEMOTE_HEAL)
    else:
        be = JLocalBackend(W, build_fn=jit_builder)
    if name == "resize":
        kw["controller"] = jctl.ElasticController(rj, resize_at=RESIZE)
    # seed 0: the weights ref_params holds
    _, jhist, jsum = jtrain.fit(rj, JBatches(make_data(), W, B), backend=be,
                                seed=0, log=lambda *a: None, **kw)
    return jhist, jsum


@pytest.mark.parametrize("name", RUNS)
def test_tree_dist_matches_reference(spawned, name):
    """The 4-rank runs of both forms (the resize's 2-rank runs) against
    the reference's one-process tree fit from the same weights."""
    jhist, jsum = _jfit(name)
    P = 4 if name in SPAWN_RUNS[4] else 2
    for form in FORMS:
        m = _load(spawned, f"p{P}.r0.{form}.{name}")[1]
        assert m["comm_rounds"] == jsum["comm_rounds"], form
        assert m["synced"] == [h["synced"] for h in jhist], form
        assert m["worker_sets"] == jsum["ledger"]["worker_sets"], form
        np.testing.assert_allclose(m["loss"], [h["loss"] for h in jhist],
                                   rtol=2e-4, err_msg=form)
