"""Port parity: the worker axis across ``torch.distributed`` ranks (CPU,
``gloo``), against the port's one-process run and the reference's ``fit``.

Two spawns, each one subprocess running ``mp.spawn`` (as
``tests/test_torch_backend.py``'s two-process test does): 4 ranks x 1
worker and 2 ranks x 2 workers, each training paper-lm smoke for 8
steps (post-local SGD, H=2) in eight variants through
``DistributedBackend.build`` and ``fit``: mean sync flat and Alg. 5
(block 2: across ranks in the first spawn, inside a rank in the second),
sign, EF-sign, EF-sign + ``wire_pack``, global momentum, LARS + EF-sign
with telemetry, and the ``auto_compress`` controller.  The subprocess
also runs every variant in one process at W=4, with one thread as the
ranks have, and keeps what each run ends with.

* The ranks' buckets, assembled into ``(W, ...)``, equal the one-process
  run's bit for bit where no all-reduce enters (the wire pack's gathers:
  the whole EF-sign + ``wire_pack`` run; the first Alg. 5 block sync, a
  mean of two), within 1e-6 of the largest entry elsewhere (an
  all-reduce sums in another order).
* Losses, comm rounds and controller decisions are identical on every
  rank; losses within 1e-6 of the one-process run's (equal for the wire
  pack), decisions equal.
* The ledger's rows are ``measured``: their bytes equal the bytes the
  ranks handed to each collective (W x (rows x 16 + 4 x leaves) a
  wire-packed sync, P x the bucket a dense one).
* The distributed run against the reference's ``fit`` from the same
  weights, at ``tests/test_torch_fit.py``'s tolerances: losses rtol 1e-5,
  comm rounds, the sync pattern and the ledger's ring-model rows exact.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf
from repro_torch.launch.steps import build_train as tbuild

from _torch_dist_variants import B, STEPS, VARIANTS, W, make_data, make_run

ROOT = Path(__file__).resolve().parents[1]
SPAWNS = (4, 2)        # ranks: 4 x 1 worker, 2 x 2 workers
BITWISE = ("ef_sign_wire",)
DENSE = ("mean", "alg5", "global_momentum")
# sign flips a run may take against the one-process run (measured up to
# 1.1e-3 of the elements in 8 steps at lr 0.3, H=2)
FLIP_FRAC = 2e-3


# every rank (and the one-process oracle) trains each variant through fit
# with a Tracer, whose controller spans carry the decisions
_SCRIPT = textwrap.dedent('''
    import json, socket, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, sys.argv[4])
    from _torch_dist_variants import B, VARIANTS, W, make_data, make_run
    from repro_torch import configs
    from repro_torch.configs import base as tcb
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.launch import train as ttrain
    from repro_torch.telemetry.trace import Tracer

    def train(name, params0, build):
        run = make_run(tcb, configs.get_smoke("paper-lm"), name)
        bundle, backend = build(run)
        first = []

        def snap(state):
            if not first:           # after step 0 (and its sync)
                first.append(state.params.buckets[0].numpy().copy())
            return {}
        tracer = Tracer()
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(make_data(), W, B), bundle=bundle,
            backend=backend, params0=params0, eval_every=1, eval_fn=snap,
            tracer=tracer, log=lambda *a: None)
        arrays = {"first": first[0]}
        for f in ("params", "momentum", "anchor", "ef_memory", "global_u"):
            bs = getattr(state, f)
            if bs is not None:
                arrays[f] = bs.buckets[0].float().numpy()
        ctl = [sp.attrs for sp in tracer.spans if sp.name == "controller"]
        meta = {"loss": [h["loss"] for h in hist],
                "synced": [h["synced"] for h in hist],
                "comm_rounds": summ["comm_rounds"],
                "controller": summ["controller"], "decisions": ctl,
                "ledger": {k: summ["ledger"][k] for k in summ["ledger"]
                           if k not in ("scaling", "sync_seconds")},
                "totals": (bundle.dist.describe()["totals"]
                           if bundle.dist is not None else None)}
        return arrays, meta

    def save(out, tag, name, arrays, meta):
        np.savez(f"{out}/{tag}.{name}.npz", **arrays)
        with open(f"{out}/{tag}.{name}.json", "w") as f:
            json.dump(meta, f, default=str)

    def rank(r, port, P, out, params0):
        torch.set_num_threads(1)
        from repro_torch.backend.distributed import DistributedBackend
        be = DistributedBackend(W, backend="gloo", device="cpu",
                                coordinator_address=f"localhost:{port}",
                                process_id=r, num_processes=P)
        try:
            for name in VARIANTS:
                save(out, f"r{r}", name,
                     *train(name, params0, lambda run: (be.build(run), be)))
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()

    if __name__ == "__main__":
        torch.set_num_threads(1)
        P, out, params0 = int(sys.argv[1]), sys.argv[2], torch.load(sys.argv[3])
        from repro_torch.launch.steps import build_train
        for name in VARIANTS:
            save(out, "one", name, *train(
                name, params0,
                lambda run: (build_train(run, num_workers=W, device="cpu"), None)))
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(rank, args=(port, P, out, params0), nprocs=P)
''')


@pytest.fixture(scope="module")
def ref_params():
    """The reference's weights (its fit's own draw), as the port's tree."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), "mean")
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    return params_from_reference(jax.tree.map(np.asarray, p0), "cpu")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, ref_params):
    """Run both spawns; {P: {tag: {variant: (arrays, meta)}}}."""
    root = tmp_path_factory.mktemp("dist")
    script = root / "spawn.py"
    script.write_text(_SCRIPT)
    p0 = root / "params0.pt"
    torch.save(ref_params, p0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for P in SPAWNS:
        d = root / f"P{P}"
        d.mkdir()
        res = subprocess.run([sys.executable, str(script), str(P), str(d),
                              str(p0), str(ROOT / "tests")],
                             capture_output=True, text=True, env=env,
                             timeout=120)
        assert res.returncode == 0, res.stderr[-4000:]
        out[P] = {tag: {name: (dict(np.load(d / f"{tag}.{name}.npz")),
                               json.loads((d / f"{tag}.{name}.json").read_text()))
                        for name in VARIANTS}
                  for tag in ["one"] + [f"r{r}" for r in range(P)]}
    return out


def _same_decision(got, want):
    """Equal structure and values; the sensors' floats within 1e-5."""
    if isinstance(want, dict):
        assert set(got) == set(want), (set(got), set(want))
        for k in want:
            _same_decision(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_decision(g, w)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        assert got == want, (got, want)


def _assembled(res, P, name, field):
    """The ranks' rows of a stacked field in worker order; a single-copy
    field (anchor, global momentum) from the last rank, which holds the
    same bits as every other."""
    parts = [res[f"r{r}"][name][0][field] for r in range(P)]
    if field in ("anchor", "global_u"):
        assert all(np.array_equal(parts[0], p) for p in parts[1:]), field
        return parts[-1]
    return np.concatenate(parts)


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("P", SPAWNS)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_ranks_match_one_process(spawned, P, name):
    res = spawned[P]
    one_a, one_m = res["one"][name]
    metas = [res[f"r{r}"][name][1] for r in range(P)]
    # every rank holds the same numbers
    for m in metas[1:]:
        for k in ("loss", "synced", "comm_rounds", "controller", "decisions",
                  "ledger"):
            assert m[k] == metas[0][k], k
    m = metas[0]
    assert m["comm_rounds"] == one_m["comm_rounds"]
    assert m["synced"] == one_m["synced"]
    assert m["controller"] == one_m["controller"]
    # decisions: every field but the sensors' floats equal, those 1e-5
    assert len(m["decisions"]) == len(one_m["decisions"]) == \
        m["comm_rounds"]["global"]
    for got, want in zip(m["decisions"], one_m["decisions"]):
        _same_decision(got, want)
    if name in BITWISE:
        assert m["loss"] == one_m["loss"]
        for f in one_a:
            assert np.array_equal(_assembled(res, P, name, f), one_a[f]), f
        return
    # the first sync agrees to a rounding: an all-reduce sums in another
    # order than one process does
    assert _close(_assembled(res, P, name, "first"), one_a["first"], 1e-6)
    if name in DENSE:
        np.testing.assert_allclose(m["loss"], one_m["loss"], rtol=1e-6)
        # the synced model within 1e-6 of its largest entry; momentum and
        # global momentum, which sum gradients of the models those
        # roundings moved, within 1e-5 (measured up to 2.2e-6)
        for f, rel in (("params", 1e-6), ("anchor", 1e-6),
                       ("momentum", 1e-5), ("global_u", 1e-5)):
            if f in one_a:
                got = _assembled(res, P, name, f)
                assert _close(got, one_a[f], rel), (f, np.abs(got - one_a[f]).max())
        return
    # sign modes without the wire pack: the mean of +-scale values rounds
    # in the all-reduce's order, and a delta within that rounding of 0
    # takes the other sign and moves its element by a whole scale (as on
    # the card against the CPU): losses within test_torch_fit's 1e-5, all
    # but FLIP_FRAC of the model's elements within 1e-6 of the largest
    np.testing.assert_allclose(m["loss"], one_m["loss"], rtol=1e-5)
    for f in ("params", "anchor"):
        got, want = _assembled(res, P, name, f), one_a[f]
        frac = float((np.abs(got - want) > 1e-6 * np.abs(want).max()).mean())
        assert frac <= FLIP_FRAC, (f, frac)


@pytest.mark.parametrize("P", SPAWNS)
def test_first_block_sync_bit_for_bit(spawned, P):
    """Alg. 5's first sync (step 0) is a block mean of two workers: across
    ranks (P=4) a two-member all-reduce, inside a rank (P=2) the
    one-process reshape-mean: the same bits either way."""
    res = spawned[P]
    assert res["one"]["alg5"][1]["synced"][0] == "block"
    got = np.concatenate([res[f"r{r}"]["alg5"][0]["first"] for r in range(P)])
    assert np.array_equal(got, res["one"]["alg5"][0]["first"])
    # the mean flat run's first sync is a global all-reduce: close, and
    # workers agree after it
    got = np.concatenate([res[f"r{r}"]["mean"][0]["first"] for r in range(P)])
    assert _close(got, res["one"]["mean"][0]["first"], 1e-6)
    assert all(np.array_equal(got[0], g) for g in got[1:])


@pytest.mark.parametrize("P", SPAWNS)
def test_ledger_measured_bytes(spawned, P):
    """Every row of a distributed run is measured, and its bytes are the
    bytes the ranks handed to the stage's collectives."""
    run = make_run(tcb, tconfigs.get_smoke("paper-lm"), "mean")
    layout = tbuild(run, num_workers=W, device="cpu").layout
    rows = layout.bucket_rows[0]
    bucket = rows * flatbuf.LANE * 4
    packed = rows * flatbuf.LANE // 8 + 4 * len(layout.bucket_slots(0))
    res = spawned[P]
    for name in VARIANTS:
        m = res["r0"][name][1]
        led, one = m["ledger"], res["one"][name][1]["ledger"]
        assert led["cost_sources"] == ["measured"], name
        assert one["cost_sources"] == ["analytic"] and "measured_bytes" not in one
        # the ring model's rows are the one-process run's
        for k in ("sync_rounds", "wire_bytes", "collectives", "topologies"):
            assert led[k] == one[k], (name, k)
        # a block inside a rank (P=2) hands nothing to a collective
        rounds = m["comm_rounds"]["global"] + (
            m["comm_rounds"]["block"] if P == 4 else 0)
        per_round = W * packed if name == "ef_sign_wire" else P * bucket
        assert led["measured_bytes"] == rounds * per_round, name
        tot = m["totals"]
        if name == "ef_sign_wire":
            # payload and scales gathered, nothing all-reduced in a sync
            assert tot["all_gather/global"]["bytes"] * P == rounds * W * packed
            assert "all_reduce/global" not in tot
        else:
            ar = tot["all_reduce/global"]["bytes"] + \
                tot.get("all_reduce/block", {"bytes": 0})["bytes"]
            assert ar * P == rounds * P * bucket, name
        if name == "alg5":
            blocks = m["comm_rounds"]["block"]
            assert blocks == 3
            assert ("all_reduce/block" in tot) == (P == 4)   # P=2: in-rank
        # the per-step loss and metrics gather: one a step
        assert tot["all_gather/metrics"]["calls"] == STEPS


@pytest.mark.parametrize("name", list(VARIANTS))
def test_distributed_matches_reference(spawned, ref_params, name):
    """The 4-rank run against the reference's fit from the same weights
    (its Pallas kernels in interpret mode), at test_torch_fit's
    tolerances."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), name)
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(make_data(), W, B), bundle=jb, seed=0,
                                log=lambda *a: None)
    m = spawned[4]["r0"][name][1]
    assert m["comm_rounds"] == jsum["comm_rounds"]
    assert m["synced"] == [h["synced"] for h in jhist]
    np.testing.assert_allclose(m["loss"], [h["loss"] for h in jhist], rtol=1e-5)
    assert m["controller"] == jsum["controller"]
    rows = lambda led: {k: {f: v[f] for f in ("rounds", "wire_bytes",
                                              "collectives")}
                        for k, v in led["topologies"].items()}
    assert rows(m["ledger"]) == rows(jsum["ledger"])


def test_torchrun_cli():
    """The launch line the backend's message gives, on the CPU: two ranks
    of two workers; rank 0 alone prints, and its last line shows the comm
    rounds and measured ledger rows."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(port), "-m", "repro_torch.launch.train",
         "--backend", "distributed", "--device", "cpu", "--smoke",
         "--steps", "4", "--seq", "32", "--local-batch", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert sum(ln.startswith("done:") for ln in lines) == 1   # rank 0 only
    last = lines[-1]
    assert last.startswith("done:") and "comm={'block': 0, 'global': 1}" in last
    assert "cost_sources=['measured']" in last and "'ranks': 2" in last
