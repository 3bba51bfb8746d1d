"""Port parity: workers split over shard ranks (``DistributedBackend(
within_worker_size=2)``, CPU, ``gloo``), against the port's one-process
run of the same sharded layout and the reference's ``fit``.

One spawn: a subprocess runs ``mp.spawn`` of 4 ranks = 2 workers x 2
shards (rank = group * 2 + shard), each training paper-lm smoke for 8
steps (post-local SGD, H=2) under the tensor-parallel and the FSDP
layout (sizes {data: 2, model: 2}: a ("model",) sub-bucket and a
replicated one) in three variants through ``DistributedBackend.build``
and ``fit``: SGD + clip with the mean sync, EF-sign + ``wire_pack`` +
``sync_coalesce`` (the two f32 sub-buckets in one payload gather), and
LARS + EF-sign with telemetry.  The subprocess first runs every one in
one process (``build_train(layout=)``), with one thread as the ranks
have.

* Every rank's buckets against the matching rows of the one-process
  buckets (its shard's region of a sharded sub-bucket, its workers):
  tensor parallel, where the batch is not split, within 1e-6 of the
  largest entry (measured: bit for bit, since every sum that crosses
  ranks adds what one process adds in the same order); FSDP, whose
  shard ranks differentiate half a batch each and average, within
  ``FSDP_REL`` (measured up to 1.9e-6, on momentum).  Under FSDP an
  EF-sign sync flips the sign of some deltas near 0 that the split
  batch's rounding moved between syncs: along the trajectory params and
  anchor may have ``FLIP_FRAC`` of their elements beyond ``FSDP_REL``.
  So every FSDP EF-sign sync is also held on the one-process run's own
  pre-sync state: all four fields within 1e-6 (EF memory 1e-5), no
  element flipped.
* Losses equal on every rank; against the one-process run 1e-6 (TP) or
  ``FSDP_REL`` relative (measured 0 and 3.1e-6); round summaries within
  1e-5, 1e-3 in a run with flips.
* The ledger's rows are ``measured``: P x the bytes one rank handed to
  the sync's collectives, shard-local rows of the sharded sub-bucket;
  the within-worker gathers and reduce-scatters are counted under
  ``within`` and never in a sync row; the ring-model rows equal the
  one-process run's.
* Against the reference's ``fit`` on its meshless per-leaf bundle from the
  same weights: losses at the reference's own tolerance for its sharded
  layouts (rtol 2e-4, ``tests/test_sharded_subbuckets.py``), comm rounds
  and the sync pattern exact.
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
from repro_torch.sharding import layout as tlayout
from repro_torch.telemetry.ledger import _ring_bytes

from _torch_sharded_variants import (B, KINDS, S, SIZES, STEPS, VARIANTS, W,
                                     make_data, make_run, mesh_layout)

ROOT = Path(__file__).resolve().parents[1]
P = W * S
FIELDS = ("params", "momentum", "anchor", "ef_memory")
FSDP_REL = 1e-5
# share of params and anchor elements an FSDP EF-sign run may move by a
# flip (measured 41 to 49 of a rank's 399,360 in the LARS run, 1.2e-4)
FLIP_FRAC = 5e-4

_SCRIPT = textwrap.dedent('''
    import json, socket, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, sys.argv[3])
    from _torch_sharded_variants import (B, KINDS, S, SIZES, VARIANTS, W,
                                         make_data, make_run, mesh_layout)
    from repro_torch import configs
    from repro_torch.configs import base as tcb
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.launch import train as ttrain
    from repro_torch.sharding import layout as tlayout
    from repro_torch.telemetry.stats import round_summary

    FIELDS = ("params", "momentum", "anchor", "ef_memory")
    PINNED = {("fsdp", "ef_sign_wire_coalesce"), ("fsdp", "lars_ef_sign")}

    def train(name, params0, bundle, backend):
        run = make_run(tcb, configs.get_smoke("paper-lm"), name)
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(make_data(), W, B), bundle=bundle,
            backend=backend, params0=params0, log=lambda *a: None)
        arrays = {}
        for f in FIELDS:
            bs = getattr(state, f)
            if bs is not None:
                for b, x in enumerate(bs.buckets):
                    arrays[f"{f}.{b}"] = x.float().numpy()
        meta = {"loss": [h["loss"] for h in hist],
                "synced": [h["synced"] for h in hist],
                "comm_rounds": summ["comm_rounds"],
                "ledger": {k: summ["ledger"][k] for k in summ["ledger"]
                           if k not in ("scaling", "sync_seconds")},
                "bucket_shards": list(state.params.layout.bucket_shards),
                "local_rows": [state.params.layout.bucket_local_rows(b) for b
                               in range(state.params.layout.num_buckets)],
                "totals": (bundle.dist.describe()["totals"]
                           if bundle.dist is not None else None)}
        if bundle.telemetry:
            meta["round_summary"] = round_summary(state.stats, dist=bundle.dist)
        return arrays, meta

    def snap(state):
        return {f"{f}.{b}": x.float().numpy().copy() for f in FIELDS
                if getattr(state, f) is not None
                for b, x in enumerate(getattr(state, f).buckets)}

    def pin(bundle, out, kind, name):
        """Keep the pre- and post-sync state of every sync of this
        one-process run (``pin.<kind>.<name>.npz``)."""
        sync, kept = bundle.sync, {}

        def pinned(state, *, plan=None, scope="global"):
            i = sum(k.endswith(".pre.params.0") for k in kept)
            kept.update({f"{i}.pre.{k}": v for k, v in snap(state).items()})
            state = sync(state, plan=plan, scope=scope)
            kept.update({f"{i}.post.{k}": v for k, v in snap(state).items()})
            np.savez(f"{out}/pin.{kind}.{name}.npz", **kept)
            return state
        bundle.sync = pinned
        return bundle

    def replay(out, kind, name, bundle, state, r):
        """Every pinned sync on this rank: its rows of the one-process
        pre-sync state through the rank's sync; the rows after it."""
        import dataclasses
        from repro_torch.core import flatbuf
        from repro_torch.core.local_sgd import LocalSGDState, local_state
        kept = dict(np.load(f"{out}/pin.{kind}.{name}.npz"))
        lay = state.params.layout
        got, i = {}, 0
        while f"{i}.pre.params.0" in kept:
            full = {}
            for f in FIELDS:
                if getattr(state, f) is None:
                    full[f] = None
                    continue
                bufs = [torch.from_numpy(kept[f"{i}.pre.{f}.{b}"]).to(
                            getattr(state, f).buckets[b].dtype)
                        for b in range(lay.num_buckets)]
                full[f] = flatbuf.BucketState(lay, tuple(bufs),
                                              leading=0 if f == "anchor" else 1)
            st = local_state(LocalSGDState(global_u=None, step=state.step,
                                           rng=state.rng, stats=None, **full),
                             bundle.dist, "cpu")
            st = dataclasses.replace(st, stats=state.stats)
            st = bundle.sync(st, plan=bundle.sync_plan, scope="global")
            got.update({f"{i}.{k}": v for k, v in snap(st).items()})
            i += 1
        np.savez(f"{out}/r{r}.pinned.{kind}.{name}.npz", **got)

    def save(out, tag, kind, name, arrays, meta):
        np.savez(f"{out}/{tag}.{kind}.{name}.npz", **arrays)
        with open(f"{out}/{tag}.{kind}.{name}.json", "w") as f:
            json.dump(meta, f, default=str)

    def rank(r, port, out, params0):
        torch.set_num_threads(1)
        from repro_torch.backend.distributed import DistributedBackend
        import torch.distributed as dist
        try:
            for kind in KINDS:
                be = DistributedBackend(W, backend="gloo", device="cpu",
                                        coordinator_address=f"localhost:{port}",
                                        process_id=r, num_processes=W * S,
                                        within_worker_size=S,
                                        layout=mesh_layout(tlayout, kind))
                for name in VARIANTS:
                    run = make_run(tcb, configs.get_smoke("paper-lm"), name)
                    bundle = be.build(run)
                    arrays, meta = train(name, params0, bundle, be)
                    save(out, f"r{r}", kind, name, arrays, meta)
                    if (kind, name) in PINNED:
                        replay(out, kind, name, bundle,
                               bundle.init(params0), r)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        torch.set_num_threads(1)
        out, params0 = sys.argv[1], torch.load(sys.argv[2])
        from repro_torch.launch.steps import build_train
        for kind in KINDS:
            lay = mesh_layout(tlayout, kind).with_sizes(SIZES)
            for name in VARIANTS:
                run = make_run(tcb, configs.get_smoke("paper-lm"), name)
                bundle = build_train(run, num_workers=W, device="cpu",
                                     layout=lay)
                if (kind, name) in PINNED:
                    pin(bundle, out, kind, name)
                save(out, "one", kind, name,
                     *train(name, params0, bundle, None))
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(rank, args=(port, out, params0), nprocs=W * S)
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
    """{tag: {(kind, variant): (arrays, meta)}} for "one" and "r0".."r3"."""
    root = tmp_path_factory.mktemp("sharded")
    script = root / "spawn.py"
    script.write_text(_SCRIPT)
    p0 = root / "params0.pt"
    torch.save(ref_params, p0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(script), str(root), str(p0),
                          str(ROOT / "tests")],
                         capture_output=True, text=True, env=env, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    out = {tag: {(k, n): (dict(np.load(root / f"{tag}.{k}.{n}.npz")),
                          json.loads((root / f"{tag}.{k}.{n}.json").read_text()))
                 for k in KINDS for n in VARIANTS}
           for tag in ["one"] + [f"r{r}" for r in range(P)]}
    out["root"] = root
    return out


def _rows(one, field, b, r, meta):
    """The rows of the one-process bucket ``field.b`` that rank ``r``
    holds: its worker group's workers, its shard's region of a sharded
    sub-bucket."""
    g, s = divmod(r, S)
    x = one[f"{field}.{b}"]
    if field != "anchor":
        x = x[g * (W // (P // S)):(g + 1) * (W // (P // S))]
    if meta["bucket_shards"][b] > 1:
        lr = meta["local_rows"][b]
        x = x[..., s * lr:(s + 1) * lr, :]
    return x


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_ranks_match_one_process(spawned, kind, name):
    one_a, one_m = spawned["one"][(kind, name)]
    assert sorted(one_m["bucket_shards"]) == [1, 2]
    metas = [spawned[f"r{r}"][(kind, name)][1] for r in range(P)]
    for m in metas[1:]:
        for k in ("loss", "synced", "comm_rounds", "ledger"):
            assert m[k] == metas[0][k], k
    m = metas[0]
    assert m["comm_rounds"] == one_m["comm_rounds"]
    assert m["synced"] == one_m["synced"]
    rel = 1e-6 if kind == "tp" else FSDP_REL
    np.testing.assert_allclose(m["loss"], one_m["loss"], rtol=rel)
    # under FSDP an EF-sign sync meets deltas that the split batch's
    # rounding moved near 0: some take the other sign and move their
    # element by a whole scale, and momentum and EF memory then integrate
    # the gradients of models those flips moved, so only params and the
    # anchor are held there, in elements beyond FSDP_REL
    flips = kind == "fsdp" and \
        VARIANTS[name][0].get("sync_compression", "none") != "none"
    moved, total = 0, 0
    for r in range(P):
        arrays = spawned[f"r{r}"][(kind, name)][0]
        for key, got in arrays.items():
            field, b = key.split(".")
            want = _rows(one_a, field, int(b), r, one_m)
            assert got.shape == want.shape, (key, r)
            if not flips:
                assert _rel(got, want) <= rel, (key, r, _rel(got, want))
            elif field in ("params", "anchor"):
                scale = max(float(np.abs(want).max()), 1e-30)
                moved += int((np.abs(got - want) > rel * scale).sum())
                total += got.size
    assert moved <= FLIP_FRAC * max(total, 1), (moved, total)
    # a worker's two shard ranks hold its replicated sub-bucket alike
    for g in range(P // S):
        a = spawned[f"r{g * S}"][(kind, name)][0]
        c = spawned[f"r{g * S + 1}"][(kind, name)][0]
        for key in a:
            if one_m["bucket_shards"][int(key.split(".")[1])] == 1:
                assert np.array_equal(a[key], c[key]), key
    if "round_summary" in one_m:
        got, want = m["round_summary"], one_m["round_summary"]
        assert got["num_workers"] == want["num_workers"] == W
        assert got["rounds"] == want["rounds"]
        # the flips move the gradients of the next steps: 1e-3 there
        # (measured 7.0e-5, on grad_sq), 1e-5 elsewhere (measured 0)
        rtol = 1e-3 if flips else 1e-5
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-12,
                                           err_msg=k)


@pytest.mark.parametrize("name", ["ef_sign_wire_coalesce", "lars_ef_sign"])
def test_fsdp_ef_sign_syncs_on_the_one_process_state(spawned, name):
    """FSDP + EF-sign, every sync held on the one-process run's own
    pre-sync state (each rank's rows of it through the rank's sync), so
    that the split batch's drift between syncs does not enter: params,
    momentum, anchor and EF memory against the one-process post-sync rows
    at 1e-6 of the largest entry (EF memory 1e-5).  Sign flips are counted
    as elements beyond that: the compressor's inputs and per-leaf totals
    are the one process's, bit for bit, so none flips (measured 0)."""
    root = spawned["root"]
    one_m = spawned["one"][("fsdp", name)][1]
    kept = dict(np.load(root / f"pin.fsdp.{name}.npz"))
    syncs = one_m["comm_rounds"]["global"]
    assert f"{syncs - 1}.post.params.0" in kept and f"{syncs}.pre.params.0" \
        not in kept
    flips = 0
    for r in range(P):
        got = dict(np.load(root / f"r{r}.pinned.fsdp.{name}.npz"))
        assert len(got) == sum(1 for k in kept if ".post." in k)
        for key, x in got.items():
            i, field, b = key.split(".")
            want = _rows({f"{field}.{b}": kept[f"{i}.post.{field}.{b}"]},
                         field, int(b), r, one_m)
            assert x.shape == want.shape, key
            rel = 1e-5 if field == "ef_memory" else 1e-6
            scale = max(float(np.abs(want).max()), 1e-30)
            flips += int((np.abs(x - want) > rel * scale).sum())
    assert flips == 0, flips


@pytest.mark.parametrize("kind", KINDS)
def test_measured_bytes_shard_local(spawned, kind):
    """Ledger rows: P x the bytes one rank handed over, on shard-local rows
    of the sharded sub-bucket; the within-worker traffic under ``within``
    only; the ring model priced on shard-local rows."""
    m0 = spawned["r0"][(kind, "mean")][1]
    shards, lrows = m0["bucket_shards"], m0["local_rows"]
    wl = W // (P // S)
    sharded = [b for b in range(2) if shards[b] > 1][0]
    rep = 1 - sharded
    rows_held = lrows[sharded] + lrows[rep]
    run = make_run(tcb, tconfigs.get_smoke("paper-lm"), "mean")
    lay = mesh_layout(tlayout, kind).with_sizes(SIZES)
    blay = tbuild(run, num_workers=W, device="cpu", layout=lay).layout
    nseg = sum(len(blay.bucket_slots(b)) for b in range(2))
    for name in VARIANTS:
        m = spawned["r0"][(kind, name)][1]
        one = spawned["one"][(kind, name)][1]
        led, tot = m["ledger"], m["totals"]
        assert led["cost_sources"] == ["measured"]
        for k in ("sync_rounds", "wire_bytes", "collectives", "topologies"):
            assert led[k] == one["ledger"][k], (name, k)
        rounds = m["comm_rounds"]["global"]
        if name == "ef_sign_wire_coalesce":
            per_rank = wl * rows_held * 16 + wl * nseg * 4
            # one coalesced stage: one payload and one scale gather a round
            assert tot["all_gather/global"]["calls"] == 2 * rounds
            ring = (_ring_bytes("all-gather", W * rows_held * 16, W)
                    + _ring_bytes("all-gather", W * nseg * 4, W))
            assert led["wire_bytes"] == pytest.approx(rounds * ring)
        else:
            # the ordered mean over the G = 2 worker-group ranks, one
            # worker a rank: the chunk sent and gathered, the whole rows
            per_rank = rows_held * flatbuf.LANE * 4
            assert tot["ordered_mean/global"]["bytes"] == rounds * per_rank
        assert led["measured_bytes"] == rounds * P * per_rank, name
        # the local step's gather of the sharded bucket, once a step
        g = tot["all_gather/within"]
        assert g["calls"] == STEPS
        assert g["bytes"] == STEPS * wl * lrows[sharded] * flatbuf.LANE * 4
        if kind == "fsdp":
            rs = tot["reduce_scatter/within"]
            assert rs["calls"] == STEPS
            assert rs["bytes"] == STEPS * S * wl * lrows[sharded] * flatbuf.LANE * 4
            assert tot["all_reduce/within"]["bytes"] == \
                STEPS * wl * lrows[rep] * flatbuf.LANE * 4
        else:
            assert "reduce_scatter/within" not in tot
            assert "all_reduce/within" not in tot


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_ranks_match_reference(spawned, ref_params, name):
    """Both layouts' 4-rank runs against the reference's fit on its
    meshless per-leaf bundle from the same weights (its own rtol 2e-4)."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), name)
    jb = jbuild(rj, num_workers=W, use_kernel=False)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(make_data(), W, B), bundle=jb,
                                seed=0, log=lambda *a: None)
    for kind in KINDS:
        m = spawned["r0"][(kind, name)][1]
        assert m["comm_rounds"] == jsum["comm_rounds"]
        assert m["synced"] == [h["synced"] for h in jhist]
        np.testing.assert_allclose(m["loss"], [h["loss"] for h in jhist],
                                   rtol=2e-4)


def test_worker_layout_grid():
    """rank = group * S + shard: workers, shard groups, worker groups."""
    lay = [tlayout.WorkerLayout(4, 8, r, within_worker_size=2) for r in range(8)]
    assert [l.worker_ids for l in lay[:4]] == [(0,), (0,), (1,), (1,)]
    assert lay[5].shard_group_ranks() == (4, 5)
    assert lay[5].worker_group_ranks() == (1, 3, 5, 7)
    assert lay[5].group == 2 and lay[5].shard == 1
    assert lay[5].block_ranks(2) == ((1, 3), (5, 7))
    assert lay[5].block_ranks(2, shard=0) == ((0, 2), (4, 6))
    assert not lay[0].block_is_local(2)
    with pytest.raises(ValueError, match="P % S"):
        tlayout.WorkerLayout(4, 6, 0, within_worker_size=4)
    with pytest.raises(ValueError, match="W % P"):
        tlayout.WorkerLayout(3, 4, 0, within_worker_size=2)
