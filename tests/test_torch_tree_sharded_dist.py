"""Port parity: the tree path with each worker split over shard ranks
(``DistributedBackend(use_kernel=False | resident=False,
within_worker_size=2)``, CPU, ``gloo``), against the port's one-process
tree run of the same sharded layout and the reference's tree ``fit``.

One subprocess runs every run of ``tests/_torch_tree_sharded_variants.py``
in one process (``build_train(layout=)``, one thread), then ``mp.spawn``
of 4 ranks = 2 workers x 2 shards (rank = group * 2 + shard), each
training paper-lm smoke for 8 steps (post-local SGD, H=2) under the
tensor-parallel and the FSDP layout (sizes {data: 2, model: 2}), in both
forms of the tree path (per-leaf plain PyTorch, and the tree-in/tree-out
kernel form), in three variants: SGD + clip with the mean sync, EF-sign +
``wire_pack``, LARS + EF-sign with telemetry; and one resize, W 2 -> 4.
A rank holds its workers' rows of every stacked leaf, its shard's slice
of every sharded leaf (the anchor too), and the replicated leaves whole.

* Every rank's leaves against the matching slices of the one-process
  leaves (its workers' rows, its shard's block of each sharded dim, cut
  here with numpy): tensor parallel, where every shard rank
  differentiates the whole batch, bit for bit, losses and the telemetry
  summary too, since every sum over a sharded leaf adds its slices'
  partials in shard order on the ranks and in one process; FSDP, whose
  shard ranks differentiate half a batch each and average, within
  ``FSDP_REL`` of the largest entry, losses within ``FSDP_REL``
  relative.  Under FSDP an EF-sign sync flips deltas near 0 that the split
  batch's rounding moved between syncs: params and anchor may have
  ``FLIP_FRAC`` of their elements beyond ``FSDP_REL``, and the telemetry
  summary is held at 1e-3.  So every FSDP EF-sign sync is also held on
  the one-process run's own pre-sync state: all four fields within 1e-6
  of the largest entry (EF memory 1e-5), no element beyond.
* A rank's sharded leaves are 1/S of the one-process shapes; a worker's
  shard ranks hold its replicated leaves alike.
* The ledger's rows are ``measured``: P x the bytes one rank handed to the
  sync's collectives; the within-worker gathers (and FSDP's
  reduce-scatters and all-reduces), one a step of the dtype's slices, are
  counted under ``within`` with the slices' bytes and never in a sync row.
* A checkpoint's gather (``gather_state``) and restore (``local_state``)
  round-trip every rank's state byte for byte; under tensor parallel the
  gathered state is the one-process state bit for bit.  The resize W 2 ->
  4 across ranks equals its one-process run bit for bit.
* Against the reference's ``fit`` on its meshless per-leaf bundle from the
  same weights: losses at rtol 2e-4 (the reference's own tolerance for its
  sharded layouts), comm rounds and the sync pattern exact.
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
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf
from repro_torch.models import lm as tlm
from repro_torch.sharding import layout as tlayout
from repro_torch.utils import tree_leaves

from _torch_tree_sharded_variants import (B, FORMS, KINDS, RESIZE_RUN, S,
                                          SIZES, STEPS, VARIANTS, W,
                                          make_data, make_run, mesh_layout)

ROOT = Path(__file__).resolve().parents[1]
P = W * S
FSDP_REL = 1e-5
# share of params and anchor elements an FSDP EF-sign run may move by a flip
FLIP_FRAC = 5e-4
RUNS = [(k, f, n) for k in KINDS for f in FORMS for n in VARIANTS] + \
    [RESIZE_RUN]
FLIPS = ("ef_sign_wire", "lars_ef_sign")

_SCRIPT = textwrap.dedent('''
    import dataclasses, json, socket, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, sys.argv[3])
    from _torch_tree_sharded_variants import (
        B, FORMS, KINDS, RESIZE_ROUND, RESIZE_RUN, RESIZE_W, S, SIZES,
        TIMEOUT_S, VARIANTS, W, make_data, make_run, mesh_layout)
    from repro_torch import configs
    from repro_torch.backend.local import LocalBackend
    from repro_torch.configs import base as tcb
    from repro_torch.core.controller import ElasticController
    from repro_torch.core.local_sgd import (LocalSGDState, gather_state,
                                            is_resident, local_state)
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_train
    from repro_torch.sharding import layout as tlayout
    from repro_torch.telemetry.stats import round_summary
    from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

    FIELDS = ("params", "momentum", "anchor", "ef_memory")
    RUNS = [(k, f, n) for k in KINDS for f in FORMS for n in VARIANTS] + \\
        [RESIZE_RUN]
    PINNED = [("fsdp", f, n) for f in FORMS
              for n in ("ef_sign_wire", "lars_ef_sign")]
    CKPT = "lars_ef_sign"

    def rows(state):
        return {f"{f}/{i}": x.float().numpy().copy() for f in FIELDS
                if getattr(state, f) is not None
                for i, x in enumerate(tree_leaves(getattr(state, f)))}

    def train(run, params0, bundle, backend):
        kw = {}
        if run.controller.kind == "elastic":
            kw["controller"] = ElasticController(
                run, resize_at={RESIZE_ROUND: RESIZE_W})
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(make_data(), W, B), bundle=bundle,
            backend=backend, params0=params0, log=lambda *a, **k: None, **kw)
        assert not is_resident(state)
        dist = getattr(backend, "collectives", None)
        meta = {"loss": [h["loss"] for h in hist],
                "synced": [h["synced"] for h in hist],
                "comm_rounds": summ["comm_rounds"], "resizes": summ["resizes"],
                "worker_sets": summ["ledger"]["worker_sets"],
                "ledger": {k: summ["ledger"][k] for k in summ["ledger"]
                           if k not in ("scaling", "sync_seconds")},
                "totals": dist.describe()["totals"] if dist else None}
        if state.stats is not None:
            meta["round_summary"] = round_summary(state.stats, dist=dist)
        return state, meta

    def save(out, tag, run_id, arrays, meta):
        name = ".".join(run_id)
        np.savez(f"{out}/{tag}.{name}.npz", **arrays)
        with open(f"{out}/{tag}.{name}.json", "w") as f:
            json.dump(meta, f, default=str)

    def pin(bundle, out, run_id):
        """Keep the pre- and post-sync state of every global sync of this
        one-process run."""
        sync, kept = bundle.sync, {}

        def pinned(state, *, plan=None, scope="global"):
            i = sum(k.endswith(".pre.params/0") for k in kept)
            kept.update({f"{i}.pre.{k}": v for k, v in rows(state).items()})
            state = sync(state, plan=plan, scope=scope)
            kept.update({f"{i}.post.{k}": v for k, v in rows(state).items()})
            np.savez(f"{out}/pin.{'.'.join(run_id)}.npz", **kept)
            return state
        bundle.sync = pinned

    def as_state(arrays, like, pre):
        """A whole tree state from ``pre``-keyed arrays, shaped as ``like``."""
        fields = {}
        for f in FIELDS:
            t = getattr(like, f)
            if t is None:
                fields[f] = None
                continue
            leaves, treedef = tree_flatten(t)
            fields[f] = tree_unflatten(treedef, [
                torch.from_numpy(arrays[f"{pre}{f}/{i}"]).to(x.dtype)
                for i, x in enumerate(leaves)])
        return LocalSGDState(global_u=None, step=like.step, rng=like.rng,
                             stats=like.stats, **fields)

    def replay(out, run_id, bundle, params0, r):
        """Every pinned sync on this rank: its part of the one-process
        pre-sync state through the rank's sync; what it holds after."""
        kept = dict(np.load(f"{out}/pin.{'.'.join(run_id)}.npz"))
        one = build_train(bundle.run, num_workers=W, device="cpu",
                          layout=mesh_layout(tlayout, run_id[0])
                          .with_sizes(SIZES),
                          **FORMS[run_id[1]]).init(params0)
        like = bundle.init(params0)
        got, i = {}, 0
        while f"{i}.pre.params/0" in kept:
            full = as_state(kept, one, f"{i}.pre.")
            st = dataclasses.replace(
                local_state(full, bundle.dist, "cpu",
                            shard_classes=bundle.shard_classes),
                rng=like.rng, stats=like.stats)
            st = bundle.sync(st, plan=bundle.sync_plan, scope="global")
            got.update({f"{i}.{k}": v for k, v in rows(st).items()})
            i += 1
        np.savez(f"{out}/r{r}.pinned.{'.'.join(run_id)}.npz", **got)

    def checkpoint(out, run_id, state, bundle, r):
        """gather_state onto rank 0, saved; every rank restores its part
        (local_state) and says whether it is its state byte for byte."""
        import torch.distributed as dist
        sc = bundle.shard_classes
        full = gather_state(state, bundle.dist, shard_classes=sc)
        path = f"{out}/full.{'.'.join(run_id)}.pt"
        if r == 0:
            torch.save(full, path)
            np.savez(f"{out}/full.{'.'.join(run_id)}.npz", **rows(full))
        dist.barrier()
        back = local_state(torch.load(path, weights_only=False),
                           bundle.dist, "cpu", shard_classes=sc)
        return all(
            a.dtype == b.dtype and a.shape == b.shape and
            a.numpy().tobytes() == b.numpy().tobytes()
            for f in FIELDS if getattr(state, f) is not None
            for a, b in zip(tree_leaves(getattr(state, f)),
                            tree_leaves(getattr(back, f)), strict=True))

    def rank(r, port, out, params0):
        torch.set_num_threads(1)
        from repro_torch.backend.distributed import DistributedBackend
        import torch.distributed as dist
        try:
            for run_id in RUNS:
                kind, form, name = run_id
                be = DistributedBackend(
                    W, backend="gloo", device="cpu", timeout_s=TIMEOUT_S,
                    coordinator_address=f"localhost:{port}", process_id=r,
                    num_processes=W * S, within_worker_size=S,
                    layout=mesh_layout(tlayout, kind), **FORMS[form])
                run = make_run(tcb, configs.get_smoke("paper-lm"), name)
                bundle = be.build(run)
                assert (be.use_kernel, be.resident,
                        be.within_worker_size) == (
                    FORMS[form].get("use_kernel", True),
                    FORMS[form].get("resident"), S)
                state, meta = train(run, params0, bundle, be)
                if name == CKPT:
                    meta["roundtrip"] = checkpoint(out, run_id, state,
                                                   bundle, r)
                save(out, f"r{r}", run_id, rows(state), meta)
                if run_id in PINNED:
                    replay(out, run_id, bundle, params0, r)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        torch.set_num_threads(1)
        out, params0 = sys.argv[1], torch.load(sys.argv[2])
        for run_id in RUNS:
            kind, form, name = run_id
            lay = mesh_layout(tlayout, kind).with_sizes(SIZES)
            run = make_run(tcb, configs.get_smoke("paper-lm"), name)
            if run.controller.kind == "elastic":
                be = LocalBackend(W, device="cpu", layout=lay, **FORMS[form])
                state, meta = train(run, params0, None, be)
            else:
                bundle = build_train(run, num_workers=W, device="cpu",
                                     layout=lay, **FORMS[form])
                if run_id in PINNED:
                    pin(bundle, out, run_id)
                state, meta = train(run, params0, bundle, None)
            save(out, "one", run_id, rows(state), meta)
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
    jb = jbuild(rj, num_workers=W, use_kernel=False)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    return params_from_reference(jax.tree.map(np.asarray, p0), "cpu")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, ref_params):
    """The directory of the one-process runs' and the ranks' files."""
    root = tmp_path_factory.mktemp("tree_sharded")
    script = root / "spawn.py"
    script.write_text(_SCRIPT)
    p0 = root / "params0.pt"
    torch.save(ref_params, p0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), str(root), str(p0),
                          str(ROOT / "tests")],
                         capture_output=True, text=True, env=env, timeout=400)
    assert res.returncode == 0, res.stderr[-4000:]
    return root


def _load(root: Path, tag: str, run_id):
    name = ".".join(run_id)
    return (dict(np.load(root / f"{tag}.{name}.npz")),
            json.loads((root / f"{tag}.{name}.json").read_text()))


def _classes(kind):
    """Per leaf: (dim, factor) of its one sharded dim, or None."""
    lay = mesh_layout(tlayout, kind).with_sizes(SIZES)
    out = []
    for c in tree_leaves(flatbuf.shard_classes(
            tlm.param_specs(tconfigs.get_smoke("paper-lm")), lay),
            is_leaf=lambda x: isinstance(x, flatbuf.ShardClass)):
        assert len(c.dims) <= 1, c
        out.append(c.dims[0] if c.dims else None)
    return out


def _part(x, key, r, kind, wl=W // (P // S)):
    """Rank ``r``'s part of the one-process leaf ``key`` (``field/i``): its
    workers' rows (not of the single-copy anchor), its shard's block of the
    leaf's sharded dim."""
    g, s = divmod(r, S)
    field, i = key.split("/")
    lead = 0 if field == "anchor" else 1
    if lead:
        x = x[g * wl:(g + 1) * wl]
    c = _classes(kind)[int(i)]
    if c is not None:
        x = np.split(x, c[1], axis=lead + c[0])[s]
    return x


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("run_id", RUNS, ids=[".".join(r) for r in RUNS])
def test_tree_ranks_match_one_process(spawned, run_id):
    kind, form, name = run_id
    one_a, one_m = _load(spawned, "one", run_id)
    ranks = [_load(spawned, f"r{r}", run_id) for r in range(P)]
    m = ranks[0][1]
    for _, mr in ranks[1:]:
        for k in ("loss", "synced", "comm_rounds", "ledger", "worker_sets",
                  "round_summary"):
            assert mr.get(k) == m.get(k), k
    for k in ("synced", "comm_rounds", "resizes", "worker_sets"):
        assert m[k] == one_m[k], k
    tp = kind == "tp"
    flips = not tp and name in FLIPS
    if tp:
        assert m["loss"] == one_m["loss"]
        assert m.get("round_summary") == one_m.get("round_summary")
    else:
        np.testing.assert_allclose(m["loss"], one_m["loss"], rtol=FSDP_REL)
    classes = _classes(kind)
    moved = total = 0
    for r, (arrays, _) in enumerate(ranks):
        assert sorted(arrays) == sorted(one_a)
        for key, got in arrays.items():
            want = _part(one_a[key], key, r, kind,
                         wl=got.shape[0] if not key.startswith("anchor")
                         else None)
            assert got.shape == want.shape, (key, r)
            c = classes[int(key.split("/")[1])]
            if c is not None:
                # 1/S of the one-process leaf
                assert got.size * S == one_a[key].size // (
                    1 if key.startswith("anchor") else P // S), key
            if tp:
                assert np.array_equal(got, want), (key, r)
            elif not flips:
                assert _rel(got, want) <= FSDP_REL, (key, r, _rel(got, want))
            elif key.split("/")[0] in ("params", "anchor"):
                scale = max(float(np.abs(want).max()), 1e-30)
                moved += int((np.abs(got - want) > FSDP_REL * scale).sum())
                total += got.size
    assert moved <= FLIP_FRAC * max(total, 1), (moved, total)
    # a worker's shard ranks hold its replicated leaves alike
    for g in range(P // S):
        a, c = ranks[g * S][0], ranks[g * S + 1][0]
        for key in a:
            if classes[int(key.split("/")[1])] is None:
                assert np.array_equal(a[key], c[key]), key
    if "round_summary" in one_m and not tp:
        got, want = m["round_summary"], one_m["round_summary"]
        assert got["num_workers"] == want["num_workers"] == W
        rtol = 1e-3 if flips else 1e-5
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-12,
                                           err_msg=k)
    if run_id == RESIZE_RUN:
        assert m["resizes"] == 1 and sorted(m["worker_sets"]) == ["W=2",
                                                                  "W=4"]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", FLIPS)
def test_fsdp_ef_sign_syncs_on_the_one_process_state(spawned, form, name):
    """FSDP + EF-sign, every sync held on the one-process run's own
    pre-sync state (each rank's part of it through the rank's sync): every
    field within 1e-6 of the largest entry (EF memory 1e-5) of the
    one-process post-sync state's part, no element beyond: the
    compressor's inputs and per-leaf totals are the one process's."""
    run_id = ("fsdp", form, name)
    kept = dict(np.load(spawned / f"pin.{'.'.join(run_id)}.npz"))
    syncs = _load(spawned, "one", run_id)[1]["comm_rounds"]["global"]
    assert f"{syncs - 1}.post.params/0" in kept
    beyond = 0
    for r in range(P):
        got = dict(np.load(spawned / f"r{r}.pinned.{'.'.join(run_id)}.npz"))
        assert len(got) == sum(1 for k in kept if ".post." in k)
        for key, x in got.items():
            i, field_leaf = key.split(".", 1)
            want = _part(kept[f"{i}.post.{field_leaf}"], field_leaf, r,
                         "fsdp")
            assert x.shape == want.shape, key
            rel = 1e-5 if field_leaf.startswith("ef_memory") else 1e-6
            scale = max(float(np.abs(want).max()), 1e-30)
            beyond += int((np.abs(x - want) > rel * scale).sum())
    assert beyond == 0, beyond


@pytest.mark.parametrize("kind", KINDS)
def test_tree_sharded_ledger(spawned, kind):
    """The sync rows are measured: P x one rank's bytes handed to the sync
    scope's collectives; the within-worker traffic (one gather a step of
    the f32 slices, FSDP's reduce-scatter and all-reduce) counted under
    ``within`` with the slices' bytes, never in a sync row."""
    classes = _classes(kind)
    wl = W // (P // S)
    for form in FORMS:
        for name in VARIANTS:
            run_id = (kind, form, name)
            one_m = _load(spawned, "one", run_id)[1]
            arrays, m = _load(spawned, "r0", run_id)
            led, tot = m["ledger"], m["totals"]
            assert led["cost_sources"] == ["measured"]
            for k in ("sync_rounds", "wire_bytes", "collectives",
                      "topologies"):
                assert led[k] == one_m["ledger"][k], (run_id, k)
            sync_bytes = sum(v["bytes"] for k, v in tot.items()
                             if k.endswith("/global"))
            assert sync_bytes > 0
            assert led["measured_bytes"] == P * sync_bytes, run_id
            sliced = sum(arrays[f"params/{i}"][0].size
                         for i, c in enumerate(classes) if c is not None)
            whole = sum(arrays[f"params/{i}"][0].size
                        for i, c in enumerate(classes) if c is None)
            g = tot["all_gather/within"]
            assert g == {"calls": STEPS, "bytes": STEPS * wl * sliced * 4}
            if kind == "fsdp":
                assert tot["reduce_scatter/within"] == {
                    "calls": STEPS, "bytes": STEPS * S * wl * sliced * 4}
                assert tot["all_reduce/within"] == {
                    "calls": STEPS, "bytes": STEPS * wl * whole * 4}
            else:
                assert "reduce_scatter/within" not in tot
                assert "all_reduce/within" not in tot


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", list(FORMS))
def test_tree_sharded_checkpoint(spawned, kind, form):
    """``gather_state`` -> ``local_state`` gives every rank its state back
    byte for byte; the gathered state has the one-process shapes, and under
    tensor parallel it IS the one-process state, bit for bit."""
    run_id = (kind, form, "lars_ef_sign")
    for r in range(P):
        assert _load(spawned, f"r{r}", run_id)[1]["roundtrip"] is True, r
    full = dict(np.load(spawned / f"full.{'.'.join(run_id)}.npz"))
    one_a, _ = _load(spawned, "one", run_id)
    assert sorted(full) == sorted(one_a)
    for key, want in one_a.items():
        assert full[key].shape == want.shape, key
        if kind == "tp":
            assert np.array_equal(full[key], want), key


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tree_sharded_ranks_match_reference(spawned, ref_params, name):
    """Both layouts' and both forms' 4-rank runs against the reference's
    tree fit on its meshless per-leaf bundle from the same weights."""
    rj = make_run(jcb, jconfigs.get_smoke("paper-lm"), name)
    jb = jbuild(rj, num_workers=W, use_kernel=False)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(make_data(), W, B), bundle=jb,
                                seed=0, log=lambda *a: None)
    for kind in KINDS:
        for form in FORMS:
            m = _load(spawned, "r0", (kind, form, name))[1]
            assert m["comm_rounds"] == jsum["comm_rounds"], (kind, form)
            assert m["synced"] == [h["synced"] for h in jhist], (kind, form)
            np.testing.assert_allclose(m["loss"], [h["loss"] for h in jhist],
                                       rtol=2e-4, err_msg=f"{kind} {form}")
