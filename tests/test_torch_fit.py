"""Port parity: the training driver ``fit`` and ``eval_lm`` (repro_torch vs
repro), post-local SGD on paper-lm smoke.

The port's ``params0`` is the tree the reference's ``fit`` materializes
itself (``materialize(bundle.specs, PRNGKey(seed))``), carried over with
``repro_torch.convert``; both iterate identical ``ShardedBatches``.  The
reference's bundle functions are jitted by the test (its meshless bundle
runs them op by op).  Per-step loss and held-out xent: rtol 1e-5
(float32, sums in another order, a few steps of drift); comm rounds and
the sync pattern: exact.  Hierarchical local SGD (Alg. 5) is held the
same way, and its comms ledger too: rounds, ring-model wire bytes and
collectives per topology and scope, exactly (the reference's clock fields
are not compared: an untraced run records no seconds).
"""
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
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train as tbuild

torch.set_num_threads(2)

W, B, S, STEPS = 4, 2, 32, 6


def _run(cb, cfg, mode, block_steps=1):
    # quickstart's optimizer settings plus the clip; post-local SGD
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2,
                                    sync_compression=mode,
                                    block_steps=block_steps),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, lr_warmup_steps=2,
                             lr_decay_steps=(4,), grad_clip=1.0),
        steps=STEPS)


def _fit_pair(mode, block_steps=1, num_steps=None):
    """The reference's fit and the port's on the same weights and data:
    (reference history, summary, port history, summary)."""
    data = lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
    held = lm_examples(markov_lm(vocab=512, num_seqs=16, seq_len=S,
                                 sample_seed=5))
    rj = _run(jcb, jconfigs.get_smoke("paper-lm"), mode, block_steps)
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(data, W, B), bundle=jb, seed=0,
                                num_steps=num_steps, eval_every=3,
                                eval_fn=jtrain.eval_lm(jb, held),
                                log=lambda *a: None)

    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), mode, block_steps)
    tb = tbuild(rt, num_workers=W, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    params0 = params_from_reference(jax.tree.map(np.asarray, p0), "cpu")
    _, thist, tsum = ttrain.fit(rt, ShardedBatches(data, W, B), bundle=tb,
                                num_steps=num_steps, params0=params0,
                                eval_every=3, eval_fn=ttrain.eval_lm(tb, held),
                                log=lambda *a: None)
    return jhist, jsum, thist, tsum


def _ledger_rows(summary):
    """The ledger's per-topology rounds, wire bytes and collectives."""
    return {k: {f: v[f] for f in ("rounds", "wire_bytes", "collectives",
                                  "bytes_per_round")}
            for k, v in summary["ledger"]["topologies"].items()}


@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_fit_matches_reference(mode):
    jhist, jsum, thist, tsum = _fit_pair(mode)

    assert tsum["comm_rounds"] == jsum["comm_rounds"] == {"block": 0, "global": 4}
    assert [h["synced"] for h in thist] == [h["synced"] for h in jhist]
    for key in ("loss", "xent", "lr", "tokens"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose([thist[i]["eval_xent"] for i in (2, 5)],
                               [jhist[i]["eval_xent"] for i in (2, 5)], rtol=1e-5)
    assert tsum["wall_s"] > 0 and tsum["topology"] == "flat"
    assert _ledger_rows(tsum) == _ledger_rows(jsum)
    assert set(_ledger_rows(tsum)) == {"flat/global"}


def test_fit_hierarchical_matches_reference():
    """Alg. 5 (block_steps=2, blocks of 2 of the 4 workers) through fit, as
    the reference's ``test_fit_hierarchical_topology_summary`` drives it:
    8 steps sync at (0 block) (1 global) (3 block) (5 global) (7 block);
    per-step loss rtol 1e-5; comm rounds, the sync pattern and the
    ledger's per-topology rounds, wire bytes and collectives exact."""
    jhist, jsum, thist, tsum = _fit_pair("none", block_steps=2, num_steps=8)
    assert tsum["comm_rounds"] == jsum["comm_rounds"] == {"block": 3, "global": 2}
    assert [h["synced"] for h in thist] == [h["synced"] for h in jhist] == [
        "block", "global", "", "block", "", "global", "", "block"]
    for key in ("loss", "xent", "lr"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose([thist[i]["eval_xent"] for i in (2, 5)],
                               [jhist[i]["eval_xent"] for i in (2, 5)], rtol=1e-5)
    assert tsum["topology"] == jsum["topology"] == "hierarchical(block_size=2)"
    rows = _ledger_rows(tsum)
    assert rows == _ledger_rows(jsum)
    assert set(rows) == {"hierarchical/block", "hierarchical/global"}
    assert rows["hierarchical/block"]["rounds"] == 3
    # a block all-reduce over 2 moves the bucket once, a global one over 4
    # one and a half times
    assert rows["hierarchical/global"]["bytes_per_round"] \
        == 1.5 * rows["hierarchical/block"]["bytes_per_round"]
    for k in ("sync_rounds", "wire_bytes", "collectives", "cost_sources",
              "worker_sets"):
        assert tsum["ledger"][k] == jsum["ledger"][k], k


def test_fit_draws_its_own_params_by_default():
    """Without params0 the port materializes from the specs with a
    seeded torch.Generator: two runs with one seed agree exactly."""
    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), "sign")
    data = lm_examples(markov_lm(vocab=512, num_seqs=32, seq_len=S))
    out = []
    for _ in range(2):
        tb = tbuild(rt, num_workers=W, device="cpu")
        _, hist, summ = ttrain.fit(rt, ShardedBatches(data, W, B), bundle=tb,
                                   num_steps=3, seed=7, log=lambda *a: None)
        out.append([h["loss"] for h in hist])
        assert summ["comm_rounds"]["global"] == 2
    assert out[0] == out[1] and np.isfinite(out[0]).all()


def test_cli_runs_on_cpu(capsys):
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "3", "--workers", "2",
                 "--local-batch", "2", "--seq", "16", "--local-steps", "2",
                 "--sync-compression", "ef_sign"])
    out = capsys.readouterr().out
    assert "done: final loss=" in out and "'global': 1" in out


def test_cli_runs_hierarchical_on_cpu(capsys):
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "4", "--workers", "4",
                 "--local-batch", "1", "--seq", "16", "--local-steps", "1",
                 "--block-steps", "2"])
    out = capsys.readouterr().out
    assert "comm={'block': 2, 'global': 2}" in out
    assert "topology=hierarchical(block_size=2)" in out
    with pytest.raises(ValueError, match="cannot serve block_steps"):
        ttrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                     "--block-steps", "2", "--sync-topology", "flat"])
