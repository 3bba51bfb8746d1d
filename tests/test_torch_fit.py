"""Port parity: the training driver ``fit`` and ``eval_lm`` (repro_torch vs
repro), post-local SGD on paper-lm smoke.

The port's ``params0`` is the tree the reference's ``fit`` materializes
itself (``materialize(bundle.specs, PRNGKey(seed))``), carried over with
``repro_torch.convert``; both iterate identical ``ShardedBatches``.  The
reference's bundle functions are jitted by the test (its meshless bundle
runs them op by op).  Per-step loss and held-out xent: rtol 1e-5
(float32, sums in another order, a few steps of drift); comm rounds and
the sync pattern: exact.
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


def _run(cb, cfg, mode):
    # quickstart's optimizer settings plus the clip; post-local SGD
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2,
                                    sync_compression=mode),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, lr_warmup_steps=2,
                             lr_decay_steps=(4,), grad_clip=1.0),
        steps=STEPS)


@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_fit_matches_reference(mode):
    data = lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
    held = lm_examples(markov_lm(vocab=512, num_seqs=16, seq_len=S,
                                 sample_seed=5))
    rj = _run(jcb, jconfigs.get_smoke("paper-lm"), mode)
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(data, W, B), bundle=jb, seed=0,
                                eval_every=3, eval_fn=jtrain.eval_lm(jb, held),
                                log=lambda *a: None)

    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), mode)
    tb = tbuild(rt, num_workers=W, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    params0 = params_from_reference(jax.tree.map(np.asarray, p0), "cpu")
    _, thist, tsum = ttrain.fit(rt, ShardedBatches(data, W, B), bundle=tb,
                                params0=params0, eval_every=3,
                                eval_fn=ttrain.eval_lm(tb, held),
                                log=lambda *a: None)

    assert tsum["comm_rounds"] == jsum["comm_rounds"] == {"block": 0, "global": 4}
    assert [h["synced"] for h in thist] == [h["synced"] for h in jhist]
    for key in ("loss", "xent", "lr", "tokens"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose([thist[i]["eval_xent"] for i in (2, 5)],
                               [jhist[i]["eval_xent"] for i in (2, 5)], rtol=1e-5)
    assert tsum["wall_s"] > 0 and tsum["topology"] == "flat"


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
