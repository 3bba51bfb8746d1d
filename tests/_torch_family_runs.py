"""The runs of ``tests/test_torch_family_elastic.py`` (an elastic resize
on every model family) and ``tests/test_torch_family_controller.py`` (a
controller policy on every family), against the reference's ``fit``
(smoke configs, CPU).

One model a family test file: olmoe-1b-7b (``test_torch_moe``),
deepseek-v2-lite-16b (``test_torch_mla``), gemma3-1b (``test_torch_dense``),
zamba2-7b (``test_torch_ssm``), xlstm-1.3b (``test_torch_recurrent``),
whisper-small (``test_torch_encdec``), internvl2-76b
(``test_torch_prefix``); the batches carry whisper's frames and
internvl2's prefix embeddings.  W=4 workers of one sequence, H=1, from
the reference's own weights, each package's ``fit``:

* ``controller``: the ``diversity_h`` policy (H from the round's worker
  diversity): the same final H and comm rounds;
* ``resize``: ``ElasticController(resize_at={2: 2})``, W 4 -> 2 after the
  second round: one resize, the same worker sets and rounds on each.

Losses per step at rtol 1e-5, the loss tolerance those files state.  The
reference runs its per-leaf bundle (``use_kernel=False``, as
``tests/test_torch_sharded_dist.py`` holds it: the same arithmetic as its
resident path up to the order of the clip norm's sums), its local step
and sync each under one ``jax.jit`` (:func:`jit_builder`), rebuilt by its
backend at every W.
"""
import jax
import numpy as np

from repro import configs as jconfigs
from repro.backend.local import LocalBackend as JLocalBackend
from repro.configs import base as jcb
from repro.core import controller as jctl
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.backend.local import LocalBackend
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import controller as tctl
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import train as ttrain

FAMILIES = {"moe": "olmoe-1b-7b", "mla": "deepseek-v2-lite-16b",
            "dense": "gemma3-1b", "ssm": "zamba2-7b",
            "recurrent": "xlstm-1.3b", "encdec": "whisper-small",
            "prefix": "internvl2-76b"}
W, B, S, SE, STEPS = 4, 1, 16, 24, 5
RESIZE = {2: 2}


def jit_builder(run, worker_set):
    """The reference's per-leaf bundle for ``worker_set``, its local step
    and sync under one ``jax.jit`` each (compiled once a width)."""
    jb = jbuild(run, worker_set=worker_set, use_kernel=False, jit=False)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression", "plan",
                                                 "scope"))
    return jb


def _run(cb, cfg, kind):
    cc = (dict(kind="diversity_h") if kind == "controller"
          else dict(kind="elastic"))
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=1),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, weight_decay=1e-2,
                             grad_clip=1.0, lr_warmup_steps=1),
        controller=cb.ControllerConfig(**cc), steps=STEPS)


def _data(cfg, n=32, seed=0):
    """markov_lm examples plus the family's float inputs: whisper's frames
    (n, SE, E), internvl2's prefix embeddings (n, Np, E)."""
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=n, seq_len=S,
                                 seed=seed))
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "audio":
        data["frames"] = rng.normal(size=(n, SE, cfg.d_model)).astype(np.float32)
    elif cfg.num_prefix_tokens:
        data["prefix_embed"] = rng.normal(
            size=(n, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return data


def check_family(family: str, kind: str):
    """``kind`` ("controller" or "resize") on ``family``'s smoke model, the
    port's fit against the reference's (see the module docstring)."""
    arch = FAMILIES[family]
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rj, rt = _run(jcb, jcfg, kind), _run(tcb, tcfg, kind)
    data = _data(tcfg)
    jkw, tkw = {}, {}
    if kind == "resize":
        jkw["controller"] = jctl.ElasticController(rj, resize_at=RESIZE)
        tkw["controller"] = tctl.ElasticController(rt, resize_at=RESIZE)
    jbe = JLocalBackend(W, build_fn=jit_builder)
    _, jhist, jsum = jtrain.fit(rj, JBatches(data, W, B), backend=jbe, seed=0,
                                log=lambda *a: None, **jkw)
    p0 = jmbase.materialize(jbuild(rj, num_workers=W, use_kernel=False,
                                   jit=False).specs, jax.random.PRNGKey(0))
    _, thist, tsum = ttrain.fit(
        rt, ShardedBatches(data, W, B), backend=LocalBackend(W, device="cpu"),
        params0=params_from_reference(jax.tree.map(np.asarray, p0), "cpu"),
        log=lambda *a: None, **tkw)
    assert len(thist) == len(jhist) == STEPS
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    assert [h["synced"] for h in thist] == [h["synced"] for h in jhist]
    assert tsum["comm_rounds"] == jsum["comm_rounds"]
    assert tsum["controller"]["h_final"] == jsum["controller"]["h_final"]
    assert tsum["resizes"] == jsum["resizes"] == (1 if kind == "resize" else 0)
    tsets, jsets = tsum["ledger"]["worker_sets"], jsum["ledger"]["worker_sets"]
    assert tsets.keys() == jsets.keys()
    for k in jsets:
        assert tsets[k]["rounds"] == jsets[k]["rounds"], k
    if kind == "resize":
        assert set(tsets) == {"W=2", "W=4"}
