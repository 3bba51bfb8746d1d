"""The runs of ``tests/test_torch_tree_dist.py``, shared with the processes
it starts (which import neither JAX nor the JAX package): the tree path
(``use_kernel=False``, and ``resident=False`` with the kernels on) on
paper-lm smoke, W=4 workers of local batch 2, seq 32.

* Static runs (``STATIC``): post-local SGD, H=1 for two steps then H=2,
  8 steps; ``lars_ef_tel`` with a checkpoint after step ``CKPT_STEP``'s
  sync (``CKPT_RUN``).
* ``resize``: EF-sign under ``ElasticController(resize_at=RESIZE)``, W 4
  -> 2 -> 4, 10 steps (on 2 ranks: W'=2 is not a multiple of 4 worker
  groups, ``SPAWN_RUNS``).
* ``demote``: worker 3 ``DEMOTE_LATENCY_S`` slower until the eval hook
  after step ``DEMOTE_HEAL`` - 1 clears it (its blocks of two span two
  ranks on four), mean sync, H=1, 16 steps.
"""
from repro_torch.data.synthetic import lm_examples, markov_lm

W, B, SEQ, STEPS = 4, 2, 32, 8
RESIZE = {2: 2, 4: 4}          # global round -> worker-set width
RESIZE_STEPS = 10
CKPT_RUN, CKPT_STEP = "lars_ef_tel", 5
DEMOTE_STEPS, DEMOTE_HEAL, DEMOTE_LATENCY_S = 16, 6, 0.05
TIMEOUT_S = 60                 # a collective that waits longer fails

# the tree path's two forms: build_train / backend keywords
FORMS = {"plain": dict(use_kernel=False), "kernel": dict(resident=False)}

# name -> (LocalSGDConfig, OptimConfig, ControllerConfig keywords)
STATIC = {
    # Alg. 5: blocks of two, across ranks on four (inside a rank on two)
    "alg5": (dict(block_steps=2), {}, {}),
    "sign": (dict(sync_compression="sign"), {}, {}),
    "ef_wire_gm": (dict(sync_compression="ef_sign", wire_pack=True,
                        global_momentum=0.5), {}, {}),
    # kernels 5-6's plain versions on the tree path, and telemetry
    "lars_ef_tel": (dict(sync_compression="ef_sign"),
                    dict(optimizer="lars", base_lr=0.3, lars_trust=0.02),
                    dict(telemetry=True)),
}
RUNS = tuple(STATIC) + ("resize", "demote")
# the runs each spawn of P ranks makes
SPAWN_RUNS = {4: tuple(r for r in RUNS if r != "resize"), 2: RUNS}


def make_run(cb, cfg, name):
    """Run ``name``'s RunConfig in the package whose ``configs.base`` is
    ``cb``."""
    ls, opt, cc, steps = {}, {}, {}, STEPS
    if name in STATIC:
        ls, opt, cc = STATIC[name]
    elif name == "resize":
        ls, cc, steps = (dict(sync_compression="ef_sign"),
                         dict(kind="elastic"), RESIZE_STEPS)
    elif name == "demote":
        ls, cc, steps = (dict(local_steps=1, post_local_switch=-1),
                         dict(kind="elastic"), DEMOTE_STEPS)
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", SEQ, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(**{**dict(local_steps=2,
                                              post_local_switch=2), **ls}),
        optim=cb.OptimConfig(**{**dict(base_lr=0.3, base_batch=W * B,
                                       lr_warmup_steps=2, lr_decay_steps=(6,),
                                       grad_clip=1.0), **opt}),
        controller=cb.ControllerConfig(**cc), steps=steps)


def make_data():
    return lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=SEQ))
