"""The runs of ``tests/test_torch_tree_sharded_dist.py``, shared with the
ranks it spawns (which import neither JAX nor the JAX package): the tree
path in both forms on paper-lm smoke, W=2 workers of local batch 2, seq
32, 8 steps of post-local SGD (H=2), each worker split over S=2 shard
ranks by the tensor-parallel or the FSDP layout with sizes {data: 2,
model: 2}; and one resize, W 2 -> 4 after global round ``RESIZE_ROUND``
(``RESIZE_RUN``: tensor parallel, the kernel form, EF-sign)."""
from repro_torch.data.synthetic import lm_examples, markov_lm

W, S, B, SEQ, STEPS = 2, 2, 2, 32, 8
SIZES = {"data": W, "model": S}
RESIZE_ROUND, RESIZE_W, RESIZE_STEPS = 2, 4, 10
TIMEOUT_S = 60                 # a collective that waits longer fails

# name -> (LocalSGDConfig, OptimConfig, ControllerConfig keywords)
VARIANTS = {
    "mean": ({}, {}, {}),
    "ef_sign_wire": (dict(sync_compression="ef_sign", wire_pack=True), {}, {}),
    "lars_ef_sign": (dict(sync_compression="ef_sign"),
                     dict(optimizer="lars", base_lr=0.3, lars_trust=0.02),
                     dict(telemetry=True)),
}
KINDS = ("tp", "fsdp")
# the tree path's two forms: build_train / backend keywords
FORMS = {"plain": dict(use_kernel=False), "kernel": dict(resident=False)}
# (kind, form, variant) of the resize run
RESIZE_RUN = ("tp", "kernel", "resize")


def mesh_layout(lib, kind):
    """``kind``'s layout from the package whose ``sharding.layout`` is
    ``lib``, without its sizes."""
    if kind == "tp":
        return lib.train_layout(("data", "model"), worker_axes=("data",))
    return lib.fsdp_within_worker_layout(("data", "model"),
                                         worker_axes=("data",),
                                         shard_axes=("model",))


def make_run(cb, cfg, name):
    """Run ``name``'s RunConfig in the package whose ``configs.base`` is
    ``cb`` (``"resize"``: EF-sign under the elastic controller)."""
    steps = STEPS
    if name == "resize":
        ls, opt, cc = dict(sync_compression="ef_sign"), {}, dict(kind="elastic")
        steps = RESIZE_STEPS
    else:
        ls, opt, cc = VARIANTS[name]
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", SEQ, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2, **ls),
        optim=cb.OptimConfig(**{**dict(base_lr=0.3, base_batch=W * B,
                                       lr_warmup_steps=2, lr_decay_steps=(6,),
                                       grad_clip=1.0), **opt}),
        controller=cb.ControllerConfig(**cc), steps=steps)


def make_data():
    return lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=SEQ))
