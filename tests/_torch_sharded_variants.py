"""The runs of ``tests/test_torch_sharded_dist.py``, shared with the ranks
it spawns (which import neither JAX nor the JAX package): paper-lm smoke,
W=2 workers of local batch 2, seq 32, 8 steps of post-local SGD (H=2),
each worker split over S=2 shard ranks by the tensor-parallel or the FSDP
layout with sizes {data: 2, model: 2}."""
from repro_torch.data.synthetic import lm_examples, markov_lm

W, S, B, SEQ, STEPS = 2, 2, 2, 32, 8
SIZES = {"data": W, "model": S}

# name -> (LocalSGDConfig, OptimConfig, ControllerConfig keywords)
VARIANTS = {
    "mean": ({}, {}, {}),
    "ef_sign_wire_coalesce": (dict(sync_compression="ef_sign", wire_pack=True,
                                   sync_coalesce=True), {}, {}),
    "lars_ef_sign": (dict(sync_compression="ef_sign"),
                     dict(optimizer="lars", base_lr=0.3, lars_trust=0.02),
                     dict(telemetry=True)),
}
KINDS = ("tp", "fsdp")


def mesh_layout(lib, kind):
    """``kind``'s layout from the package whose ``sharding.layout`` is
    ``lib``, without its sizes."""
    if kind == "tp":
        return lib.train_layout(("data", "model"), worker_axes=("data",))
    return lib.fsdp_within_worker_layout(("data", "model"),
                                         worker_axes=("data",),
                                         shard_axes=("model",))


def make_run(cb, cfg, name):
    """Variant ``name``'s RunConfig in the package whose ``configs.base``
    is ``cb``."""
    ls, opt, cc = VARIANTS[name]
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", SEQ, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2, **ls),
        optim=cb.OptimConfig(**{**dict(base_lr=0.3, base_batch=W * B,
                                       lr_warmup_steps=2, lr_decay_steps=(6,),
                                       grad_clip=1.0), **opt}),
        controller=cb.ControllerConfig(**cc), steps=STEPS)


def make_data():
    return lm_examples(markov_lm(vocab=512, num_seqs=32, seq_len=SEQ))
