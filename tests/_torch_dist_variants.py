"""The runs of ``tests/test_torch_distributed.py``, shared with the ranks
it spawns (which import neither JAX nor the JAX package): paper-lm smoke,
W=4 workers of local batch 2, seq 32, 8 steps of post-local SGD (H=2)."""
from repro_torch.data.synthetic import lm_examples, markov_lm

W, B, S, STEPS = 4, 2, 32, 8

# name -> (LocalSGDConfig, OptimConfig, ControllerConfig keywords)
VARIANTS = {
    "mean": ({}, {}, {}),
    "alg5": (dict(block_steps=2), {}, {}),
    "sign": (dict(sync_compression="sign"), {}, {}),
    "ef_sign": (dict(sync_compression="ef_sign"), {}, {}),
    "ef_sign_wire": (dict(sync_compression="ef_sign", wire_pack=True), {}, {}),
    "global_momentum": (dict(global_momentum=0.5), {}, {}),
    "lars_telemetry": (dict(sync_compression="ef_sign"),
                       dict(optimizer="lars", base_lr=0.3, lars_trust=0.02),
                       dict(telemetry=True)),
    "auto_compress": (dict(sync_compression="ef_sign"), {},
                      dict(kind="auto_compress", patience=1, err_budget=0.95)),
}


def make_run(cb, cfg, name):
    """Variant ``name``'s RunConfig in the package whose ``configs.base``
    is ``cb``."""
    ls, opt, cc = VARIANTS[name]
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2, **ls),
        optim=cb.OptimConfig(**{**dict(base_lr=0.3, base_batch=W * B,
                                       lr_warmup_steps=2, lr_decay_steps=(6,),
                                       grad_clip=1.0), **opt}),
        controller=cb.ControllerConfig(**cc), steps=STEPS)


def make_data():
    return lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
