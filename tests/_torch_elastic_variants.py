"""The runs of ``tests/test_torch_elastic_dist.py``, shared with the ranks
it spawns (which import neither JAX nor the JAX package): paper-lm smoke,
W=4 workers of local batch 2, seq 32, post-local SGD (H=1 for two steps,
then H=2), resized W 4 -> 2 after global round 2 and back to 4 after
round 4 by ``ElasticController(resize_at=RESIZE)``; a straggler demoted
and promoted back (``DEMOTE_*``); a checkpoint after step ``CKPT_STEP``'s
sync."""
from repro_torch.backend.distributed import DistributedBackend
from repro_torch.backend.simulated import SimulatedBackend
from repro_torch.data.synthetic import lm_examples, markov_lm

W, B, SEQ, STEPS = 4, 2, 32, 10
RESIZE = {2: 2, 4: 4}          # global round -> worker-set width
CKPT_STEP = 7                  # the checkpoint after round 5 (W=4 again)
TIMEOUT_S = 60                 # a collective that waits longer fails

# name -> (LocalSGDConfig, OptimConfig, ControllerConfig keywords)
VARIANTS = {
    "mean": ({}, {}, {}),
    "ef_sign_wire": (dict(sync_compression="ef_sign", wire_pack=True), {}, {}),
    "lars_ef_sign": (dict(sync_compression="ef_sign"),
                     dict(optimizer="lars", base_lr=0.3, lars_trust=0.02),
                     dict(telemetry=True)),
}
# the runs of 2 worker groups x 2 shard ranks: (layout kind, variant)
SHARDED = (("tp", "ef_sign_wire"), ("fsdp", "mean"))
SHARD_SIZES = {"data": 2, "model": 2}

# the straggler: worker 3 runs DEMOTE_LATENCY_S slower until the eval hook
# after step DEMOTE_HEAL - 1 clears it; H=1, so every step is a round
DEMOTE_STEPS, DEMOTE_HEAL, DEMOTE_LATENCY_S = 16, 6, 0.05


def make_run(cb, cfg, name, *, steps=STEPS, **ls_extra):
    """Variant ``name``'s RunConfig in the package whose ``configs.base``
    is ``cb``."""
    ls, opt, cc = VARIANTS[name]
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", SEQ, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(**{**dict(local_steps=2,
                                              post_local_switch=2),
                                       **ls, **ls_extra}),
        optim=cb.OptimConfig(**{**dict(base_lr=0.3, base_batch=W * B,
                                       lr_warmup_steps=2, lr_decay_steps=(6,),
                                       grad_clip=1.0), **opt}),
        controller=cb.ControllerConfig(**{"kind": "elastic", **cc}),
        steps=steps)


def demote_run(cb, cfg):
    """The straggler run: mean sync (demotion can schedule block syncs),
    H=1 from the start."""
    return make_run(cb, cfg, "mean", steps=DEMOTE_STEPS, local_steps=1,
                    post_local_switch=-1)


def mesh_layout(lib, kind):
    """``kind``'s layout from the package whose ``sharding.layout`` is
    ``lib``, without its sizes."""
    if kind == "tp":
        return lib.train_layout(("data", "model"), worker_axes=("data",))
    return lib.fsdp_within_worker_layout(("data", "model"),
                                         worker_axes=("data",),
                                         shard_axes=("model",))


def make_data():
    return lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=SEQ))


class SimulatedDistributedBackend(DistributedBackend):
    """``DistributedBackend`` with ``SimulatedBackend``'s per-worker
    latency model: every rank reports the same modelled seconds, so the
    elastic policy's skew sensor reads the same numbers on every rank."""

    def __init__(self, num_workers=None, *, latency_s=None,
                 base_step_s: float = 0.01, **kw):
        super().__init__(num_workers, **kw)
        self.latency_s = dict(latency_s or {})
        self.base_step_s = float(base_step_s)

    _time_of = SimulatedBackend._time_of
    worker_step_times = SimulatedBackend.worker_step_times
    worker_times_by_id = SimulatedBackend.worker_times_by_id
