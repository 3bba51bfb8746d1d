"""The system under test: the port's training bundle
(``repro_torch.launch.steps.build_train``) for a configuration file and
a traffic mix, fed the benchmark's weights by name, and read back by
name.  Everything the benchmark takes from the program goes through
here."""
from __future__ import annotations

import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _import():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import base
    from repro_torch.core import flatbuf
    from repro_torch.launch import steps
    return base, flatbuf, steps


def run_config(cfg: dict, traffic: dict):
    """The port's RunConfig for a configuration file and a traffic mix."""
    base, _, _ = _import()
    moe = None
    if "num_experts" in cfg:
        if not cfg["norm_topk_prob"]:
            raise ValueError("the port always renormalises the chosen "
                             "experts' weights: norm_topk_prob must be true")
        moe = base.MoEConfig(num_experts=cfg["num_experts"], num_shared=0,
                             top_k=cfg["num_experts_per_tok"],
                             capacity_factor=cfg["capacity_factor"],
                             d_expert=cfg["intermediate_size"],
                             router_aux_weight=cfg["router_aux_loss_coef"])
    model = base.ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        citation=cfg["source"], num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        blocks=tuple(base.BlockDef(m, f) for m, f in cfg["layer_pattern"]),
        qk_norm=cfg["qk_norm"], rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"], moe=moe,
        norm_eps=cfg["rms_norm_eps"], param_dtype=cfg["param_dtype"])
    W, B = traffic["workers"], traffic["local_batch"]
    if traffic["optimizer"] != "sgd":
        raise ValueError(f"unknown optimizer {traffic['optimizer']!r}")
    return base.RunConfig(
        model=model,
        shape=base.InputShape("bench", traffic["seq_len"], W * B, "train"),
        local_sgd=base.LocalSGDConfig(
            local_steps=traffic["local_steps"],
            sync_compression=traffic["sync_compression"],
            wire_pack=traffic["wire_pack"],
            local_momentum=traffic["momentum"], nesterov=traffic["nesterov"]),
        optim=base.OptimConfig(
            optimizer="sgd", base_lr=traffic["base_lr"],
            base_batch=traffic["base_batch"],
            weight_decay=traffic["weight_decay"],
            lr_warmup_steps=traffic["lr_warmup_steps"],
            grad_clip=traffic["grad_clip"]),
        controller=base.ControllerConfig(kind="static", telemetry=False))


def build(cfg: dict, traffic: dict, device):
    """The training bundle (init, local_step, sync, sync_plan, layout)."""
    _, _, steps = _import()
    return steps.build_train(run_config(cfg, traffic),
                             num_workers=traffic["workers"], device=device)


def named(tree, prefix: str = "") -> dict:
    """name -> leaf of a tree of dicts and tuples ("layers.0.mix.wq")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def spec_shapes(bundle) -> dict:
    """name -> shape of the program's parameters."""
    return {n: tuple(s.shape) for n, s in named(bundle.specs).items()
            if hasattr(s, "shape")}


def tree_of(bundle, weights: dict):
    """The program's parameter tree holding ``weights`` (name -> tensor)."""
    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(fill(v, f"{prefix}.{i}" if prefix else str(i))
                         for i, v in enumerate(tree))
        return weights[prefix]
    return fill(bundle.specs)


def leaves(buckets) -> dict:
    """name -> (W, ...) view of a resident state's stacked buckets
    (``state.params`` or ``state.momentum``)."""
    _, flatbuf, _ = _import()
    return named(flatbuf.unflatten(buckets.layout, list(buckets.buckets),
                                   leading=1))


def bucket_elements(bundle) -> int:
    """Elements of one worker's buckets, padding included."""
    _, flatbuf, _ = _import()
    return sum(bundle.layout.bucket_rows) * flatbuf.LANE
