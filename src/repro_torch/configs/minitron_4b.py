"""minitron-4b — pruned Nemotron dense [arXiv:2407.14679].

Assigned: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    citation="arXiv:2407.14679 (Minitron 4B, pruned Nemotron-4)",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    blocks=(BlockDef("attn", "swiglu"),),
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="minitron-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=512)
