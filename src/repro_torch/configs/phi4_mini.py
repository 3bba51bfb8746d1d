"""phi4-mini-3.8b — dense RoPE SwiGLU GQA [arXiv:2412.08905].

Assigned: 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    citation="arXiv:2412.08905 (Phi-4-mini)",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    blocks=(BlockDef("attn", "swiglu"),),
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="phi4-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=512)
