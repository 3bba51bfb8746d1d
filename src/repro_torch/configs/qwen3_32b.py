"""qwen3-32b — dense, GQA + qk_norm [hf:Qwen/Qwen3-8B family scaling].

Assigned: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B (qk_norm, GQA); assigned 32B scaling",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    blocks=(BlockDef("attn", "swiglu"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="qwen3-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=2, head_dim=32,
                          d_ff=256, vocab_size=512)
