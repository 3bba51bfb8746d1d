"""paper-lm — the paper-repro scale model (~120M dense decoder)."""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="paper-lm",
    family="dense",
    citation="this repo (paper-repro substrate model, ~100M)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=8192,
    blocks=(BlockDef("attn", "swiglu"),),
    rope_theta=10_000.0,
    tie_embeddings=True,
    norm_eps=1e-6,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="paper-lm-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
                          vocab_size=512)


def tiny() -> ModelConfig:
    """Very small variant for fast training in examples."""
    return CONFIG.replace(name="paper-lm-tiny", num_layers=4, d_model=128,
                          num_heads=4, num_kv_heads=4, head_dim=32, d_ff=512,
                          vocab_size=512)
