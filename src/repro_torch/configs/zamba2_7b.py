"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

Assigned: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64.
Every 6th position invokes the single shared attention+MLP block
(weight-shared across invocations, fed hidden + embedding skip).
Runs ``long_500k`` (recurrent state; attention caches seq-sharded).
"""
from repro_torch.configs.base import BlockDef, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    citation="arXiv:2411.15242 (Zamba2-7B: Mamba2 backbone + shared attn)",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    blocks=(BlockDef("mamba2", "none"),) * 5 + (BlockDef("shared_attn", "swiglu"),),
    ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, head_dim=64, chunk=256),
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-smoke", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        blocks=(BlockDef("mamba2", "none"),) * 1 + (BlockDef("shared_attn", "swiglu"),),
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, head_dim=32, chunk=32))
