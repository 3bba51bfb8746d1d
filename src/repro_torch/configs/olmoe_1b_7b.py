"""olmoe-1b-7b — MoE, 64 experts top-8 [arXiv:2409.02060].

Assigned: 16L d_model=2048 16H (kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import BlockDef, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    citation="arXiv:2409.02060 (OLMoE-1B-7B: 64 experts, top-8)",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    blocks=(BlockDef("attn", "moe"),),
    moe=MoEConfig(num_experts=64, num_shared=0, top_k=8, capacity_factor=1.25,
                  d_expert=1024, router_aux_weight=0.01),
    qk_norm=True,
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="olmoe-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, num_shared=0, top_k=2,
                      capacity_factor=8.0, d_expert=64))
