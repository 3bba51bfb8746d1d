"""deepseek-v2-lite-16b — MoE with multi-head latent attention
[arXiv:2405.04434].

Assigned: 27L d_model=2048 16H d_ff=1408 vocab=102400, MLA kv_lora=512,
MoE top-6. NOTE: the assignment line says both "64e top-6" and
"2 shared + 160 routed"; the model card (DeepSeek-V2-Lite) has 64 routed
+ 2 shared experts, top-6 — we follow the model card and record the
discrepancy here.
"""
from repro_torch.configs.base import BlockDef, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    citation="arXiv:2405.04434 (DeepSeek-V2-Lite: MLA kv_lora=512, 64r+2s top-6)",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,       # qk_nope 128 + qk_rope 64
    d_ff=1408,          # per-expert hidden
    vocab_size=102400,
    blocks=(BlockDef("mla", "moe"),),
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, capacity_factor=1.25,
                  d_expert=1408, router_aux_weight=0.003),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    rope_theta=10_000.0,
    norm_eps=1e-6,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=48, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, num_shared=1, top_k=2,
                      capacity_factor=8.0, d_expert=64),
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_dim=32))
