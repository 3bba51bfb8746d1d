"""internvl2-76b — VLM: InternViT (stub) + InternLM2-like 76B LM
[arXiv:2404.16821].

Assigned: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision encoder + projector are stubbed: ``input_specs`` supplies
pre-computed patch embeddings (num_prefix_tokens, d_model) per example.
"""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    citation="arXiv:2404.16821 (InternVL2; LM backbone Llama-3-70B-like)",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    blocks=(BlockDef("attn", "swiglu"),),
    rope_theta=500_000.0,
    num_prefix_tokens=256,
    norm_eps=1e-5,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="internvl2-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=512, num_prefix_tokens=8)
