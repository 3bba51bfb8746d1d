"""gemma3-1b — dense, 5:1 local:global sliding attention, 128k ctx
[hf:google/gemma-3-1b-pt].

Assigned: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
Sliding-window layers make this the dense arch that runs ``long_500k``.
"""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt (5 local : 1 global, window 512)",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    blocks=(BlockDef("attn_sliding", "geglu"),) * 5 + (BlockDef("attn", "geglu"),),
    qk_norm=True,
    sliding_window=512,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    post_norm=True,
    norm_eps=1e-6,
    max_seq_len=131_072,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="gemma3-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256,
                          vocab_size=512, sliding_window=16,
                          blocks=(BlockDef("attn_sliding", "geglu"),
                                  BlockDef("attn", "geglu")))
