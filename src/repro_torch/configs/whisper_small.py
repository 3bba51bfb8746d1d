"""whisper-small — audio encoder-decoder backbone [arXiv:2212.04356].

Assigned: 12L d_model=768 12H d_ff=3072 vocab=51865, enc-dec, conv
frontend stubbed: ``input_specs`` supplies mel-frame embeddings
(seq_len, d_model) to the encoder. 12 encoder + 12 decoder layers.
No ``long_500k`` (full attention, enc-dec).
"""
from repro_torch.configs.base import BlockDef, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    citation="arXiv:2212.04356 (Whisper small: 12+12L, d=768, 12H)",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    blocks=(BlockDef("attn", "gelu"),),
    cross_attention=True,
    rope_theta=10_000.0,       # backbone adaptation: RoPE in place of learned pos
    norm_eps=1e-5,
    is_decoder=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(name="whisper-smoke", num_layers=2, encoder_layers=2,
                          d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
                          d_ff=256, vocab_size=512)
