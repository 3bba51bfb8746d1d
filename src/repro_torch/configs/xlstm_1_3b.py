"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

Assigned: 48L d_model=2048 4H d_ff=0 vocab=50304. Pattern 7 mLSTM :
1 sLSTM (xLSTM[7:1]); blocks integrate their own up/down projections
(d_ff=0). Runs ``long_500k`` (O(1) recurrent state).
"""
from repro_torch.configs.base import BlockDef, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    citation="arXiv:2405.04517 (xLSTM[7:1] 1.3B)",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    blocks=(BlockDef("mlstm", "none"),) * 7 + (BlockDef("slstm", "none"),),
    ssm=SSMConfig(state_dim=0, conv_dim=4, expand=2, chunk=256),
    norm_eps=1e-6,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, vocab_size=512,
        blocks=(BlockDef("mlstm", "none"), BlockDef("slstm", "none")),
        ssm=SSMConfig(state_dim=0, conv_dim=4, expand=2, chunk=16))
