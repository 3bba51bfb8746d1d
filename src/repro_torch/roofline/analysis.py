"""Roofline analysis (the port of ``repro.roofline.analysis``).

The counts are the reference's, unchanged: an ANALYTIC per-block
operation count (exact matmul / banded-attention arithmetic, an
activation-traffic model for bytes, a Megatron-style collective count),
per (arch x shape) and per training / serve step.  Only the constants
differ: the H100 SXM's (``launch.mesh``) divide them, so the times, and
with them ``dominant``, are the card's:

    compute    = FLOPs_per_device / 989e12            [bf16 tensor cores]
    memory     = bytes_per_device / 3.35e12           [HBM3]
    collective = moved_bytes_per_device / 450e9       [NVLink, each way]

Training FLOPs = 3x forward (bwd = 2x fwd) + 1x forward again under the
reference's block remat = 4x, the reference's counts.  The port
recomputes under ``RunConfig.remat="block"`` only (``lm.loss_fn``; its
default is "none", about 3x; a replay leaves out a layer's trailing ops
whose outputs nothing saves, checkpoint's early stop).  The analytic
bytes assume bf16 (``BF16``), where the port trains in float32; its
bound on the card is the compute term at the f32 rate
(``launch.mesh.PEAK_FLOPS_F32``).  Attention counts the causal band; the
port's blockwise attention (``models.layers.chunked_attention``) computes
the visited 512 x 512 blocks, the whole square below 512 positions and
the band's blocks beyond.  MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D
(MoE).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

BF16 = 2


# ---------------------------------------------------------------------------
# attention helpers
# ---------------------------------------------------------------------------

def banded_area(S: int, window: int) -> float:
    """Number of (q, k) attended pairs for causal (optionally windowed)."""
    if window and window < S:
        # first `window` rows form a triangle, the rest attend `window` keys
        return window * (window + 1) / 2 + (S - window) * window
    return S * (S + 1) / 2


# ---------------------------------------------------------------------------
# per-layer forward FLOPs (whole layer, batch B, seq S)
# ---------------------------------------------------------------------------

def _attn_flops(cfg, B, S, *, window=0, attended=None, cross_len=0):
    H, KH, D, E = cfg.num_heads, cfg.num_kv_heads or cfg.num_heads, \
        cfg.resolved_head_dim, cfg.d_model
    proj = 2 * B * S * E * (H * D + 2 * KH * D) + 2 * B * S * H * D * E
    if attended is None:
        area = B * banded_area(S, window)
    else:
        area = B * S * attended
    sc = 2 * area * H * D * 2            # scores + AV
    if cross_len:
        proj += 2 * B * cross_len * E * 2 * KH * D
    return proj + sc


def _mla_flops(cfg, B, S, *, decode_cache=0):
    m = cfg.mla
    H, E = cfg.num_heads, cfg.d_model
    dn, dr, dv, L = m.qk_nope_dim, m.qk_rope_dim, m.v_dim, m.kv_lora_rank
    T = B * S
    f = 2 * T * E * H * (dn + dr)                      # q
    f += 2 * T * E * (L + dr)                          # down kv
    if decode_cache:
        # absorbed decode: q_lat (H L dn), scores vs cache, ctx, up_v
        f += 2 * T * H * dn * L
        f += 2 * B * decode_cache * H * L * 2
        f += 2 * T * H * L * dv
    else:
        f += 2 * T * L * H * (dn + dv)                 # k_up, v_up
        f += 2 * B * banded_area(S, 0) * H * (dn + dr + dv)
    f += 2 * T * H * dv * E                            # out
    return f


def _ffn_flops(cfg, B, S, kind, d_ff=None):
    E = cfg.d_model
    F = d_ff or cfg.d_ff
    n = 3 if kind in ("swiglu", "geglu") else 2
    return 2 * B * S * E * F * n


def _moe_flops(cfg, B, S):
    mo = cfg.moe
    E = cfg.d_model
    T = B * S
    f = 2 * T * E * mo.num_experts                              # router
    f += 2 * T * mo.top_k * mo.capacity_factor * E * mo.d_expert * 3
    if mo.num_shared:
        f += 2 * T * E * (mo.num_shared * mo.d_expert) * 3
    return f


def _mamba2_flops(cfg, B, S):
    s = cfg.ssm
    E = cfg.d_model
    inner = s.expand * E
    H = inner // s.head_dim
    N = s.state_dim
    Q = min(s.chunk, S)
    T = B * S
    f = 2 * T * E * (2 * inner + 2 * N + H)            # in projs
    f += 2 * T * s.conv_dim * (inner + 2 * N)          # conv
    f += T * Q * (N + inner)                           # intra-chunk (masked half)
    f += 2 * T * N * inner * 2                         # states + y_off
    f += 2 * T * inner * E                             # out proj
    return f


def _mlstm_flops(cfg, B, S):
    s = cfg.ssm
    E = cfg.d_model
    inner = s.expand * E
    H = cfg.num_heads
    dk = inner // H
    Q = min(s.chunk, S)
    T = B * S
    f = 2 * T * E * 2 * inner                          # up proj
    f += 2 * T * s.conv_dim * inner
    f += 3 * 2 * T * dk * inner                        # per-head qkv
    f += T * Q * inner * 2.5                           # intra-chunk
    f += 2 * T * dk * inner * 2                        # inter + state
    f += 2 * T * inner * E
    return f


def _slstm_flops(cfg, B, S):
    E = cfg.d_model
    H = cfg.num_heads
    Dh = E // H
    T = B * S
    return 2 * T * E * 4 * E + 2 * T * H * Dh * 4 * Dh + 2 * T * E * E


def layer_forward_flops(cfg: ModelConfig, bd, B, S, *, decode_cache=0,
                        cross_len=0):
    k = bd.mixer
    if k in ("attn", "shared_attn"):
        f = _attn_flops(cfg, B, S, attended=decode_cache or None,
                        cross_len=0)
    elif k == "attn_sliding":
        att = min(decode_cache, cfg.sliding_window) if decode_cache else None
        f = _attn_flops(cfg, B, S, window=cfg.sliding_window, attended=att)
    elif k == "mla":
        f = _mla_flops(cfg, B, S, decode_cache=decode_cache)
    elif k == "mamba2":
        f = _mamba2_flops(cfg, B, S) if not decode_cache else \
            _mamba2_flops(cfg, B, 1) * S
    elif k == "mlstm":
        f = _mlstm_flops(cfg, B, S)
    elif k == "slstm":
        f = _slstm_flops(cfg, B, S)
    else:
        raise ValueError(k)
    if cross_len:
        f += _attn_flops(cfg, B, S, attended=cross_len)
    if bd.ffn == "moe":
        f += _moe_flops(cfg, B, S)
    elif bd.ffn != "none":
        f += _ffn_flops(cfg, B, S, bd.ffn)
    return f


def forward_flops(cfg: ModelConfig, B, S, *, decode_cache=0):
    total = 0.0
    cross = S if cfg.cross_attention else 0            # decoder S == enc len? no:
    for i in range(cfg.num_layers):
        bd = cfg.block_at(i)
        total += layer_forward_flops(cfg, bd, B, S,
                                     decode_cache=decode_cache,
                                     cross_len=0)
    if cfg.cross_attention:
        enc_S = decode_cache or S
        H, D, E = cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
        # cross-attn per decoder layer: q proj + scores/AV over enc states
        per_layer = (2 * B * S * E * H * D * 2 +             # q + out proj
                     2 * B * S * enc_S * H * D * 2)          # scores + AV
        total += cfg.num_layers * per_layer
        if not decode_cache:
            # encoder runs once (prefill/train); its KV cached for decode
            total += cfg.num_layers * 2 * B * enc_S * E * 2 * \
                (cfg.num_kv_heads or H) * D // max(H, 1) * H  # cross kv proj
            total += cfg.encoder_layers * (
                _attn_flops(cfg, B, enc_S, attended=enc_S) +
                _ffn_flops(cfg, B, enc_S, "gelu"))
    total += 2 * B * S * cfg.d_model * cfg.vocab_size  # head
    return total


# ---------------------------------------------------------------------------
# parameters / memory model
# ---------------------------------------------------------------------------

def num_params(cfg: ModelConfig) -> int:
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    return mbase.count_params(lm.param_specs(cfg))


def active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    n = num_params(cfg)
    if cfg.moe:
        mo = cfg.moe
        per_expert = 3 * cfg.d_model * mo.d_expert
        routed_total = cfg_moe_layers(cfg) * mo.num_experts * per_expert
        routed_active = cfg_moe_layers(cfg) * mo.top_k * per_expert
        return int(n - routed_total + routed_active)
    return n


def cfg_moe_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.num_layers) if cfg.block_at(i).ffn == "moe")


@dataclass
class Roofline:
    arch: str
    shape: str
    kind: str
    flops_device: float
    bytes_device: float
    coll_bytes_device: float
    model_flops: float
    hlo_flops_total: float
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    notes: str = ""

    def finalize(self):
        self.t_compute = self.flops_device / PEAK_FLOPS_BF16
        self.t_memory = self.bytes_device / HBM_BW
        self.t_collective = self.coll_bytes_device / NVLINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        return self


def train_roofline(cfg: ModelConfig, shape: InputShape, *, num_workers: int,
                   chips: int = 256, H: int = 8,
                   sync_coll_bytes: float | None = None) -> Roofline:
    """Per-device roofline for one local step (+ sync amortized over H)."""
    B = shape.global_batch // max(num_workers, 1)      # per worker
    S = shape.seq_len
    chips_per_worker = chips // max(num_workers, 1)

    fwd = forward_flops(cfg, B, S)
    step_flops = 4.0 * fwd                              # fwd + 2x bwd + remat fwd
    flops_dev = step_flops / chips_per_worker

    n = num_params(cfg)
    # params traffic: grads computed (w read, g written), optimizer reads
    # p,g,u writes p,u => ~7 passes over params per step, bf16
    param_bytes = 7 * n * BF16 / chips_per_worker
    # activation traffic model: ~14 reads+writes of (B,S,E) per layer
    # (fwd 6 + bwd 8 incl. remat), validated against probe bytes_accessed
    act_bytes = 14 * cfg.num_layers * B * S * cfg.d_model * BF16 / chips_per_worker
    bytes_dev = param_bytes + act_bytes

    # collectives: Megatron-style TP all-reduces, 4 per layer (2 fwd, 2 bwd)
    # of the per-device activation shard (B,S,E replicated within worker)
    tp = chips_per_worker
    act = B * S * cfg.d_model * BF16
    coll = 4 * cfg.num_layers * 2 * (tp - 1) / tp * act if tp > 1 else 0.0
    coll += 2 * 2 * (tp - 1) / tp * act if tp > 1 else 0.0   # head fwd+bwd
    # sync: param all-reduce over worker axes, amortized by H
    if sync_coll_bytes is None:
        shard = n * BF16 / chips_per_worker
        W = max(num_workers, 1)
        sync_coll_bytes = 2 * (W - 1) / W * shard if W > 1 else 0.0
    coll += sync_coll_bytes / H

    mf = 6 * active_params(cfg) * B * S / chips_per_worker
    return Roofline(cfg.name, shape.name, "train", flops_dev, bytes_dev, coll,
                    mf, step_flops).finalize()


def serve_roofline(cfg: ModelConfig, shape: InputShape, *, chips: int = 256,
                   kind: str) -> Roofline:
    B, S = shape.global_batch, shape.seq_len
    if kind == "prefill":
        fwd = forward_flops(cfg, B, S)
        flops_dev = fwd / chips
        n = num_params(cfg)
        act = 8 * cfg.num_layers * B * S * cfg.d_model * BF16
        bytes_dev = (n * BF16 + act) / chips
        tp = 16
        coll = (2 * cfg.num_layers * 2 * (tp - 1) / tp *
                (B // 16) * S * cfg.d_model * BF16) if tp > 1 else 0.0
        mf = 2 * active_params(cfg) * B * S / chips
    else:
        fwd = forward_flops(cfg, B, 1, decode_cache=S)
        flops_dev = fwd / chips
        n = num_params(cfg)
        cache = kv_cache_bytes(cfg, B, S)
        bytes_dev = (n * BF16 + cache) / chips          # weights + cache read
        tp = 16
        act = B * cfg.d_model * BF16
        coll = 2 * cfg.num_layers * 2 * (tp - 1) / tp * max(act // 16, 1)
        mf = 2 * active_params(cfg) * B / chips
    return Roofline(cfg.name, shape.name, kind, flops_dev, bytes_dev, coll,
                    mf, fwd).finalize()


def kv_cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    total = 0.0
    for i in range(cfg.num_layers):
        bd = cfg.block_at(i)
        if bd.mixer in ("attn", "shared_attn"):
            total += 2 * B * S * (cfg.num_kv_heads or cfg.num_heads) * \
                cfg.resolved_head_dim * BF16
        elif bd.mixer == "attn_sliding":
            total += 2 * B * min(S, cfg.sliding_window) * \
                (cfg.num_kv_heads or cfg.num_heads) * cfg.resolved_head_dim * BF16
        elif bd.mixer == "mla":
            total += B * S * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * BF16
        elif bd.mixer == "mamba2":
            s = cfg.ssm
            inner = s.expand * cfg.d_model
            total += B * (inner // s.head_dim) * s.state_dim * s.head_dim * 4
        elif bd.mixer == "mlstm":
            inner = cfg.ssm.expand * cfg.d_model
            dk = inner // cfg.num_heads
            total += B * cfg.num_heads * dk * dk * 4
        elif bd.mixer == "slstm":
            total += 4 * B * cfg.d_model * 4
    if cfg.cross_attention:
        total += 2 * cfg.num_layers * B * S * \
            (cfg.num_kv_heads or cfg.num_heads) * cfg.resolved_head_dim * BF16
    return total
