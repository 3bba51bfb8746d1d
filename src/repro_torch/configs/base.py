"""Config dataclasses: the port's own copy of ``repro.configs.base``.

Field names and defaults match the reference so that a run described in
one package reads the same in the other, the MoE, MLA and SSM (mamba2 /
xLSTM) sub-configs included.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

MixerKind = Literal["attn", "attn_sliding", "mla", "mamba2", "mlstm", "slstm", "shared_attn"]
FFNKind = Literal["swiglu", "geglu", "gelu", "moe", "none"]


@dataclass(frozen=True)
class BlockDef:
    """One layer of the network: a sequence mixer + a feed-forward."""

    mixer: MixerKind
    ffn: FFNKind


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    num_shared: int = 0            # always-on shared experts
    top_k: int = 1
    capacity_factor: float = 1.25  # slots per expert = cf * tokens * top_k / E
    d_expert: int = 0              # expert hidden dim (d_ff of each expert)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => full-rank q projection (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64            # N (mamba2) / head dim (mLSTM)
    conv_dim: int = 4              # depthwise conv kernel size
    expand: int = 2                # inner dim = expand * d_model
    num_heads: int = 0             # mamba2 heads (inner_dim / head_dim); 0 => derive
    head_dim: int = 64
    chunk: int = 256               # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "vlm", "audio", "hybrid", "ssm"]
    citation: str

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 => d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    blocks: tuple[BlockDef, ...] = ()

    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0
    sliding_window: int = 0
    logit_softcap: float = 0.0
    attn_scale: float = 0.0        # 0 => 1/sqrt(head_dim)
    tie_embeddings: bool = False
    scale_embeddings: bool = False

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None

    encoder_layers: int = 0
    cross_attention: bool = False
    max_source_positions: int = 0
    num_prefix_tokens: int = 0

    norm_eps: float = 1e-6
    post_norm: bool = False
    act_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    max_seq_len: int = 131_072
    is_decoder: bool = True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def block_at(self, i: int) -> BlockDef:
        return self.blocks[i % len(self.blocks)]

    def layer_schedule(self) -> tuple[BlockDef, ...]:
        return tuple(self.block_at(i) for i in range(self.num_layers))


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class LocalSGDConfig:
    """Paper hyper-parameters (eq. 2, Alg. 1/2/5)."""

    local_steps: int = 1                 # H
    block_steps: int = 1                 # H^b (hierarchical; 1 => flat local SGD)
    post_local_switch: int = -1          # t' in steps; -1 => local SGD from step 0
    warmup_kind: Literal["none", "linear", "exp", "constant"] = "none"
    warmup_steps: int = 0
    sync_compression: Literal["none", "sign", "ef_sign"] = "none"
    wire_pack: bool = False
    sync_topology: Literal["auto", "flat", "hierarchical", "overlap"] = "auto"
    sync_coalesce: bool = False
    local_momentum: float = 0.9
    global_momentum: float = 0.0
    nesterov: bool = True


@dataclass(frozen=True)
class OptimConfig:
    optimizer: Literal["sgd", "lars"] = "sgd"
    base_lr: float = 0.1
    base_batch: int = 256                # linear-scaling reference batch
    weight_decay: float = 1e-4
    wd_skip_norms: bool = True
    lr_warmup_steps: int = 0
    lr_decay_steps: tuple[int, ...] = ()
    lr_decay_factor: float = 0.1
    grad_clip: float = 0.0
    lars_trust: float = 0.001
    noise_eta: float = 0.0
    noise_gamma: float = 0.55


@dataclass(frozen=True)
class ControllerConfig:
    """Adaptive sync controller settings (policies in
    ``core/controller.py``): ``static`` (the pre-scheduled H(t)),
    ``diversity_h``, ``adaptive_batch``, ``auto_compress`` (needs
    ``sync_compression='ef_sign'``), ``noise_adaptive`` and ``elastic``
    (resizes, and straggler demotion once the step-time skew stays over
    ``skew_threshold`` for ``skew_patience`` rounds).
    ``telemetry=None`` collects round statistics exactly when the kind
    needs them (any non-static kind)."""

    kind: Literal["static", "diversity_h", "adaptive_batch",
                  "auto_compress", "noise_adaptive", "elastic"] = "static"
    telemetry: bool | None = None
    h_min: int = 1
    h_max: int = 64
    h0: int = 0
    ema: float = 0.5
    low: float = 0.1
    high: float = 0.5
    patience: int = 2
    tol: float = 0.01
    max_batch_scale: int = 8
    err_budget: float = 0.7
    noise_grow: float = 1.0
    lr_cap_decay: float = 0.5
    lr_scale_min: float = 0.1
    skew_threshold: float = 0.5
    skew_patience: int = 2

    @property
    def wants_telemetry(self) -> bool:
        if self.telemetry is None:
            return self.kind != "static"
        return self.telemetry

    @property
    def wants_speculation(self) -> bool:
        """Measure the would-be sign error on uncompressed rounds: the
        turn-on signal of the compression-escalating policies."""
        return self.kind in ("auto_compress", "noise_adaptive")


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: InputShape = TRAIN_4K
    local_sgd: LocalSGDConfig = LocalSGDConfig()
    optim: OptimConfig = OptimConfig()
    controller: ControllerConfig = ControllerConfig()
    seed: int = 0
    # "block": recompute each period layer in the backward
    # (lm.loss_fn); the reference's default is "block", the port's "none"
    # (a kept difference: the same numbers, no recompute unless asked)
    remat: Literal["none", "block", "full"] = "none"
    steps: int = 100
    log_every: int = 10
