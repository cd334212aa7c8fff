"""Config dataclasses, the port of ``repro.configs.base``: model
architecture, parallelism/runtime, and the input shapes of the serving
rules.

The fields and their defaults are the JAX package's; dtypes are
``torch.dtype``s (f32 params, bf16 compute). ``param_count`` and
``active_param_count`` are the same analytic counts, so a config holds the
same numbers on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_kind: str = "swiglu"       # swiglu | gelu
    norm_kind: str = "rms"         # rms | layer
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    router_aux_weight: float = 0.01
    # rwkv6
    rwkv_head_size: int = 64
    rwkv_decay_rank: int = 64
    # mamba2 / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0             # 0 => d_inner // 64
    shared_attn_period: int = 0    # hybrid: shared attn block every N layers
    # audio (whisper): encoder consuming stubbed frame embeddings
    n_encoder_layers: int = 0
    n_audio_ctx: int = 1500
    # vlm: stubbed projected patch embeddings prepended to text
    n_patches: int = 0
    # serving
    sliding_window: int = 0        # 0 = full attention; >0 rotating cache
    long_context_window: int = 0   # window substituted for long_500k decode
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def param_count(self) -> int:
        """Analytic parameter count (``MODEL_FLOPS = 6*N*D``)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.family in ("dense", "vlm"):
            ffn = 3 * d * self.d_ff if self.mlp_kind == "swiglu" \
                else 2 * d * self.d_ff
            body = L * (attn + ffn)
        elif self.family == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            body = L * (attn + ffn)
        elif self.family == "ssm":  # rwkv6
            H = d // self.rwkv_head_size
            tm = 4 * d * d + d * self.rwkv_decay_rank * 2 + 6 * d \
                + H * self.rwkv_head_size
            cm = 2 * d * int(3.5 * d)
            body = L * (tm + cm)
        elif self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            Hs = self.resolved_ssm_heads
            in_proj = d * (2 * di + 2 * N + Hs)
            per_mamba = in_proj + di * d + (di + 2 * N) * self.ssm_conv \
                + 2 * Hs + di
            shared = attn + 3 * d * self.d_ff
            body = L * per_mamba + shared  # shared block counted once
        elif self.family == "audio":
            ffn = 2 * d * self.d_ff
            enc = self.n_encoder_layers * (attn + ffn)
            dec = L * (2 * attn + ffn)   # self + cross attention
            body = enc + dec
        else:
            raise ValueError(self.family)
        emb = V * d * (1 if self.tie_embeddings else 2)
        return int(body + emb)

    def active_param_count(self) -> int:
        """Active params per token (``analysis.roofline``'s N): a MoE
        counts its top-k experts of each layer, not all of them."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        all_exp = L * self.n_experts * 3 * d * self.d_ff
        act_exp = L * self.experts_per_token * 3 * d * self.d_ff
        return int(self.param_count() - all_exp + act_exp)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    worker_mode: str = "stacked"   # stacked | pods | global
    topology: str = "ring"
    optimizer: str = "d-adam"      # d-adam | cd-adam | d-psgd
    period: int = 4                # p
    gamma: float = 0.4
    compressor: str = "sign"
    eta: float = 1e-3
    tau: float = 1e-6
    weight_decay: float = 0.0
    moment_dtype: Optional[Any] = None
    remat: str = "dots"            # none | dots | full
    mixing: str = "roll"           # dense | roll
    microbatch: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    parallel: ParallelConfig
    source: str = ""               # citation for the architecture numbers

    @property
    def arch_id(self) -> str:
        return self.model.arch_id


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
