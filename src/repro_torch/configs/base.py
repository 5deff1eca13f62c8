"""Architecture configuration dataclasses.

Field-for-field mirrors of the reference ``repro/configs/base.py`` (the
reference module pulls its framework in through ``SparsityConfig``, so
the port keeps its own copy). Every arch is a frozen ``ArchConfig`` in
its own module; reduced smoke variants come from ``ArchConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.sparse_ops import SparsityConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_expert: int = 0  # expert FFN hidden size (0 => use arch d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_act: str = "silu"  # silu | gelu | relu | relu2
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    first_k_dense: int = 0
    attn_every: int = 0
    frontend: Optional[str] = None  # 'patches' (vlm) | 'codes' (audio)
    num_codebooks: int = 1
    num_patches: int = 1024
    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)
    seq_shard: bool = False
    dtype: str = "bfloat16"
    remat: str = "none"
    scan_layers: bool = True
    tp_axis: Optional[str] = None

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Approximate parameter count (embedding + layers); the
        reference's formula, which the modeled tick clock is built on."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        per_layer = 0
        shared_block = 0
        if self.family == "ssm" or (self.family == "hybrid"):
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.ngroups * s.d_state
            per_layer += d * (2 * d_in + 2 * s.ngroups * s.d_state + nheads)
            per_layer += s.d_conv * conv_dim + d_in * d
        if self.family == "hybrid":
            shared_block = (
                d * hd * (self.num_heads + 2 * self.num_kv_heads)
                + self.num_heads * hd * d + 3 * d * ff
            )
        if self.family in ("dense", "moe", "vlm", "audio"):
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank
                per_layer += m.q_lora_rank * self.num_heads * (m.qk_nope_dim + m.qk_rope_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
                per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_dim + m.v_head_dim)
                per_layer += self.num_heads * m.v_head_dim * d
            else:
                per_layer += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                per_layer += self.num_heads * hd * d
        if self.moe is not None:
            de = self.moe.d_expert or ff
            per_layer += (
                (self.moe.num_experts + self.moe.n_shared_experts) * 3 * d * de
                + d * self.moe.num_experts
            )
        elif self.family not in ("ssm", "hybrid"):
            mult = 3 if self.mlp_act in ("silu", "gelu") else 2
            per_layer += mult * d * ff
        total = (self.num_layers * per_layer + shared_block
                 + v * d * (1 if self.tie_embeddings else 2))
        if self.frontend == "codes":
            total += (self.num_codebooks - 1) * v * d
        return int(total)

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        kw: dict = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_patches=8,
            scan_layers=self.num_layers > 1,
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_expert=32 if self.moe.d_expert else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16,
            )
        if self.first_k_dense:
            kw["first_k_dense"] = 1
        if self.attn_every:
            kw["attn_every"] = 2
        return dataclasses.replace(self, **kw)
