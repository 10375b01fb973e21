"""Architecture configuration for the assigned model zoo."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0               # 0 for attention-free
    n_kv_heads: int = 0
    head_dim: int = 0              # default d_model // n_heads

    # attention flavor
    attention: str = "gqa"         # gqa | mla | none | local
    qk_norm: bool = False
    rope_theta: float = 1e6
    local_window: int = 0          # sliding-window size for local attention

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0         # leading dense layers (deepseek: 3)
    dense_residual: bool = False   # parallel dense MLP branch (arctic)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    # multi-token prediction (deepseek)
    mtp: bool = False

    # encoder-decoder (seamless)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # cross-attention layers (llama-vision): 1 cross per `xattn_period` layers
    xattn_period: int = 0
    n_img_tokens: int = 1601       # stub modality frontend token count

    # recurrent families
    rwkv: bool = False             # RWKV6 time-mix blocks
    rglru: bool = False            # RecurrentGemma RG-LRU blocks
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru","rglru","attn")
    lru_width: int = 0
    conv_width: int = 4

    # numerics / training
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # sub-quadratic? (controls long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.rwkv or self.rglru or (
            self.attention == "local" and self.local_window > 0)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    def param_count(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS and sanity checks),
        from the shapes of the port's parameter schema; allocates nothing."""
        from repro_torch.models.model import param_count
        return param_count(self)

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE rooflines: replaces the full
        expert set with top_k + shared experts."""
        total = self.param_count()
        if not self.n_experts:
            return total
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe_layers = self.n_layers - self.first_k_dense
        inactive = (self.n_experts - self.top_k) * per_expert * n_moe_layers
        return total - inactive
