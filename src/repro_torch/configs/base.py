"""Architecture configuration (the port's own copy of ``repro.configs.base``).

The port keeps its own ``ArchConfig`` so that it imports nothing of the JAX
package.  Fields and derived quantities are the same as the reference's, and
so is the input-shape table that sets the dry-run's cells
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM family)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    """One (seq_len, global_batch) cell plus which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ArchConfig:
    """A single model architecture.

    The field set is the union over families; family-specific fields are
    zero/empty when unused.  ``family`` selects the model constructor.
    """

    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- VLM (cross-attention image layers; frontend stubbed) ---
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    vision_d_model: int = 0

    # --- encoder-decoder (audio frontend stubbed) ---
    encoder_layers: int = 0
    num_audio_frames: int = 0

    # --- hybrid / SSM ---
    ssm_state: int = 0
    attn_free: bool = False
    sliding_window: int = 0  # 0 = full attention
    full_attn_layers: Tuple[int, ...] = ()

    # --- quality tiers (just-in-time model substitution) ---
    substitute: Optional[str] = None

    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if not (self.num_kv_heads == 0 or self.attn_free
                or self.num_heads % max(self.num_kv_heads, 1) == 0):
            raise ValueError(f"{self.name}: num_heads={self.num_heads} not "
                             f"divisible by kv={self.num_kv_heads}")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; padded logits are masked and
        sliced off in prefill/decode outputs."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic attention (SSM / hybrid w/ sliding window)."""
        return self.attn_free or self.ssm_state > 0

    def layer_param_count(self) -> int:
        """Parameters of one decoder layer (attention + FFN + norms).  An
        attention-free layer (rwkv6) counts its r, k, v, g, o projections,
        the decay lora and the mixes in place of attention; a hybrid layer
        (hymba) adds its Mamba heads."""
        d = self.d_model
        attn = 0
        if not self.attn_free:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                attn += self.q_dim + 2 * self.kv_dim
        ssm = 0
        if self.ssm_state > 0 or self.attn_free:
            if self.attn_free:  # rwkv6: r,k,v,g,o (d*d each) + w lora + mixes
                ssm = 5 * d * d + 2 * d * 64 + 6 * d
            else:  # hymba mamba heads: in/out proj + dt/B/C projections
                h = self.q_dim
                ssm = d * 2 * h + h * d + h * (2 * self.ssm_state + 2)
        n_mlp_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.is_moe:
            ffn = self.num_experts * n_mlp_mats * d * self.d_ff + d * self.num_experts
        else:
            ffn = n_mlp_mats * d * self.d_ff
        norms = 2 * d
        return attn + ssm + ffn + norms

    def param_count(self) -> int:
        """Total parameter count (embeddings + layers [+ encoder, + cross])."""
        total = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        total += self.num_layers * self.layer_param_count() + self.d_model
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            d = self.d_model
            cross = d * self.q_dim + 2 * max(self.vision_d_model, d) * self.kv_dim + self.q_dim * d
            total += n_cross * cross
        if self.encoder_layers:
            total += self.encoder_layers * self.layer_param_count()
            # decoder cross-attention in every decoder layer
            d = self.d_model
            total += self.num_layers * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        n_mlp_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        all_exp = self.num_layers * self.num_experts * n_mlp_mats * self.d_model * self.d_ff
        act_exp = self.num_layers * self.experts_per_token * n_mlp_mats * self.d_model * self.d_ff
        return full - all_exp + act_exp

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# Shapes each family actually runs (assignment rules):
#  - long_500k only for sub-quadratic archs,
#  - decode shapes for all (no encoder-only archs among the 10).
def shapes_for(cfg: ArchConfig) -> Tuple[InputShape, ...]:
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue  # quadratic attention: no 512k context
        if s.kind == "decode" and cfg.family == "encoder":
            continue  # encoder-only: no decode step
        out.append(s)
    return tuple(out)
