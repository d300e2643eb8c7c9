"""The model/architecture configuration dataclass (the reference's
``ModelConfig``, as it is)."""
from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Layer kinds in ``layer_pattern`` (cycled over
    ``n_layers``): "attn" (global), "attn_local" (sliding window), "rec"
    (RG-LRU block), "ssm" (Mamba-2 SSD block)."""

    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # attention
    qkv_bias: bool = False
    attn_window: int | None = None    # for "attn_local" layers
    rope_theta: float = 10_000.0
    # norm / act / mlp
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"
    glu: bool = True
    mlp_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # hybrid / recurrent
    layer_pattern: tuple[str, ...] = ("attn",)
    lru_width: int = 0
    conv1d_width: int = 4
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    # encoder-decoder (Whisper): encoder_layers > 0 enables the cross stack
    encoder_layers: int = 0
    n_frames: int = 1500              # stub audio frontend output length
    # VLM stub frontend
    n_vis_tokens: int = 0
    # embeddings
    tie_embeddings: bool = False
    emb_scale: bool = False           # gemma-style sqrt(d_model) scaling
    # numerics / lowering
    dtype: str = "bfloat16"
    scan_layers: bool = True          # scan over layers when pattern is uniform
    remat: str = "plan"               # none | full | plan (HDATS-planned policy)
    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def kinds(self) -> tuple[str, ...]:
        """Per-layer kind sequence (pattern cycled over n_layers)."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def uniform(self) -> bool:
        return len(set(self.kinds)) == 1

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def tail_kinds(self) -> tuple[str, ...]:
        """Layers past the last full pattern period (unrolled)."""
        return self.kinds[self.n_periods * len(self.layer_pattern):]

    @property
    def period_scan(self) -> bool:
        """Heterogeneous stacks scan over stacked pattern *periods* (unrolled
        per-layer remat lets XLA schedule every layer's remat transients
        concurrently — observed +100 GiB peaks; the scan forces sequencing)."""
        return (not self.uniform) and self.scan_layers and self.n_periods >= 2

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """True when decode state is O(1)/O(window) — long_500k eligibility."""
        kinds = set(self.kinds)
        if "attn" in kinds and self.attn_window is None:
            return False
        if "attn" in kinds and self.family not in ("moe", "hybrid", "ssm"):
            # global attention layers without window
            return self.attn_window is not None
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        d, v = self.d_model, self.padded_vocab
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        hd = self.resolved_head_dim
        for kind in self.kinds:
            if kind in ("attn", "attn_local"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                if self.qkv_bias:
                    total += hd * (self.n_heads + 2 * self.n_kv_heads)
            elif kind == "rec":
                w = self.lru_width or d
                total += 2 * d * w + w * d + 3 * w + self.conv1d_width * w
            elif kind == "ssm":
                di, n, g = self.d_inner, self.ssm_state, self.ssm_groups
                total += d * (2 * di + 2 * g * n + self.n_ssm_heads) + di * d
                total += self.conv1d_width * (di + 2 * g * n) + 2 * self.n_ssm_heads
            if kind != "ssm":
                if self.n_experts:
                    total += self.n_experts * (d * self.d_ff * (3 if self.glu else 2))
                    total += d * self.n_experts
                else:
                    total += d * self.d_ff * (3 if self.glu else 2)
            total += 2 * d  # norms
        for _ in range(self.encoder_layers):  # whisper encoder blocks
            total += 4 * d * d + 2 * d * self.d_ff + 2 * d
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        dense = self.param_count()
        moe_per_layer = self.n_experts * (self.d_model * self.d_ff * (3 if self.glu else 2))
        active_per_layer = self.top_k * (self.d_model * self.d_ff * (3 if self.glu else 2))
        n_moe_layers = sum(1 for k in self.kinds if k != "ssm")
        return dense - n_moe_layers * (moe_per_layer - active_per_layer)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape × step-kind) cell from the brief."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)
