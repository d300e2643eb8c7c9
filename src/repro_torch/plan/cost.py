"""Analytical cost model used to build planner MDFGs (the reference's, with
the hardware constants as a named parameter).

:class:`Hardware` holds a device's peak bf16 rate, memory rate and size, host
link and inter-device link.  Two are defined:

* ``TPU_V5E``: the reference's constants (197 TFLOP/s bf16 per chip, 819 GB/s
  HBM, 16 GiB, ~50 GB/s/link ICI, a 25 GB/s host offload link), kept so the
  port's instances can be held against the reference's;
* ``H100``: one NVIDIA H100 SXM from NVIDIA's data sheet: 989 TFLOP/s dense
  bf16, 3.35 TB/s and 80 GB of HBM3, NVLink 900 GB/s per card (450 GB/s each
  way), and a PCIe Gen5 x16 host link of 128 GB/s (64 GB/s each way).  The
  port's launcher plans with it.

The module-level ``PEAK_FLOPS`` ... ``HBM_BYTES`` are the reference's (TPU)
names and values.  All times in seconds for one *per-device* slice of the
step.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeCell

@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float    # bf16 FLOP/s per device
    hbm_bw: float        # bytes/s
    hbm_bytes: float     # device memory
    host_bw: float       # bytes/s, the offload path
    ici_bw: float        # bytes/s per link between devices


TPU_V5E = Hardware("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, hbm_bytes=16 * 1024 ** 3,
                   host_bw=25e9, ici_bw=50e9)
H100 = Hardware("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
                host_bw=64e9, ici_bw=450e9)

PEAK_FLOPS = TPU_V5E.peak_flops
HBM_BW = TPU_V5E.hbm_bw
ICI_BW = TPU_V5E.ici_bw
HOST_BW = TPU_V5E.host_bw
HBM_BYTES = TPU_V5E.hbm_bytes


@dataclasses.dataclass(frozen=True)
class LayerCost:
    kind: str
    flops_fwd: float          # per-device forward FLOPs
    act_bytes: dict[str, float]   # named activation classes -> bytes (per device)
    weight_bytes: float
    peak_flops: float = PEAK_FLOPS

    @property
    def time_fwd(self) -> float:
        return self.flops_fwd / self.peak_flops

    @property
    def time_bwd(self) -> float:
        return 2.0 * self.time_fwd


def _tokens_per_device(cell: ShapeCell, n_data_shards: int) -> float:
    return cell.global_batch * cell.seq_len / n_data_shards


def layer_costs(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    n_data_shards: int = 16,
    n_model_shards: int = 16,
    dtype_bytes: int = 2,
    hw: Hardware = H100,
) -> list[LayerCost]:
    """Per-layer fwd FLOPs + named activation footprints, per device."""
    toks = _tokens_per_device(cell, n_data_shards)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    tp = n_model_shards
    out: list[LayerCost] = []
    for kind in cfg.kinds:
        acts: dict[str, float] = {}
        flops = 0.0
        wbytes = 0.0
        if kind in ("attn", "attn_local"):
            qkv_flops = 2 * toks * d * hd * (h + 2 * kvh) / tp
            ctx = cell.seq_len if kind == "attn" else min(cfg.attn_window or cell.seq_len, cell.seq_len)
            attn_flops = 2 * toks * ctx * hd * h / tp * 2  # qk + pv
            if kind == "attn" and cell.kind == "train":
                attn_flops /= 2  # causal: half the score matrix
            proj_flops = 2 * toks * h * hd * d / tp
            flops = qkv_flops + attn_flops + proj_flops
            acts["attn_q"] = toks * h * hd * dtype_bytes / tp
            acts["attn_kv"] = 2 * toks * kvh * hd * dtype_bytes / tp
            acts["attn_out"] = toks * h * hd * dtype_bytes / tp
            wbytes = d * hd * (h + 2 * kvh + h) * dtype_bytes / tp
        elif kind == "rec":
            w = cfg.lru_width or d
            flops = 2 * toks * (2 * d * w + 2 * w * w + w * d) / tp
            acts["rec_out"] = toks * w * 4 / tp  # fp32 scan output
            wbytes = (3 * d * w + 2 * w * w) * dtype_bytes / tp
        elif kind == "ssm":
            di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            chunk = 128
            flops = (2 * toks * d * (2 * di + 2 * cfg.ssm_groups * n + nh)
                     + 2 * toks * chunk * (di + n * di / 64)
                     + 2 * toks * di * d) / tp
            acts["ssm_out"] = toks * di * 4 / tp
            wbytes = d * (2 * di + 2 * cfg.ssm_groups * n + nh + di) * dtype_bytes / tp
        if cfg.d_ff > 0 and kind != "ssm":
            n_mats = 3 if cfg.glu else 2
            active = cfg.top_k if cfg.n_experts else 1
            flops += 2 * toks * d * cfg.d_ff * n_mats * active / tp
            name = "moe_hidden" if cfg.n_experts else "mlp_hidden"
            acts[name] = toks * cfg.d_ff * active * dtype_bytes / tp
            wbytes += (cfg.n_experts or 1) * d * cfg.d_ff * n_mats * dtype_bytes / tp
        acts["resid_mid"] = toks * d * dtype_bytes
        acts["resid_out"] = toks * d * dtype_bytes
        out.append(LayerCost(kind=kind, flops_fwd=flops, act_bytes=acts, weight_bytes=wbytes,
                             peak_flops=hw.peak_flops))
    return out


def param_state_bytes(
    cfg: ModelConfig,
    *,
    n_devices: int = 256,
    optimizer: str = "adamw",
    param_dtype_bytes: int = 4,
    state_dtype_bytes: int = 4,
) -> float:
    """Per-device bytes held by params + optimizer state (+ grads, bf16)."""
    n = cfg.param_count()
    opt_mult = {"adamw": 2.0, "adamw_bf16": 1.0, "adafactor": 0.02, "sgd": 0.0}[optimizer]
    total = n * (param_dtype_bytes + 2 + opt_mult * state_dtype_bytes)  # +bf16 grads
    return total / n_devices


def hbm_activation_budget(cfg: ModelConfig, *, n_devices: int = 256,
                          optimizer: str = "adamw", headroom: float = 0.9,
                          hw: Hardware = H100) -> float:
    fixed = param_state_bytes(cfg, n_devices=n_devices, optimizer=optimizer)
    return max(0.0, hw.hbm_bytes * headroom - fixed)
