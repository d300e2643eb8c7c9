"""Public kernel entry points of the model path (the reference's ``ops``).

Each op has one route per device: a CUDA tensor launches the hand-written
kernel, a CPU tensor takes the kernel's plain PyTorch version.  There is no
other route: no shape is handed to a fallback (the kernels mask their ragged
edges), and there is no ``impl=`` switch and no tile-size argument (tiling is
the kernel's own).  The models call the ops through this module's
attributes.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .moe_dispatch import grouped_mm, moe_combine, moe_order, moe_permute, moe_swiglu
from .rglru import rglru_scan
from .ssd import ssd_chunked

__all__ = ["flash_attention", "grouped_mm", "moe_combine", "moe_order", "moe_permute",
           "moe_swiglu", "rglru_scan", "ssd_chunked"]
