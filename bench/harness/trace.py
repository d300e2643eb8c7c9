"""A profiled stretch of the window: the device's kernels from
``torch.profiler``, the busy time (the union of their intervals), the idle
gaps between them and what the host was doing in each.

``kernel_class`` is a frozen copy of ``chip_smoke.py``'s ``_kernel_class``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["Trace", "Profiled", "kernel_class", "top_by_name"]


def kernel_class(name: str) -> str:
    if "flash_bwd_" in name:         # K2's backward: delta, dk/dv (_mma_ in bf16), reduce, dq
        return "K2 bwd flash_attention_bwd"
    if "rglru_scan_bwd" in name:     # K3's backward: the reverse scan
        return "K3 bwd rglru_scan_bwd"
    if "ssd_bwd_" in name:           # K4's backward: states, chunks, dB / dC, the sums
        return "K4 bwd ssd_chunked_bwd"
    if "sweep_kernel" in name:       # K1's four instances
        return "K1 schedule_dp"
    if "seq_cumsum" in name:
        return "seq_cumsum"
    if "flash_fwd" in name:          # flash_fwd_kernel (f32), flash_fwd_mma_kernel (bf16)
        return "K2 flash_attention"
    if "rglru_scan" in name:         # rglru_scan_kernel (T >= 2), rglru_scan_step_kernel
        return "K3 rglru_scan"
    if "ssd_chunk" in name:          # ssd_chunk_kernel, ssd_chunk_mma_kernel (bf16 prefill)
        return "K4 ssd_chunked"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "matmul", "splitk")):
        return "matmul (cuBLAS)"
    return "elementwise / reduction / copy"


@dataclasses.dataclass
class Trace:
    """``kernels``: (name, start, end) in microseconds of the profiler's
    clock; ``window_s``: the host's seconds from the first unit's start to
    the last unit's end, synchronised; ``busy_s``: the union of the kernels'
    intervals; ``gaps``: (what the host was doing, seconds) of each idle
    stretch between kernels."""
    kernels: list
    window_s: float
    busy_s: float
    gaps: list


def top_by_name(items, n: int = 10) -> list:
    """[[name, seconds], ...]: the ``n`` largest sums by name."""
    sums: dict = {}
    for name, sec in items:
        sums[name] = sums.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals: list) -> tuple[float, list]:
    """Total covered length and the gaps between merged intervals."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _host_doing(cpu: list, gaps: list) -> list:
    """Name each gap by the innermost host event (latest start) that covers
    its midpoint; runtime calls (``cuda*``) are named with the op that made
    them where one covers it too."""
    cpu.sort()
    out, active, nxt = [], [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while nxt < len(cpu) and cpu[nxt][0] <= mid:
            active.append(cpu[nxt])
            nxt += 1
        active = [c for c in active if c[1] >= mid]        # started before mid, still open
        inner = max(active, default=None)
        ops = [c for c in active if not c[2].startswith("cuda")]
        op = max(ops, default=None)
        if inner is None:
            label = "(no host event)"
        elif op is None or op is inner:
            label = inner[2]
        else:
            label = f"{op[2]} > {inner[2]}"
        out.append((label, (e - s) / 1e6))
    return out


class Profiled:
    """``with Profiled(device) as p: ...`` profiles the block; ``p.trace``
    holds its :class:`Trace` afterwards."""

    def __init__(self, device):
        self.device = device
        self.trace: Trace | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        # acc_events: keep every record of the window
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             acc_events=True)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        kernels, cpu = [], []
        for ev in self._prof.events():
            r = ev.time_range
            if str(ev.device_type).endswith("CUDA"):
                kernels.append((ev.name, r.start, r.end))
            else:
                cpu.append((r.start, r.end, ev.name))
        if not kernels:
            raise RuntimeError("the profiler recorded no device operation in the traced window")
        busy_us, gaps = _union([(s, e) for _, s, e in kernels])
        first = min([c[0] for c in cpu] + [s for _, s, _ in kernels])
        lead = min(s for _, s, _ in kernels)
        if lead > first:
            gaps.insert(0, (first, lead))
        self.trace = Trace(kernels=kernels, window_s=window_s, busy_s=busy_us / 1e6,
                           gaps=_host_doing(cpu, gaps))
        del self._prof
        return False
