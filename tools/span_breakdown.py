"""Which op, under which of the program's spans, launches each kernel of a
training step: the benchmark's granite cell (its configuration, traffic mix
and weights, through ``bench/harness/port.py``) trained for ``--warm`` steps,
then ``--steps`` steps under ``torch.profiler``.

    python3 tools/span_breakdown.py [--seed N] [--steps 1] [--out FILE]

Each kernel is followed from the op that launched it (the profiler's
correlation) up its host parents to the innermost ``repro.*`` range that
holds it; an op on autograd's device thread outside any range there is put
under the range open on another thread at its start (the step's backward).
Prints, per profiled step, the spans' device milliseconds from the
program's tracer (CUDA events), the kernels' device milliseconds by phase
(forward, backward, optimizer: the ``repro.train.*`` range open when the op
started) and by span, and by (kernel, span, the ops from the outermost down
to the launching one), largest first, the copy kernels
(``direct_copy_kernel``) apart; ``--out`` (default
``build/span_breakdown.json``) keeps every row.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "build"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CELL = "granite-moe-1b-a400m.train.2x4096"
PHASES = ("repro.train.forward", "repro.train.backward", "repro.train.optimizer")


def _innermost(ranges: list, starts: list, t: float, default: str = "(none)") -> str:
    """The name of the shortest of ``ranges`` (sorted (start, end, name))
    open at ``t``."""
    open_ = [r for r in ranges[:bisect.bisect_right(starts, t)] if r[1] >= t]
    return min(open_, key=lambda r: r[1] - r[0])[2] if open_ else default


def attribute(events) -> list:
    """(kernel name, span, op chain, phase, device ms) for every kernel the
    host ops among ``events`` (the profiler's ``FunctionEvent``s) launched;
    the phase is the ``repro.train.*`` phase open when the op started."""
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.name.startswith("repro.") and str(e.device_type).endswith("CPU"))
    starts = [r[0] for r in ranges]
    phases = [r for r in ranges if r[2] in PHASES]
    phase_starts = [r[0] for r in phases]
    rows = []
    for e in events:
        if not e.kernels or e.name.startswith(("repro.", "cuda")):
            continue                  # a runtime call's kernels are its op's
        chain, span, up = [], None, e
        while up is not None:
            if up.name.startswith("repro."):
                span = up.name
                break
            chain.append(up.name)
            up = up.cpu_parent
        if span is None:          # innermost range open at the op's start, any thread
            span = _innermost(ranges, starts, e.time_range.start)
        ops = " > ".join(reversed(chain))
        phase = _innermost(phases, phase_starts, e.time_range.start)
        rows += [(k.name, span, ops, phase, k.duration / 1e3) for k in e.kernels]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1234)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_breakdown.json"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.harness import port, spec
    from bench.harness.arch import arch_of
    from bench.harness.record import Record
    from bench.kinds import train as train_kind
    from repro_torch import tracing

    dev = torch.device("cuda", 0)
    cell = spec.cell(CELL)
    rec = Record(name=CELL, config=cell.config, traffic=cell.traffic,
                 arch=arch_of(cell.config), limits=cell.limits)
    tr = port.build_trainer(cell.config, cell.traffic, rec.arch, args.seed, dev, {})
    state = tr.state
    for step in range(1, args.warm + 1):
        state, _ = tr.step_fn(state, train_kind.batch(rec, args.seed, step, dev))
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for step in range(args.warm + 1, args.warm + args.steps + 1):
            state, _ = tr.step_fn(state, train_kind.batch(rec, args.seed, step, dev))
        torch.cuda.synchronize(dev)
    s = tracing.summary()
    n = args.steps
    phases = {name: {part: round(v["device_ms"] / n, 3) for part, v in d.items() if v["calls"]}
              for name, d in s["spans"].items()}
    events = prof.events()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / n
    rows = attribute(events)
    sums, by_span, by_phase = collections.Counter(), collections.Counter(), \
        collections.Counter()
    for name, span, ops, phase, ms in rows:
        sums[(name[:120], span, ops[-200:])] += ms / n
        by_span[span] += ms / n
        by_phase[phase] += ms / n
    copies = collections.Counter({k: v for k, v in sums.items() if "direct_copy_kernel" in k[0]})
    out = {"cell": CELL, "seed": args.seed, "steps": n, "device": torch.cuda.get_device_name(dev),
           "kernel_ms_per_step": round(busy, 3), "launches_per_step": len(kernels) / n,
           "attributed_ms_per_step": round(sum(by_span.values()), 3),
           "spans": phases, "counts": s["counts"],
           "kernel_ms_by_phase": {k: round(v, 3) for k, v in by_phase.most_common()},
           "kernel_ms_by_span": {k: round(v, 3) for k, v in by_span.most_common()},
           "copies": [[*k, round(v, 3)] for k, v in copies.most_common(args.top)],
           "top": [[*k, round(v, 3)] for k, v in sums.most_common(args.top)]}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({**out, "rows": [[*k, v] for k, v in
                                                          sums.most_common()]}))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
