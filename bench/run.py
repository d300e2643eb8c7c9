"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cells, their configurations, traffic mixes
and metrics are named in ``BENCHMARK.json``; ``bench/harness/spec.py`` says
where each lives.  Measures ``repro_torch`` (``src/``) on the CUDA devices of
this machine and nothing else: without as many devices as the cell asks for,
or with JAX or the JAX package ``repro`` loaded once the window has closed,
it prints no result and exits with a code other than 0.

The last line of standard output is the result (JSON); the numbers compared
for ``correct`` come last in it, under ``checks``, and again as the last
lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed place in the checkout
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import runner, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, rec = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_START)
    bad = runner.foreign_modules()
    if bad:
        print(f"modules that must not be loaded were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"setup_s": rec.setup_s, "window_s": rec.window_s, "spans": rec.spans,
                      "notes": rec.notes}), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
