"""Read the control and the faults of a cell: the upper readings that
``correct``'s limits are set below.  Not run by the benchmark's runs.

    python3 bench/control.py --workload <cell> --seeds 11 12 13

For each seed it prints one JSON line with the numbers the cell compares,
each against the float32 reference from the same weights and inputs:

* ``control``: the reference itself in the nearest precision below the
  configuration's bf16, float8 (``reference.decoder.FP8``: e4m3 products'
  operands and stored tensors, e5m2 gradients); prefill cells also read
  ``fp8_products`` (``reference.decoder.FP8_PRODUCTS``: float8 GEMMs alone);
* training cells: ``half_batch`` (the reference on half of each batch, the
  mean over the rest) and ``unchanged`` (a step that returns its state: the
  step-1 loss every step, no gradient, no change);
* prefill cells: ``token_altered`` (the served token one id past the
  reference's first choice).  The control stands in the program's place at
  exactly what a run compares: the last position of the requests a run
  checks, its token the control's first choice, its logits the control's.

The requests are those a run of the seed checks (``kinds.prefill.sample``)
when its window served ``--requests`` of them (a 40 s window served
123-141, about 3 a second), the lengths cycled as the run cycles them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def train_readings(rec, seed: int, device) -> dict:
    from bench.kinds import train
    from bench.reference import decoder
    from bench.reference import train as ref_train

    t = rec.traffic
    batches = [(b["tokens"], b["labels"]) for b in
               (train.batch(rec, seed, s, device) for s in range(1, t["checked_steps"] + 1))]

    def steps(**kw):
        return ref_train.steps(rec.arch, seed, batches, t["optimizer"], t["z_loss"], device, **kw)

    ref = steps()
    unchanged = {"losses": [ref["losses"][0]] * len(ref["losses"]),
                 "grad_norms": dict.fromkeys(ref["grad_norms"], 0.0),
                 "change_norms": dict.fromkeys(ref["change_norms"], 0.0)}
    out = {"reference_losses": ref["losses"]}
    for name, prog in (("unchanged", unchanged),
                       ("half_batch", steps(rows=slice(0, t["batch"] // 2))),
                       ("control", steps(prec=decoder.FP8))):
        out[name] = {k: v for k, (v, _) in train.numbers(prog, ref).items()}
        out[name + "_leaves"] = {k: leaf for k, (_, leaf) in train.numbers(prog, ref).items()}
        out[name + "_spread"] = train.spread(prog, ref)
    return out


def prefill_readings(rec, seed: int, device, requests: int) -> dict:
    from bench.kinds import prefill
    from bench.reference import decoder
    from bench.reference import prefill as ref_prefill

    t = rec.traffic
    cycle = prefill.order(t, seed)
    lengths = [cycle[r % len(cycle)] for r in range(requests)]
    picks = prefill.sample(lengths, seed, t["checked_requests"])
    prompts = [p for r in picks for p in prefill.prompt(rec, seed, r, lengths[r], device)]
    precs = {"control": decoder.FP8, "fp8_products": decoder.FP8_PRODUCTS}
    ref, *lows = ref_prefill.last_logits(rec.arch, seed, prompts, device,
                                         (decoder.FP32, *precs.values()))
    out = {"requests": picks, "lengths": [len(p) for p in prompts]}
    for name, low in zip(precs, lows):
        gaps = prefill.token_gaps(ref, [int(lg.argmax()) for lg in low])
        errs = prefill.logit_errors(ref, low)
        out[name] = {"token_gap": max(gaps), "logit_err": max(errs)}
        out[name + "_per_prompt"] = {"token_gap": gaps, "logit_err": errs}
    altered = prefill.token_gaps(ref, [(int(lg.argmax()) + 1) % lg.shape[0] for lg in ref])
    out["token_altered"] = {"token_gap": max(altered), "logit_err": 0.0}
    out["token_altered_per_prompt"] = {"token_gap": altered}
    return out


def readings(name: str, seed: int, device, root=None, requests: int = 160) -> dict:
    from bench.harness import spec
    from bench.harness.arch import arch_of
    from bench.harness.record import Record

    cell = spec.cell(name, root or spec.ROOT)
    rec = Record(name=name, config=cell.config, traffic=cell.traffic,
                 arch=arch_of(cell.config), limits=cell.limits)
    if cell.traffic["kind"] == "train":
        return train_readings(rec, seed, device)
    return prefill_readings(rec, seed, device, requests)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=160,
                    help="prefill cells: the requests a run's window served")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(args.workload, seed, torch.device("cuda", 0), requests=args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
