"""The training step's share of the chip's bf16 peak (989 TFLOP/s, H100 SXM,
dense), in %: the model FLOPs of the steps the window ran after the
profiled ones (``flops.train_model_flops``: 6 per active parameter per
token plus attention's scores, x3 for the backward) over their host-clock
seconds."""
from bench.harness import flops


def read(rec):
    units, seconds = rec.steady
    if not units or seconds <= 0:
        return None
    work = sum(flops.train_model_flops(rec.arch, u.batch, u.seq) for u in units if u.ok)
    return 100.0 * work / seconds / flops.PEAK_FLOPS["bfloat16"]
