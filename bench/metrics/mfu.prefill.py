"""The prefill's share of the chip's bf16 peak (989 TFLOP/s, H100 SXM,
dense), in %: the model FLOPs of the requests the window served after the
profiled ones (``flops.prefill_model_flops``: 2 per non-embedding active
parameter per prompt token plus attention's scores) over their host-clock
seconds."""
from bench.harness import flops


def read(rec):
    units, seconds = rec.steady
    if not units or seconds <= 0:
        return None
    work = sum(u.batch * flops.prefill_model_flops(rec.arch, u.seq) for u in units if u.ok)
    return 100.0 * work / seconds / flops.PEAK_FLOPS["bfloat16"]
