"""Device milliseconds per profiled request of the norms and RoPE: the
program's spans ``repro.norm`` and ``repro.rope`` (CUDA events on the
request's stream)."""
from bench.harness.program import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "repro.serve.request", ("repro.norm", "repro.rope"))
