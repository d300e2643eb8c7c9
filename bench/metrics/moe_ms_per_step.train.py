"""Device milliseconds per profiled step of the MoE blocks: the program's
spans ``repro.moe``, forward, backward and the blocks' recomputes in the
backward, over every layer (CUDA events on the stream that ran them)."""
from bench.harness.program import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "repro.train.step", ("repro.moe",))
