"""Device milliseconds per profiled step of the training step's backward: the
program's span ``repro.train.backward`` around ``loss.backward()`` (CUDA
events on the step's stream)."""
from bench.harness.program import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "repro.train.step", ("repro.train.backward",))
