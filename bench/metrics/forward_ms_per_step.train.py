"""Device milliseconds per profiled step of the training step's forward: the
program's span ``repro.train.forward`` around the loss (CUDA events on the
step's stream)."""
from bench.harness.program import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "repro.train.step", ("repro.train.forward",))
