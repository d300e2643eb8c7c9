"""Device milliseconds per profiled step of the optimizer: the program's span
``repro.train.optimizer`` around ``Optimizer.apply`` (the global norm, the
clip and AdamW; CUDA events on the step's stream)."""
from bench.harness.program import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "repro.train.step", ("repro.train.optimizer",))
