"""Device milliseconds per profiled step in kernels that are neither a
matrix product nor one of the port's hand-written kernels (elementwise,
reduction and copy work; ``harness.trace.kernel_class``)."""
from bench.harness.trace import kernel_class


def read(rec):
    if rec.trace is None or not rec.profiled:
        return None
    us = sum(e - s for n, s, e in rec.trace.kernels
             if kernel_class(n) == "elementwise / reduction / copy")
    return us / 1e3 / rec.profiled
