"""Device operations (kernels, copies, sets) the profiler recorded per
profiled training step."""


def read(rec):
    if rec.trace is None or not rec.profiled:
        return None
    return len(rec.trace.kernels) / rec.profiled
