"""The device's idle share over the profiled requests: 1 - busy / wall, busy
the union of the device operations' intervals (device trace), in %."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
