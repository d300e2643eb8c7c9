"""The 90th percentile, over every request of the window, of the time from
when a request was due to its first token on the host (host clock).  A
failed request counts as never answered."""
import statistics


def read(rec):
    if len(rec.units) < 10:
        return None
    times = [(u.done - u.due) * 1e3 if u.ok else float("inf") for u in rec.units]
    return statistics.quantiles(times, n=10, method="inclusive")[-1]
