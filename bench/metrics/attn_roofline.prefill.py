"""Attention's forward in the prefill against its roofline, in %: the least
time the profiled requests' attention could take (``flops.flash_bound`` from
their shapes, once per attention layer and request) over the device time of
the kernels that did that work.  The kernels are matched by name, the port's
K2 and the libraries' attention forwards alike, so a library kernel in its
place is measured on the same yardstick."""
from bench.harness import flops

KERNELS = ("flash_fwd", "fmha_cutlassf", "fmha_fwd", "attention_fwd", "sdpa_fprop",
           "flash_fprop")


def read(rec):
    if rec.trace is None or not rec.profiled:
        return None
    us = sum(e - s for n, s, e in rec.trace.kernels if any(k in n.lower() for k in KERNELS))
    if us <= 0:
        return None
    a = rec.arch
    bound = sum(a.n_layers * flops.flash_bound(u.batch, u.seq, u.seq, a.heads, a.kv_heads,
                                               a.head_dim, True, a.dtype)["seconds"]
                for u in rec.profiled_units)
    return 100.0 * bound / (us / 1e6)
