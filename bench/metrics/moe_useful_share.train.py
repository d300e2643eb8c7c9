"""The share of the MoE's computed token-expert pairs that the router chose,
in %: the program's counters ``moe.pairs_routed`` (B S k a block) over
``moe.pairs_computed`` (B S E: the pairs the dispatch runs) in the profiled
steps."""
from bench.harness.program import count_per_unit


def read(rec):
    routed = count_per_unit(rec, "repro.train.step", "moe.pairs_routed")
    computed = count_per_unit(rec, "repro.train.step", "moe.pairs_computed")
    if routed is None or not computed:
        return None
    return 100.0 * routed / computed
