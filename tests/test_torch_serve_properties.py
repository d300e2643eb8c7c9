"""Properties of the port's serve batcher over seeded streams of arrivals
(the reference's hypothesis test, as explicit seeds, since the port's tests
must run where ``hypothesis`` is absent): a cut never mixes launch-shape
signatures, respects ``max_batch``, preserves per-signature FIFO order,
draining loses or duplicates no request, and the resilience controller's
decisions equal the reference's on the same event stream."""
import numpy as np
import pytest
from torch_port_helpers import port_instance

from repro.core import random_instance as ref_random_instance
from repro.faults.errors import CompileTimeout as RefCompileTimeout
from repro.faults.errors import InfeasibleRequest as RefInfeasibleRequest
from repro.faults.errors import LaunchFailure as RefLaunchFailure
from repro.serve import ResilienceController as RefController
from repro.serve import ResiliencePolicy as RefPolicy
from repro.serve import RetryPolicy as RefRetryPolicy

from repro_torch.core import Budget
from repro_torch.faults.errors import CompileTimeout, InfeasibleRequest, LaunchFailure
from repro_torch.serve import (Batcher, BatchPolicy, RequestQueue, ResilienceController,
                               ResiliencePolicy, RetryPolicy)

_INSTANCES = [port_instance(ref_random_instance(s, n_tasks=n, n_data=2 * n))
              for s, n in ((0, 16), (1, 16), (2, 48))]
_BUDGETS = [Budget(max_iters=2), Budget(max_iters=5)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(25))
def test_cuts_partition_requests_without_mixing_signatures(seed):
    rng = np.random.default_rng(seed)
    max_batch = int(rng.integers(1, 7))
    clk = FakeClock()
    queue = RequestQueue(clock=clk)
    batcher = Batcher(queue, BatchPolicy(max_batch=max_batch,
                                         max_wait=float(rng.uniform(0.0, 0.5)),
                                         deadline_slack=0.25))
    submitted, cuts = [], []
    for _ in range(int(rng.integers(1, 25))):
        clk.t += float(rng.uniform(0.0, 0.2))
        submitted.append(queue.submit(_INSTANCES[int(rng.integers(3))],
                                      _BUDGETS[int(rng.integers(2))],
                                      walks=int(rng.choice([1, 2, 4])), seed=len(submitted)))
        cut = batcher.cut()
        if cut is not None:
            cuts.append(cut)
    queue.close()
    while (cut := batcher.cut()) is not None:
        cuts.append(cut)
    assert len(queue) == 0
    for cut in cuts:
        assert len(cut) <= max_batch
        assert all(r.signature == cut.signature for r in cut.requests)
        rids = [r.rid for r in cut.requests]
        assert rids == sorted(rids)
    served = [r.rid for cut in cuts for r in cut.requests]
    assert sorted(served) == [r.rid for r in submitted]


@pytest.mark.parametrize("seed", range(8))
def test_resilience_decisions_equal_the_reference(seed):
    """The same stream of failures, successes, admissions and clock readings
    through both controllers: the same actions, backoffs and counters."""
    rng = np.random.default_rng(seed)
    kw = dict(max_attempts=int(rng.integers(1, 5)), backoff_base=0.05, backoff_factor=2.0,
              backoff_max=float(rng.uniform(0.1, 2.0)), poison_after=int(rng.integers(1, 4)))
    mine = ResilienceController(ResiliencePolicy(retry=RetryPolicy(**kw)))
    ref = RefController(RefPolicy(retry=RefRetryPolicy(**kw)))
    errors = ((LaunchFailure, RefLaunchFailure), (CompileTimeout, RefCompileTimeout),
              (InfeasibleRequest, RefInfeasibleRequest))
    for step in range(60):
        sig, now = int(rng.integers(3)), float(step) * 0.1
        event = rng.integers(3)
        if event == 0:
            depth = int(rng.integers(0, 300))
            dl = None if rng.random() < 0.5 else now + float(rng.uniform(-1, 1))
            a = mine.admit(depth=depth, now=now, deadline=dl)
            b = ref.admit(depth=depth, now=now, deadline=dl)
            assert (a is None) == (b is None)
            if a is not None:
                assert (type(a).__name__, str(a), a.retry_after) == \
                    (type(b).__name__, str(b), b.retry_after)
        elif event == 1:
            cls, ref_cls = errors[int(rng.integers(3))]
            attempts = int(rng.integers(1, 5))
            left = None if rng.random() < 0.5 else float(rng.uniform(0, 1))
            a = mine.on_failure(rid=step, signature=sig, attempts=attempts,
                                exc=cls("x", rid=step), now=now, time_left=left)
            b = ref.on_failure(rid=step, signature=sig, attempts=attempts,
                               exc=ref_cls("x", rid=step), now=now, time_left=left)
            assert (a.action, a.not_before) == (b.action, b.not_before)
            assert type(a.error).__name__ == type(b.error).__name__
        else:
            mine.on_success(sig)
            ref.on_success(sig)
        assert mine.metrics() == ref.metrics()
        assert mine.poisoned == ref.poisoned
        assert [mine.use_fallback(s) for s in range(3)] == [ref.use_fallback(s) for s in range(3)]
