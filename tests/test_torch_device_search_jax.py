"""The port's device-resident search against the reference's own JAX
engine (``repro.core.device_search.device_multiwalk``) on one case where that
engine agrees with NumPy (seed 0, W=1, the parity profile): the same
trajectory, incumbent and counts.  One JAX compile (~25 s on a CPU), so the
case sits alone in this file."""
import numpy as np
import pytest
from torch_port_helpers import port_instance, port_solution

pytest.importorskip("jax")

from repro.core import random_instance  # noqa: E402
from repro.core.device_search import DeviceConfig as RefDeviceConfig  # noqa: E402
from repro.core.device_search import device_multiwalk as ref_device_multiwalk  # noqa: E402
from repro.core.greedy import construct_greedy  # noqa: E402
from repro.core.tabu import TSParams as RefTSParams  # noqa: E402

from repro_torch.core import device_search as ds  # noqa: E402
from repro_torch.core.tabu import TSParams  # noqa: E402

PARITY = dict(max_unimproved=15, time_limit=1e9, top_k=5, max_iters=40,
              mem_update_period=ds.MEM_UPDATE_DISABLED)


def test_w1_equals_the_references_jax_engine_at_seed_0():
    inst = random_instance(0, n_tasks=40, n_data=100)
    init = construct_greedy(inst, "slack_first", rng=3)
    ref = ref_device_multiwalk(inst, [init.copy()], RefTSParams(seed=3, **PARITY),
                               config=RefDeviceConfig(sync_every=16, crit_cap=32))
    got = ds.device_multiwalk(port_instance(inst), [port_solution(init)],
                              TSParams(seed=3, torch_device="cpu", **PARITY),
                              config=ds.DeviceConfig(sync_every=16, crit_cap=32))
    assert got.history == ref.history
    assert got.best_makespan == ref.best_makespan
    assert (got.iterations, got.n_exact_evals, got.n_approx_evals, got.stop_reason,
            got.n_perturbations) == (ref.iterations, ref.n_exact_evals, ref.n_approx_evals,
                                     ref.stop_reason, ref.n_perturbations)
    assert np.array_equal(got.best.assign, ref.best.assign)
    assert np.array_equal(got.best.mem, ref.best.mem)
    assert got.best.proc_seq == [list(map(int, s)) for s in ref.best.proc_seq]
