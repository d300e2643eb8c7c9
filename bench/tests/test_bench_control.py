"""The control and the faults (``bench/control.py``) at the smoke size on
the CPU: each comes out not correct against the cell's limits, as it does
on the chip at the cell's own size."""
from __future__ import annotations

import pytest
import torch

from bench import control
from bench.harness import spec
from bench.tests import smoke

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_control_and_faults_of_the_train_cell_fail(root, seed):
    name = "granite-moe-1b-a400m.train.2x4096"
    out = control.readings(name, seed, "cpu", root)
    limits = spec.cell(name, root).limits
    for reading in ("control", "half_batch", "unchanged"):
        assert fails(out[reading], limits), reading
    assert out["unchanged"]["grad_gap"] == out["unchanged"]["update_gap"] == 1.0


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_control_and_fault_of_the_prefill_cell_fail(root, seed):
    name = "qwen2.5-14b.prefill.longdoc"
    out = control.readings(name, seed, "cpu", root)
    limits = spec.cell(name, root).limits
    assert fails(out["control"], limits) and fails(out["token_altered"], limits)
    # read where a run compares: as many requests, the longest among them
    traffic = spec.cell(name, root).traffic
    assert len(out["requests"]) == traffic["checked_requests"]
    assert out["lengths"][0] == max(out["lengths"]) == max(traffic["lengths"])
