"""repro_torch.instances — the workload subsystem.

Everything about *what* gets solved lives here, decoupled from *how*:

* :mod:`~repro_torch.instances.registry` — named, parameterized workload
  families (``register_family`` / ``get_family`` / ``list_families`` /
  ``generate``);
* :mod:`~repro_torch.instances.generators` — the registered families: the paper
  recipe (vectorized), tree-structured graphs, FFT-butterfly and stencil
  DSP graphs;
* :mod:`~repro_torch.instances.batch` — :class:`InstancePack` /
  :class:`InstanceBatch`, the one padded/bucketed array form every engine
  layer consumes (``eval_batch``, ``kernels/schedule_dp``,
  ``device_search.solve_instances``);
* :mod:`~repro_torch.instances.bounds` — family-independent makespan lower
  bounds (critical path / work / memory spill) for cross-family quality
  comparison;
* :mod:`~repro_torch.instances.suites` — named suites, ``.npz`` round-trip,
  and the bucket-grouped ``sweep`` driver (one captured launch per shape
  bucket on the device backend).
"""
from .registry import Family, generate, get_family, list_families, register_family
from . import generators as _generators  # noqa: F401  (registers families)
from .batch import InstanceBatch, InstancePack, group_by_bucket, pack_instance
from .bounds import bounds, cp_lower_bound, lower_bound, mem_lower_bound, work_lower_bound
from .suites import (
    Suite,
    SuiteItem,
    SweepReport,
    get_suite,
    list_suites,
    load_npz,
    register_suite,
    save_npz,
    sweep,
)

__all__ = [
    "Family",
    "register_family",
    "get_family",
    "list_families",
    "generate",
    "InstancePack",
    "InstanceBatch",
    "pack_instance",
    "group_by_bucket",
    "bounds",
    "lower_bound",
    "cp_lower_bound",
    "work_lower_bound",
    "mem_lower_bound",
    "Suite",
    "SuiteItem",
    "SweepReport",
    "register_suite",
    "get_suite",
    "list_suites",
    "save_npz",
    "load_npz",
    "sweep",
]
