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
  ``device_search.solve_instances``).
"""
from .registry import Family, generate, get_family, list_families, register_family
from . import generators as _generators  # noqa: F401  (registers families)
from .batch import InstanceBatch, InstancePack, group_by_bucket, pack_instance

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
]
