"""Workload-family registry — named, parameterized instance generators.

Mirrors the solver registry in ``core/api.py``: a family is a callable
``fn(rng, **params) -> Instance`` registered under a name, so suites,
benchmarks, and tests enumerate scenarios instead of hard-coding the one
paper recipe.  Every generated instance is validated on the way out
(:func:`~repro_torch.core.mdfg.validate_instance` — acyclicity, compatible cores,
slow-tier feasibility), so a family that produces a malformed graph fails
at generation, not deep inside a solver.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core.mdfg import Instance, validate_instance

__all__ = [
    "Family",
    "register_family",
    "get_family",
    "list_families",
    "generate",
]


@dataclasses.dataclass(frozen=True)
class Family:
    """One registered workload family."""

    name: str
    fn: Callable[..., Instance]
    description: str = ""
    defaults: dict = dataclasses.field(default_factory=dict)

    def generate(self, rng: np.random.Generator | int = 0, **params) -> Instance:
        kw = dict(self.defaults)
        kw.update(params)
        inst = self.fn(np.random.default_rng(rng), **kw)
        validate_instance(inst)
        inst.family = self.name  # provenance for sweep reports / aggregation
        return inst


_REGISTRY: dict[str, Family] = {}


def register_family(name: str, fn: Callable[..., Instance] | None = None, *,
                    description: str = "", defaults: dict | None = None):
    """Register ``fn`` under ``name``; usable as a decorator."""

    def _register(f):
        if name in _REGISTRY:
            raise ValueError(f"family {name!r} already registered")
        _REGISTRY[name] = Family(name=name, fn=f, description=description,
                                 defaults=dict(defaults or {}))
        return f

    return _register if fn is None else _register(fn)


def get_family(name: str) -> Family:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown family {name!r}; registered: {', '.join(sorted(_REGISTRY))}"
        ) from None


def list_families() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def generate(family: str, rng: np.random.Generator | int = 0,
             **params) -> Instance:
    """Generate one validated instance of a registered family.

    >>> inst = generate("out_tree", 7, n_tasks=63, fanout=2)
    """
    return get_family(family).generate(rng, **params)
