"""Lint rule registry.

Each rule is a :class:`Rule` with a stable id (``RPR1xx`` = the captured
round's discipline (the reference's jit/tracing rules, re-aimed at CUDA
graphs), ``RPR2xx`` = validation discipline, ``RPR3xx`` = concurrency,
randomness, and fault-tolerance discipline), a one-line ``doc`` shown by ``--rules``, an
``applies(modpath)`` scope filter over the path relative to the
``repro_torch`` package, and ``check(tree, modpath)`` returning findings.

Suppression: ``# lint: allow[RPRnnn] <justification>`` on the finding's
line or the line above; the justification is mandatory and should cite
the DESIGN.md section that permits the exception (rule RPR000 fires on
bare suppressions).
"""
from __future__ import annotations

import dataclasses
import typing

import ast

__all__ = ["Finding", "Rule", "all_rules"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One span-accurate lint finding."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def key(self) -> str:
        return f"{self.rule}:{self.path}"

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    doc: str
    applies: "typing.Callable[[str], bool]"
    check: "typing.Callable[[ast.AST, str], list[Finding]]"


def all_rules() -> "list[Rule]":
    from . import concurrency, robustness, torch_discipline, validation

    return (
        torch_discipline.RULES
        + validation.RULES
        + concurrency.RULES
        + robustness.RULES
    )
