"""Concurrency / determinism rules (DESIGN.md §§9, 11).

RPR301 serve-unlocked-write — in a ``serve`` class that owns a
``threading.Lock``/``RLock``/``Condition``, a ``self.<attr>`` write
outside ``__init__`` that is not inside ``with self.<lock>``.  DESIGN
§11: the service state is shared between the event loop, the dispatch
thread, and the solve lane; the only sanctioned unlocked handoffs are
documented (and suppressed with a justification citing §11).

RPR302 legacy-np-random — ``np.random.<fn>`` global-RNG calls.  All
randomness must flow through seeded ``np.random.default_rng`` /
``Generator`` state (or the counter-based draws on device); the legacy
global RNG breaks run-to-run reproducibility (DESIGN §9).
"""
from __future__ import annotations

import ast

from . import Finding, Rule
from ._shared import dotted

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_RNG_OK = {
    "default_rng",
    "Generator",
    "SeedSequence",
    "PCG64",
    "Philox",
    "MT19937",
    "BitGenerator",
}


def _self_attr_root(node: ast.AST) -> "str | None":
    """For a write target, the ``self.<attr>`` being mutated (through any
    number of trailing subscripts), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _LockedWriteVisitor(ast.NodeVisitor):
    def __init__(self, lock_attrs: "set[str]", modpath: str):
        self.lock_attrs = lock_attrs
        self.modpath = modpath
        self.depth = 0  # nesting inside `with self.<lock>`
        self.findings: "list[Finding]" = []

    def visit_With(self, node: ast.With) -> None:
        locked = any(
            _self_attr_root(item.context_expr) in self.lock_attrs
            for item in node.items
        )
        if locked:
            self.depth += 1
        self.generic_visit(node)
        if locked:
            self.depth -= 1

    def _flag(self, node, attr):
        self.findings.append(
            Finding(
                "RPR301",
                self.modpath,
                node.lineno,
                node.col_offset,
                f"write to shared `self.{attr}` outside `with self.<lock>` in "
                "a lock-owning serve class — cross-thread state must mutate "
                "under the lock or via the documented handoffs (DESIGN §11)",
            )
        )

    def visit_Assign(self, node: ast.Assign) -> None:
        if self.depth == 0:
            for t in node.targets:
                attr = _self_attr_root(t)
                if attr is not None and attr not in self.lock_attrs:
                    self._flag(node, attr)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self.depth == 0:
            attr = _self_attr_root(node.target)
            if attr is not None and attr not in self.lock_attrs:
                self._flag(node, attr)
        self.generic_visit(node)


def _check_serve_writes(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        lock_attrs: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                seg = dotted(node.value.func)
                if seg and seg.rsplit(".", 1)[-1] in _LOCK_CTORS:
                    for t in node.targets:
                        attr = _self_attr_root(t)
                        if attr:
                            lock_attrs.add(attr)
        if not lock_attrs:
            continue
        for meth in ast.iter_child_nodes(cls):
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name == "__init__":
                continue  # no other thread can hold a reference yet
            v = _LockedWriteVisitor(lock_attrs, modpath)
            v.visit(meth)
            out += v.findings
    return out


def _check_np_random(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        base = dotted(node.value)
        if base in ("np.random", "numpy.random") and node.attr not in _RNG_OK:
            out.append(
                Finding(
                    "RPR302",
                    modpath,
                    node.lineno,
                    node.col_offset,
                    f"legacy global-RNG call `{base}.{node.attr}` — all "
                    "randomness must flow through seeded default_rng/Generator "
                    "state for reproducibility (DESIGN §9)",
                )
            )
    return out


RULES = [
    Rule(
        "RPR301",
        "serve-unlocked-write",
        "shared-state write outside the lock in a serve class",
        lambda p: p.startswith("serve/"),
        _check_serve_writes,
    ),
    Rule(
        "RPR302",
        "legacy-np-random",
        "np.random global-RNG usage (unseeded, irreproducible)",
        lambda p: p.endswith(".py"),
        _check_np_random,
    ),
]
