"""Validation-discipline rules (DESIGN.md §12).

RPR201 bare-assert — ``assert`` used to validate *inputs* of a public
function in ``core``/``instances``.  Asserts vanish under ``python -O``,
so malformed instances/solutions would sail through; input validation
must raise (ValueError / InfeasibleInstanceError).  Internal invariant
asserts (on ``self`` attributes or values not derived from parameters)
are exempt.
"""
from __future__ import annotations

import ast

from . import Finding, Rule
from ._shared import param_names, tainted_names


def _applies(modpath: str) -> bool:
    return modpath.startswith(("core/", "instances/"))


def _public_functions(tree: ast.AST):
    """Module-level functions and methods of module-level classes whose
    name does not start with '_' (dunders excluded)."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                yield node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if not sub.name.startswith("_"):
                        yield sub


def _check(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    for fn in _public_functions(tree):
        params = param_names(fn)
        if not params:
            continue
        tainted = tainted_names(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
                continue  # nested fns judged on their own merits
            if not isinstance(node, ast.Assert):
                continue
            reads = {
                n.id
                for n in ast.walk(node.test)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            }
            if reads & tainted:
                name = sorted(reads & params)[0] if reads & params else sorted(reads & tainted)[0]
                out.append(
                    Finding(
                        "RPR201",
                        modpath,
                        node.lineno,
                        node.col_offset,
                        f"bare `assert` validates input-derived value `{name}` "
                        f"in public `{fn.name}` — stripped under python -O; "
                        "raise ValueError/InfeasibleInstanceError instead "
                        "(DESIGN §12 validation discipline)",
                    )
                )
    return out


RULES = [
    Rule(
        "RPR201",
        "bare-assert",
        "assert used for input validation in a public core/instances fn",
        _applies,
        _check,
    ),
]
