"""Fault-tolerance discipline rules (DESIGN.md §13).

RPR303 swallowed-typed-error — in ``serve/`` or ``faults/``, a broad
handler (``except Exception``/``except BaseException``/bare ``except``)
whose body neither re-raises nor routes the exception through the
:mod:`repro_torch.faults.errors` taxonomy (``wrap_error`` or a named
``ReproError`` subclass), and which is not preceded by a typed taxonomy
handler on the same ``try``.  DESIGN §13: every failure crossing the
serve boundary must surface as a typed, per-request-attributable
``ReproError`` — a broad handler that swallows silently loses the
request.

RPR304 unregistered-injection-point — a fault-injection helper call
(``fire``/``corrupt``/``nan_value``/``skewed``) whose string-literal
point is not declared via ``register_point(...)`` in
``repro_torch/faults/inject.py``.  DESIGN §13: the registry is the audit
surface for chaos coverage; an unregistered point raises at runtime only
when a plan is active, so the lint catches the typo before the chaos
bench does.
"""
from __future__ import annotations

import ast
import functools

from . import Finding, Rule
from ._shared import dotted, last_segment

#: taxonomy names whose presence in a handler body marks it as routing
#: the failure through DESIGN §13 typed errors
_TAXONOMY = {
    "ReproError",
    "CompileTimeout",
    "LaunchFailure",
    "DeviceLost",
    "CertifyFailure",
    "InfeasibleRequest",
    "QueueOverload",
    "EngineCrashed",
    "SanitizeError",
    "wrap_error",
}
_BROAD = {"Exception", "BaseException"}
_INJECT_HELPERS = {"fire", "corrupt", "nan_value", "skewed"}


# ------------------------------------------------------------------ #
# RPR303                                                             #
# ------------------------------------------------------------------ #
def _handler_type_names(htype: "ast.AST | None") -> "set[str]":
    """Last segments of the exception classes a handler catches."""
    if htype is None:
        return set()
    nodes = htype.elts if isinstance(htype, ast.Tuple) else [htype]
    return {s for s in (last_segment(n) for n in nodes) if s}


def _routes_through_taxonomy(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Name) and node.id in _TAXONOMY:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _TAXONOMY:
            return True
    return False


def _check_swallow(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            continue
        typed_before = False
        for h in node.handlers:
            names = _handler_type_names(h.type)
            if names & (_TAXONOMY - {"wrap_error"}):
                # a preceding taxonomy handler already peeled off the
                # typed errors — the broad tail is a legitimate backstop
                typed_before = True
                continue
            broad = h.type is None or bool(names & _BROAD)
            if not broad or typed_before:
                continue
            if _routes_through_taxonomy(h):
                continue
            caught = ", ".join(sorted(names)) or "<bare>"
            out.append(
                Finding(
                    "RPR303",
                    modpath,
                    h.lineno,
                    h.col_offset,
                    f"broad `except {caught}` swallows typed ReproErrors — "
                    "re-raise, route through wrap_error / a taxonomy class, "
                    "or peel typed errors off in a preceding handler "
                    "(DESIGN §13)",
                )
            )
    return out


# ------------------------------------------------------------------ #
# RPR304                                                             #
# ------------------------------------------------------------------ #
@functools.lru_cache(maxsize=1)
def _registered_points() -> "frozenset[str] | None":
    """Point literals passed to ``register_point`` in ``faults/inject.py``
    of this checkout; ``None`` when the module cannot be read (linting a
    detached tree) — the rule then stays silent rather than guessing."""
    from ..lint import repo_root

    path = repo_root() / "src" / "repro_torch" / "faults" / "inject.py"
    try:
        tree = ast.parse(path.read_text())
    except OSError:
        return None
    points: set[str] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and last_segment(node.func) == "register_point"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            points.add(node.args[0].value)
    return frozenset(points)


def _inject_names(tree: ast.AST) -> "tuple[set[str], set[str]]":
    """(module aliases bound to faults.inject, helper names imported from
    it) — scoping the call scan so an unrelated ``obj.fire(...)`` never
    fires the rule."""
    mods: set[str] = set()
    fns: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] == "inject" and "faults" in a.name:
                    mods.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                if a.name == "inject" and (
                    mod.endswith("faults") or (node.level and not mod)
                ):
                    mods.add(a.asname or a.name)
                elif mod.endswith("inject") and a.name in _INJECT_HELPERS:
                    fns.add(a.asname or a.name)
    return mods, fns


def _check_injection_points(tree: ast.AST, modpath: str) -> "list[Finding]":
    registry = _registered_points()
    if registry is None:
        return []
    mods, fns = _inject_names(tree)
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _INJECT_HELPERS:
            base = dotted(f.value)
            if base is None or base.rsplit(".", 1)[-1] not in mods:
                continue
        elif isinstance(f, ast.Name) and f.id in fns:
            pass
        else:
            continue
        if not (
            node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            continue  # dynamic point: the runtime registry check owns it
        point = node.args[0].value
        if point not in registry:
            out.append(
                Finding(
                    "RPR304",
                    modpath,
                    node.lineno,
                    node.col_offset,
                    f"injection point '{point}' is not declared via "
                    "register_point() in faults/inject.py — an unregistered "
                    "point only errors once a plan activates, so register "
                    "it up front (DESIGN §13)",
                )
            )
    return out


def _applies_303(modpath: str) -> bool:
    return modpath.startswith(("serve/", "faults/"))


def _applies_304(modpath: str) -> bool:
    if modpath == "faults/inject.py":
        return False  # the registry itself
    return modpath.startswith(("serve/", "faults/")) or (
        modpath == "core/device_search.py"
    )


RULES = [
    Rule(
        "RPR303",
        "swallowed-typed-error",
        "broad except in serve/faults that bypasses the error taxonomy",
        _applies_303,
        _check_swallow,
    ),
    Rule(
        "RPR304",
        "unregistered-injection-point",
        "fault-injection helper called with an unregistered point literal",
        _applies_304,
        _check_injection_points,
    ),
]
