"""Lint rules for the captured round's discipline (DESIGN.md §§7–9), the
reference's JAX-discipline rules re-aimed at what replaces JAX's tracing in
the port: a CUDA graph recorded once and replayed.

RPR101 tensor-branch    — Python ``if``/``while``/``assert``/ternary on a
                          tensor-valued expression inside a captured
                          function.  The capture freezes the branch taken
                          on the first round, and deciding it syncs.
RPR102 host-sync        — ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
                          ``float()``/``int()``/``bool()`` or
                          ``np.asarray()``/``np.array()`` of a tensor-valued
                          expression inside a captured function: a
                          device→host read in the round, an error under
                          ``torch.cuda.set_sync_debug_mode("error")``.
RPR103 cumsum-parity    — ``torch.cumsum(...)`` or ``<tensor>.cumsum(...)``
                          in a parity-critical module.  DESIGN §9: a
                          parallel prefix scan is not bit-equal to
                          np.cumsum's sequential sum (5.2e-12 off on the
                          H100); the round takes ``schedule_dp.seq_cumsum``.
RPR104 cache-key-cover  — a compiled-function cache (``.get``/``.put`` on
                          a *cache/launch/fns*-named holder with a local
                          tuple key, or a key built by a key function of the
                          same module that returns a tuple) whose enclosing
                          function has a parameter that neither feeds the
                          key (directly or through local assignments) nor is
                          passed to the cached function at call time: a
                          shape-affecting argument missing from the key
                          silently reuses another shape's launch.
RPR105 static-buffer-rebind — in a class that captures a CUDA graph, a
                          method outside the capture rebinds (``self.x =
                          ...``) an attribute that the captured functions
                          read, in place of filling it (``self.x.copy_(...)``,
                          ``self.x[...] = ...``): the replay reads the
                          buffer the capture saw, never the new one.

"Captured" is :func:`~._shared.captured_functions`; "tensor-valued" is
:class:`~._shared.TensorTaint`.
"""
from __future__ import annotations

import ast
import re

from . import Finding, Rule
from ._shared import (
    TensorTaint,
    capture_regions,
    captured_functions,
    class_of,
    def_index,
    dotted,
    enclosing,
    label,
    param_names,
    resolve_call,
)

PARITY_MODULES = {
    "core/eval_batch.py",
    "core/device_search.py",
    "core/tabu.py",
    "core/memory_update.py",
    "core/solution.py",
    "kernels/schedule_dp.py",
}

_CACHE_HOLDER = re.compile(r"(?i)(cache|launch|lru|fns)")
_HOST_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NUMPY_SYNC = {"asarray", "array"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _src_modules(modpath: str) -> bool:
    return modpath.endswith(".py")


def _captured_scopes(tree: ast.AST):
    """(function whose taint applies, nodes to scan, name for messages):
    each captured function, and each capture region's own statements."""
    for fn in captured_functions(tree):
        yield fn, [fn], fn.name
    for site, region in capture_regions(tree):
        yield site, region, getattr(site, "name", "<module>")


def _check_tensor_branch(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    seen: set[tuple[int, int]] = set()
    for fn, nodes, name in _captured_scopes(tree):
        taint = TensorTaint.of(tree)
        for node in (n for top in nodes for n in ast.walk(top)):
            if not isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                continue
            refs = taint.refs(node.test, fn)
            if refs and (node.lineno, node.col_offset) not in seen:
                seen.add((node.lineno, node.col_offset))
                kind = "ternary" if isinstance(node, ast.IfExp) else type(node).__name__.lower()
                out.append(Finding(
                    "RPR101", modpath, node.lineno, node.col_offset,
                    f"python `{kind}` on tensor `{label(refs[0])}` inside captured "
                    f"function `{name}` — the capture freezes the branch and deciding "
                    "it syncs; use torch.where / a mask (DESIGN §7)"))
    return out


def _check_host_sync(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    seen: set[tuple[int, int]] = set()
    for fn, nodes, name in _captured_scopes(tree):
        taint = TensorTaint.of(tree)
        for node in (n for top in nodes for n in ast.walk(top)):
            if not isinstance(node, ast.Call):
                continue
            hit = None
            f = node.func
            if (isinstance(f, ast.Name) and f.id in _HOST_SYNC_BUILTINS
                    and any(taint.refs(a, fn) for a in node.args)):
                hit = f"{f.id}()"
            elif (isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_METHODS
                    and taint.refs(f.value, fn)):
                hit = f".{f.attr}()"
            elif isinstance(f, ast.Attribute) and f.attr in _NUMPY_SYNC:
                base = dotted(f.value)
                if base in ("np", "numpy", "onp") and any(
                        taint.refs(a, fn) for a in node.args):
                    hit = f"{base}.{f.attr}()"
            if hit and (node.lineno, node.col_offset) not in seen:
                seen.add((node.lineno, node.col_offset))
                out.append(Finding(
                    "RPR102", modpath, node.lineno, node.col_offset,
                    f"{hit} on a tensor inside captured function `{name}` reads the "
                    "device from the host in the round — an error under "
                    "set_sync_debug_mode('error') (DESIGN §8: sync only at the "
                    "documented sync_every boundaries)"))
    return out


def _check_cumsum(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "cumsum"):
            continue
        base = dotted(node.func.value)
        if base in ("np", "numpy", "onp"):
            continue                      # the sequential sum: the parity anchor
        if base != "torch":
            taint = TensorTaint.of(tree)
            site = enclosing(node, taint.parents, (*_FUNCS, ast.Module))
            if not taint.refs(node.func.value, site):
                continue                  # not a tensor: a NumPy array's cumsum
        out.append(Finding(
            "RPR103", modpath, node.func.lineno, node.func.col_offset,
            "torch cumsum in a parity-critical module: a parallel prefix scan is "
            "not bit-equal to np.cumsum's sequential sum — use "
            "schedule_dp.seq_cumsum (DESIGN §9)"))
    return out


def _assign_sources(fn: ast.AST) -> "dict[str, set[str]]":
    """name → names its assignments read (one level; closed over by caller)."""
    src: dict[str, set[str]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            reads = {n.id for n in ast.walk(node.value) if isinstance(n, ast.Name)}
            for tgt in node.targets:
                for t in ast.walk(tgt):
                    if isinstance(t, ast.Name):
                        src.setdefault(t.id, set()).update(reads)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            reads = {n.id for n in ast.walk(node.value) if isinstance(n, ast.Name)}
            src.setdefault(node.target.id, set()).update(reads)
    return src


def _closure(names: "set[str]", src: "dict[str, set[str]]") -> "set[str]":
    out = set(names)
    frontier = list(names)
    while frontier:
        n = frontier.pop()
        for dep in src.get(n, ()):
            if dep not in out:
                out.add(dep)
                frontier.append(dep)
    return out


def _key_reads(value: ast.AST, fn: ast.AST, index) -> "set[str] | None":
    """Names a cache key reads: a tuple literal's; or, for a call of a key
    function of this module whose every return is a tuple literal, the
    names passed for the parameters those tuples read (through the key
    function's own assignments).  None when the key is neither."""
    if isinstance(value, ast.Tuple):
        return {n.id for n in ast.walk(value) if isinstance(n, ast.Name)}
    if not isinstance(value, ast.Call):
        return None
    callees = resolve_call(value, fn, index)
    if len(callees) != 1:
        return None
    key_fn = callees[0]
    rets = [r.value for r in ast.walk(key_fn) if isinstance(r, ast.Return)]
    if not rets or not all(isinstance(r, ast.Tuple) for r in rets):
        return None
    used = _closure({n.id for r in rets for n in ast.walk(r) if isinstance(n, ast.Name)},
                    _assign_sources(key_fn))
    a = key_fn.args
    pos = [p.arg for p in (*a.posonlyargs, *a.args)]
    reads: set[str] = set()
    for p, arg in [*zip(pos, value.args),
                   *((kw.arg, kw.value) for kw in value.keywords if kw.arg)]:
        if p in used:
            reads |= {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
    return reads


def _check_cache_keys(tree: ast.AST, modpath: str) -> "list[Finding]":
    out: list[Finding] = []
    index = None
    for fn in ast.walk(tree):
        if not isinstance(fn, _FUNCS):
            continue
        # find `<holder>.get(K)` / `<holder>.put(K, ...)` on a cache-named holder
        gets: list[ast.Call] = []
        puts: list[ast.Call] = []
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "put")
                and node.args
                and isinstance(node.args[0], ast.Name)
            ):
                holder = dotted(node.func.value)
                if holder and _CACHE_HOLDER.search(holder.rsplit(".", 1)[-1]):
                    (gets if node.func.attr == "get" else puts).append(node)
        if not gets or not puts:
            continue
        get = gets[0]
        key_name = get.args[0].id
        # the key must be a local tuple literal (or a key function's) for
        # the rule to reason about
        key_reads = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == key_name for t in node.targets
            ):
                index = index or def_index(tree)
                got = _key_reads(node.value, fn, index)
                key_reads = key_reads if got is None else got
        if key_reads is None:
            continue
        covered = _closure(key_reads, _assign_sources(fn))
        # names the cached function is *called* with are runtime arguments
        fn_names = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and node.value in gets:
                for t in node.targets:
                    for tn in ast.walk(t):
                        if isinstance(tn, ast.Name):
                            fn_names.add(tn.id)
        runtime: set[str] = set()
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in fn_names
            ):
                for a in (*node.args, *(kw.value for kw in node.keywords)):
                    runtime.update(
                        n.id for n in ast.walk(a) if isinstance(n, ast.Name)
                    )
        holder_root = dotted(gets[0].func.value)
        holder_root = holder_root.split(".", 1)[0] if holder_root else ""
        for p in sorted(param_names(fn) - {holder_root}):
            if p in covered or p in runtime:
                continue
            out.append(
                Finding(
                    "RPR104",
                    modpath,
                    get.lineno,
                    get.col_offset,
                    f"compiled-fn cache key `{key_name}` in `{fn.name}` does "
                    f"not cover parameter `{p}` (neither in the key nor passed "
                    "to the cached function) — a shape/behavior-affecting arg "
                    "missing from the key bakes silently into the compiled "
                    "program (DESIGN §11: the silent-retrace bug class)",
                )
            )
    return out


def _self_attr(node: ast.AST) -> "str | None":
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _check_static_buffer_rebind(tree: ast.AST, modpath: str) -> "list[Finding]":
    regions = capture_regions(tree)
    if not regions:
        return []
    captured = captured_functions(tree)
    parents = def_index(tree)[1]
    out: list[Finding] = []
    for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
        methods = [m for m in cls.body if isinstance(m, _FUNCS)]
        own = {id(m) for m in methods}
        cap_sites = {id(site): region for site, region in regions if id(site) in own}
        if not cap_sites:
            continue
        in_cls = [fn for fn in captured if class_of(fn, parents) is cls]
        read = {n.attr for fn in in_cls for n in ast.walk(fn)
                if _self_attr(n) and isinstance(n.ctx, ast.Load)}
        cap_ids = {id(fn) for fn in in_cls}
        for meth in methods:
            if meth.name == "__init__" or id(meth) in cap_ids:
                continue
            region = cap_sites.get(id(meth))
            after = max((getattr(n, "end_lineno", n.lineno) for n in region), default=0) \
                if region is not None else 0
            for node in ast.walk(meth):
                if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                    for t in targets:
                        attr = _self_attr(t)
                        if attr in read and node.lineno > after:
                            out.append(Finding(
                                "RPR105", modpath, node.lineno, node.col_offset,
                                f"`self.{attr}` is read by the captured round but rebound "
                                f"in `{meth.name}` — a replay reads the buffer the capture "
                                "saw; fill it in place (`self.x.copy_(...)`, `self.x[...] "
                                "= ...`) (DESIGN §9 state threading)"))
    return out


RULES = [
    Rule(
        "RPR101",
        "tensor-branch",
        "python if/while/assert/ternary on a tensor inside a captured fn",
        _src_modules,
        _check_tensor_branch,
    ),
    Rule(
        "RPR102",
        "host-sync",
        ".item()/.cpu()/float()/np.asarray on a tensor inside a captured fn",
        _src_modules,
        _check_host_sync,
    ),
    Rule(
        "RPR103",
        "cumsum-parity",
        "torch cumsum in a parity-critical module (DESIGN §9)",
        lambda p: p in PARITY_MODULES,
        _check_cumsum,
    ),
    Rule(
        "RPR104",
        "cache-key-coverage",
        "compiled-fn cache key missing an enclosing-fn parameter",
        _src_modules,
        _check_cache_keys,
    ),
    Rule(
        "RPR105",
        "static-buffer-rebind",
        "attribute a captured round reads, rebound after the capture",
        _src_modules,
        _check_static_buffer_rebind,
    ),
]
