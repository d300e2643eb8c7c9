"""Shared AST machinery for the lint rules.

Two analyses live here:

* the reference's forward taint over function parameters
  (:func:`tainted_names` with its defaults): every parameter is a seed and
  any local assigned from a seed is tainted too — the validation rule
  (RPR201) reads it as "derived from an input";
* the port's **tensor taint** (:class:`TensorTaint`), the same closure
  with other seeds: a name is tensor-valued when it is assigned from a
  ``torch.*`` call, from a buffer attribute of the enclosing class, from a
  call of a module function or method that returns a tensor, or from a
  parameter that some call site in the module hands a tensor.  Static
  metadata (``x.shape`` / ``x.dtype`` / ``x.size()`` / ``len(x)`` /
  ``isinstance(...)``) and host values (``int(x)``, ``x.item()``) do *not*
  propagate: a branch on them is decided on the host, once.

:func:`captured_functions` finds the code a CUDA graph records: every
function called inside a capture region, closed over the calls it makes.
"""
from __future__ import annotations

import ast

#: attribute reads on a traced value that are static python values
STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "aval", "weak_type"}

#: builtins whose result on a traced value is static (or which never leak)
STATIC_CALLS = {"len", "isinstance", "type", "getattr", "hasattr", "range"}

#: a tensor's metadata: host values fixed when the tensor was made
TENSOR_STATIC_ATTRS = STATIC_ATTRS | {
    "device", "is_cuda", "layout", "requires_grad", "dim", "numel", "stride",
    "element_size", "nbytes", "itemsize", "data_ptr", "is_contiguous"}

#: calls whose result is a host value, never a tensor (the conversions sync,
#: and RPR102 reports that; what they return is a Python number or array)
TENSOR_HOST_CALLS = STATIC_CALLS | {
    "int", "float", "bool", "complex", "str", "repr", "item", "tolist", "cpu", "numpy"}

#: ``torch.<x>`` namespaces and functions whose result is no tensor
TORCH_HOST = {
    "cuda", "device", "dtype", "Size", "finfo", "iinfo", "is_tensor",
    "is_floating_point", "is_complex", "numel", "get_default_dtype",
    "no_grad", "inference_mode", "enable_grad", "set_grad_enabled",
    "Generator", "backends", "distributed", "profiler", "autograd", "library",
    "get_num_threads", "set_num_threads", "manual_seed", "compile", "jit"}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def dotted(node: "ast.AST") -> "str | None":
    """``torch.cuda.graph`` → the dotted string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_segment(node: "ast.AST") -> "str | None":
    d = dotted(node)
    return d.rsplit(".", 1)[-1] if d else None


def function_defs(tree: "ast.AST") -> "dict[str, list[ast.AST]]":
    funcs: dict[str, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, _FUNCS):
            funcs.setdefault(node.name, []).append(node)
    return funcs


def param_names(fn: "ast.AST") -> "set[str]":
    a = fn.args
    names = {arg.arg for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    names -= {"self", "cls"}
    return names


def tracer_refs(expr: "ast.AST", tainted: "set[str]", *, source=None,
                static_attrs: "set[str]" = STATIC_ATTRS,
                static_calls: "set[str]" = STATIC_CALLS) -> "list[ast.AST]":
    """Nodes in ``expr`` that read a tainted value: name loads of
    ``tainted``, and any node ``source(node)`` calls a value of its own
    (the tensor taint's roots), excluding static-metadata accesses and the
    calls of ``static_calls``."""
    refs: list[ast.AST] = []

    def visit(node):
        if isinstance(node, ast.Attribute) and node.attr in static_attrs:
            return
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ) and all(
            isinstance(c, ast.Constant) and c.value is None for c in node.comparators
        ):
            # `x is None` is a static structure check, not a value read
            return
        if isinstance(node, ast.Call) and last_segment(node.func) in static_calls:
            return
        if source is not None and source(node):
            refs.append(node)
            return
        if isinstance(node, ast.Call):
            visit(node.func)
            for child in (*node.args, *node.keywords):
                visit(child.value if isinstance(child, ast.keyword) else child)
            return
        if isinstance(node, ast.Name):
            if node.id in tainted and isinstance(node.ctx, ast.Load):
                refs.append(node)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return refs


def label(node: "ast.AST") -> str:
    """A short source form of a reference (for messages)."""
    text = node.id if isinstance(node, ast.Name) else ast.unparse(node)
    return text if len(text) <= 40 else text[:37] + "..."


def _target_names(tgt: "ast.AST"):
    # only names actually being bound — `self.x = v` binds the attribute,
    # not `self` (whose Name node is a Load inside the target)
    for n in ast.walk(tgt):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            yield n.id


def _container_names(tgt: "ast.AST"):
    # `x[k] = v` fills the container `x` (a local) with `v`
    for n in ast.walk(tgt):
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name):
            yield n.value.id


def tainted_names(fn: "ast.AST", seeds: "set[str] | None" = None, *,
                  refs=tracer_refs, params: bool = True, nodes=None) -> "set[str]":
    """Forward taint closure through the whole function, nested defs
    included: ``seeds`` and everything assigned from them.  With
    ``params`` (the reference's reading) every parameter of ``fn`` and of
    its nested defs is a seed; without it (the tensor taint) only
    ``seeds`` are, ``refs`` also names the taint's other roots, and a
    subscript store (``x[k] = v``) taints the container.  ``nodes`` is
    ``list(ast.walk(fn))`` where the caller keeps it."""
    nodes = list(ast.walk(fn)) if nodes is None else nodes
    tainted = set(seeds or ())
    if params:
        tainted |= param_names(fn)
        for sub in nodes:
            if isinstance(sub, _FUNCS) and sub is not fn:
                tainted |= param_names(sub)
    for _ in range(4):  # fixpoint for straight-line reassignment chains
        before = len(tainted)
        for node in nodes:
            if isinstance(node, ast.Assign) and refs(node.value, tainted):
                for tgt in node.targets:
                    tainted.update(_target_names(tgt))
                    if not params:
                        tainted.update(_container_names(tgt))
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if refs(node.value, tainted):
                    tainted.update(_target_names(node.target))
            elif isinstance(node, ast.AugAssign):
                if refs(node.value, tainted):
                    tainted.update(_target_names(node.target))
            elif isinstance(node, ast.For):
                if refs(node.iter, tainted):
                    tainted.update(_target_names(node.target))
            elif isinstance(node, _COMPS):
                for gen in node.generators:
                    if refs(gen.iter, tainted):
                        tainted.update(_target_names(gen.target))
        if len(tainted) == before:
            break
    return tainted


# ------------------------------------------------------------------ #
# scopes, capture regions                                            #
# ------------------------------------------------------------------ #
def _kept(tree: "ast.AST", key: str, make):
    """``make(tree)``, made once and kept on the tree: the rules that read
    it lint the same tree."""
    got = getattr(tree, key, None)
    if got is None:
        got = make(tree)
        setattr(tree, key, got)
    return got


def parent_map(tree: "ast.AST") -> "dict[int, ast.AST]":
    return _kept(tree, "_parents", lambda t: {
        id(c): p for p in ast.walk(t) for c in ast.iter_child_nodes(p)})


def enclosing(node: "ast.AST", parents: dict, kinds) -> "ast.AST | None":
    p = parents.get(id(node))
    while p is not None and not isinstance(p, kinds):
        p = parents.get(id(p))
    return p


def class_of(fn: "ast.AST", parents: dict) -> "ast.ClassDef | None":
    """The class whose ``self`` ``fn`` sees: the class of the method that
    is ``fn`` or that ``fn`` is nested in."""
    node = fn
    while node is not None and not isinstance(node, ast.Module):
        p = parents.get(id(node))
        if isinstance(p, ast.ClassDef) and isinstance(node, _FUNCS):
            return p
        node = p
    return None


def _scope(node: "ast.AST", parents: dict) -> "ast.AST":
    """The function (or module) a def's name is bound in; a method's name
    is bound in its class, where no bare call sees it."""
    return enclosing(node, parents, (*_FUNCS, ast.ClassDef, ast.Module))


def resolve_call(call: ast.Call, site: "ast.AST", index) -> "list[ast.AST]":
    """The defs of this module a call reaches: ``f(...)`` the ``f`` visible
    from ``site`` (the function the call is in: its nested defs, its
    enclosing functions', the module's), ``self.m(...)`` the method ``m``
    of ``site``'s class."""
    defs_by_name, parents, methods = index
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and f.value.id == "self":
        cls = class_of(site, parents) if site is not None else None
        return list(methods.get((id(cls), f.attr), ())) if cls is not None else []
    if not isinstance(f, ast.Name):
        return []
    cands = defs_by_name.get(f.id, ())
    scope = site
    while scope is not None:
        hit = [d for d in cands if _scope(d, parents) is scope]
        if hit:
            return hit
        if isinstance(scope, ast.Module):
            break
        scope = enclosing(scope, parents, (*_FUNCS, ast.Module))
    return []


def def_index(tree: "ast.AST"):
    """(defs by name, the parent map, methods by (class id, name))."""
    return _kept(tree, "_def_index", _def_index)


def _def_index(tree: "ast.AST"):
    parents = parent_map(tree)
    methods: dict[tuple[int, str], list[ast.AST]] = {}
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            for m in cls.body:
                if isinstance(m, _FUNCS):
                    methods.setdefault((id(cls), m.name), []).append(m)
    return function_defs(tree), parents, methods


def _calls_method(node: "ast.AST", name: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == name for n in ast.walk(node))


def _is_graph_context(expr: "ast.AST") -> bool:
    return isinstance(expr, ast.Call) and (dotted(expr.func) or "").endswith("cuda.graph")


def capture_regions(tree: "ast.AST") -> "list[tuple[ast.AST, list[ast.AST]]]":
    """Every CUDA-graph capture region as (the function it is written in,
    or the module; the nodes recorded): the body of ``with
    torch.cuda.graph(...)``, and the statements between
    ``<graph>.capture_begin(...)`` and the statement that calls
    ``<graph>.capture_end()`` (that one included, but for the call)."""
    return list(_kept(tree, "_regions", _capture_regions))


def _capture_regions(tree: "ast.AST") -> "list[tuple[ast.AST, list[ast.AST]]]":
    if not any(isinstance(n, ast.Call) and (
            (isinstance(n.func, ast.Attribute) and n.func.attr == "capture_begin")
            or _is_graph_context(n)) for n in ast.walk(tree)):
        return []
    parents = parent_map(tree)
    out: list[tuple[ast.AST, list[ast.AST]]] = []
    for node in ast.walk(tree):
        site = None
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_context(it.context_expr) for it in node.items):
            site = enclosing(node, parents, (*_FUNCS, ast.Module))
            out.append((site, list(node.body)))
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, st in enumerate(stmts):
                if not (isinstance(st, ast.Expr) and _calls_method(st, "capture_begin")):
                    continue
                region = []
                for nxt in stmts[i + 1:]:
                    if _calls_method(nxt, "capture_end"):
                        region += [n for n in ast.iter_child_nodes(nxt)
                                   if not _calls_method(n, "capture_end")] \
                            if not isinstance(nxt, ast.Expr) else []
                        break
                    region.append(nxt)
                out.append((enclosing(st, parents, (*_FUNCS, ast.Module)), region))
    return out


def captured_functions(tree: "ast.AST") -> "list[ast.AST]":
    """Every function a CUDA graph capture of this module records: called
    by name or as ``self.<method>`` inside a capture region, then closed
    over the calls those functions make to this module's functions and
    their class's methods; defs nested in a captured function are captured
    with it.  A captured function's Python runs once, at capture: what it
    decides on the host is frozen into the graph."""
    return list(_kept(tree, "_captured", _captured_functions))


def _captured_functions(tree: "ast.AST") -> "list[ast.AST]":
    regions = capture_regions(tree)
    if not regions:
        return []
    index = def_index(tree)
    captured: list[ast.AST] = []
    seen: set[int] = set()
    frontier: list[ast.AST] = []

    def add(fn):
        if id(fn) not in seen:
            seen.add(id(fn))
            captured.append(fn)
            frontier.append(fn)

    def calls_in(nodes, site):
        for top in nodes:
            for n in ast.walk(top):
                if isinstance(n, ast.Call):
                    for d in resolve_call(n, site, index):
                        add(d)

    for site, region in regions:
        calls_in(region, site)
    while frontier:
        fn = frontier.pop()
        for sub in ast.walk(fn):
            if isinstance(sub, _FUNCS) and sub is not fn:
                add(sub)
        calls_in([fn], fn)
    return captured


# ------------------------------------------------------------------ #
# tensor taint                                                       #
# ------------------------------------------------------------------ #
class TensorTaint:
    """Which names of each function of one module hold tensors.

    Roots: a ``torch.<fn>(...)`` call (but for :data:`TORCH_HOST`); a
    parameter annotated ``Tensor``; a read of a *buffer attribute* of the
    function's class (``self.x`` where some method stores a tensor in it,
    fills it by subscript or ``append``, or binds it to a display of
    tensors); a call of a function or method of this module that returns
    a tensor; a parameter that a call site in this module hands a tensor
    (positionally, by keyword or into ``*args``).  Then the forward closure
    of :func:`tainted_names`, to a fixpoint over the module."""

    @classmethod
    def of(cls, tree: "ast.AST") -> "TensorTaint":
        """The analysis of ``tree``, made once and kept on it."""
        return _kept(tree, "_tensor_taint", cls)

    def __init__(self, tree: "ast.AST"):
        self.index = def_index(tree)
        _, self.parents, _ = self.index
        self.fns = [n for n in ast.walk(tree) if isinstance(n, _FUNCS)]
        self.classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]
        self.buffers: dict[int, set[str]] = {id(c): set() for c in self.classes}
        self.returns: set[int] = set()
        self.seeds: dict[int, set[str]] = {id(f): self._annotated(f) for f in self.fns}
        self.tainted: dict[int, set[str]] = {}
        self._nodes = {id(f): list(ast.walk(f)) for f in self.fns}
        for _ in range(8):
            state = (sum(map(len, self.buffers.values())), len(self.returns),
                     sum(map(len, self.seeds.values())))
            for fn in self.fns:
                self.tainted[id(fn)] = tainted_names(
                    fn, self.seeds[id(fn)], refs=self._refs_in(fn), params=False,
                    nodes=self._nodes[id(fn)])
            for fn in self.fns:
                self._propagate(fn)
            if state == (sum(map(len, self.buffers.values())), len(self.returns),
                         sum(map(len, self.seeds.values()))):
                break

    @staticmethod
    def _annotated(fn) -> "set[str]":
        a = fn.args
        return {arg.arg for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs)
                if arg.annotation is not None
                and "Tensor" in (ast.unparse(arg.annotation) or "")}

    def _refs_in(self, fn):
        cls = class_of(fn, self.parents)
        bufs = self.buffers[id(cls)] if cls is not None else set()

        def source(node):
            if isinstance(node, ast.Call):
                d = dotted(node.func) or ""
                if d.startswith("torch.") and d.split(".")[1] not in TORCH_HOST:
                    return True
                return any(id(c) in self.returns for c in resolve_call(node, fn, self.index))
            return (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                    and node.value.id == "self" and node.attr in bufs)

        def refs(expr, tainted):
            return tracer_refs(expr, tainted, source=source,
                               static_attrs=TENSOR_STATIC_ATTRS,
                               static_calls=TENSOR_HOST_CALLS)

        return refs

    def refs(self, expr: "ast.AST", fn) -> "list[ast.AST]":
        """The tensor-valued reads of ``expr``, in function ``fn`` (or at
        module level)."""
        return self._refs_in(fn)(expr, self.tainted.get(id(fn), set()))

    def _propagate(self, fn) -> None:
        refs = self._refs_in(fn)
        tainted = self.tainted[id(fn)]
        cls = class_of(fn, self.parents)
        for node in self._nodes[id(fn)]:
            if isinstance(node, ast.Return) and node.value is not None \
                    and enclosing(node, self.parents, _FUNCS) is fn \
                    and refs(node.value, tainted):
                self.returns.add(id(fn))
            elif isinstance(node, ast.Call):
                self._seed_callees(node, fn, refs, tainted)
            if cls is not None:
                self._note_buffers(node, cls, refs, tainted)

    def _seed_callees(self, call, fn, refs, tainted) -> None:
        for callee in resolve_call(call, fn, self.index):
            a = callee.args
            pos = [p.arg for p in (*a.posonlyargs, *a.args)]
            if isinstance(call.func, ast.Attribute) and pos and pos[0] == "self":
                pos = pos[1:]
            seeds = self.seeds[id(callee)]
            for i, arg in enumerate(call.args):
                if isinstance(arg, ast.Starred) or not refs(arg, tainted):
                    continue
                if i < len(pos):
                    seeds.add(pos[i])
                elif a.vararg:
                    seeds.add(a.vararg.arg)
            for kw in call.keywords:
                if kw.arg is not None and refs(kw.value, tainted):
                    seeds.add(kw.arg)

    def _note_buffers(self, node, cls, refs, tainted) -> None:
        bufs = self.buffers[id(cls)]

        def self_attr(t):
            return (t.attr if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self" else None)

        if isinstance(node, ast.Assign):
            for t in node.targets:
                if self_attr(t) and refs(node.value, tainted):
                    bufs.add(self_attr(t))
                elif isinstance(t, ast.Subscript):
                    root = t
                    while isinstance(root, ast.Subscript):
                        root = root.value
                    if self_attr(root) and refs(node.value, tainted):
                        bufs.add(self_attr(root))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("append", "extend", "insert", "update", "add") \
                and self_attr(node.func.value) \
                and any(refs(x, tainted) for x in node.args):
            bufs.add(self_attr(node.func.value))
