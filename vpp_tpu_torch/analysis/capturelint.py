"""The ``--capture`` pass: what a CUDA graph capture cannot hold.

On the CPU a ``capture.Part`` runs its function eagerly at every call;
on the card it captures the function once into a CUDA graph and replays
the graph from then on. So a host read inside that function passes
every CPU test and fails only on the card: during the capture (a sync
is illegal under capture), or worse, silently, since a replay repeats
what the capture saw and never runs the Python again. This pass finds
that class statically.

Captured code is the closure, by name, of the functions handed to the
capture sites (``capture_manifest.CAPTURE_SITES``: a ``Part``'s
function, resolved through one factory hop) and of
``capture_manifest.CAPTURED_ROOTS`` (what the AST cannot resolve: the
step functions a ``make_pipeline_step`` step hands out, the classifier
and FIB rungs, the cluster step's methods). A name resolves to a def of
its scope, of its module, of a ``from vpp_tpu_torch... import``, to
``module.f`` of an imported package module, or ``self.m`` to a method
of the enclosing class.

Rules:

* ``capture-unregistered`` — a ``Part(...)``, ``torch.cuda.graph(...)``
  or ``torch.cuda.CUDAGraph(...)`` call not in ``CAPTURE_SITES``.
* ``capture-manifest-stale`` — a ``CAPTURE_SITES`` entry with no such
  call, or a ``CAPTURED_ROOTS`` entry that names no def.
* ``host-sync`` — in captured code: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``int()`` / ``float()`` /
  ``bool()`` of a tensor, ``np.asarray`` / ``np.array`` of a tensor,
  ``torch.nonzero`` / ``.nonzero()``, ``torch.unique``,
  ``torch.masked_select``, indexing with a boolean mask, and
  ``torch.cuda.synchronize``.
* ``tensor-branch`` — in captured code: an ``if``, ``while``,
  ``assert``, conditional expression or ``and`` / ``or`` operand whose
  truth is a tensor's. A test on ``x is None``, a shape, a dtype, a
  device or a parameter annotated or defaulted to a Python scalar is
  static and is not a finding.
* ``float-literal-dtype`` — in captured code: a float literal given to
  ``torch.tensor`` / ``full`` / ``arange`` without ``dtype=``, and any
  ``float64`` / ``double``. The port's uint32 semantics live in int32
  and int64 (pipeline/vector.py).
* ``lru-cache-method`` — ``lru_cache`` on a method: the cache keys on
  ``self``, keeps the instance alive and behaves per instance.
* ``unhashable-arg`` — a list, dict or set literal handed to an
  ``lru_cache``'d function: a TypeError at the call.

The reference's ``per-instance-jit`` has no counterpart: a program is
per dataplane by design, since the addresses of its tables are baked
into its graphs.

Suppress one line with ``# capture-ok: <reason>``.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from vpp_tpu_torch.analysis.common import (
    REPO,
    Finding,
    SourceCache,
    iter_source_files,
)

CAPTURE_ROOTS = ("vpp_tpu_torch/ops", "vpp_tpu_torch/pipeline",
                 "vpp_tpu_torch/parallel", "vpp_tpu_torch/tenancy")

PACKAGE = "vpp_tpu_torch"
# host metadata of a tensor: never a device value
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "is_sparse", "requires_grad", "itemsize", "nbytes"}
HOST_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                "is_contiguous", "data_ptr", "stride", "get_device",
                "is_floating_point", "storage_offset"}
# torch functions whose result lives on the host
TORCH_STATIC = {"device", "iinfo", "finfo", "is_tensor", "Size",
                "get_default_dtype", "is_floating_point"}
STATIC_TYPES = {"str", "int", "bool", "float", "bytes", "device", "dtype"}
CONTAINER_TYPES = {"Optional", "Tuple", "tuple", "List", "list", "Dict",
                   "dict", "Sequence", "FrozenSet", "frozenset"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "unique",
                "masked_select"}
SYNC_TORCH = {"nonzero", "unique", "masked_select"}
NP_SYNC_FUNCS = {"asarray", "array", "ascontiguousarray"}
FLOAT_CTORS = {"tensor", "full", "arange"}
LRU_NAMES = {"lru_cache", "cache"}
MASK_FUNCS = {"isin", "isnan", "isfinite", "logical_and", "logical_or",
              "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
              "ge", "any", "all"}


def _base_name(expr) -> Optional[str]:
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _dotted(expr) -> str:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return ".".join(reversed(parts))


def _site_kind(call: ast.Call) -> Optional[str]:
    """What a call builds: ``Part``, ``torch.cuda.graph`` or
    ``torch.cuda.CUDAGraph`` (None: not a capture site)."""
    name = _dotted(call.func)
    if name in ("Part", "capture.Part"):
        return "Part"
    if name in ("torch.cuda.graph", "torch.cuda.CUDAGraph"):
        return name
    return None


def _is_lru(dec) -> bool:
    if isinstance(dec, ast.Call):
        dec = dec.func
    return ((isinstance(dec, ast.Name) and dec.id in LRU_NAMES)
            or (isinstance(dec, ast.Attribute) and dec.attr in LRU_NAMES))


def _annotation_static(ann) -> bool:
    """Whether an annotation names only Python scalars (``int``,
    ``Optional[str]``...)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)}
    names.discard("torch")  # torch.device, torch.dtype
    return bool(names & STATIC_TYPES) and names <= (STATIC_TYPES
                                                    | CONTAINER_TYPES)


def _annotation_container(ann) -> bool:
    """Whether an annotation's outer type (under ``Optional``) is a
    Python container: its truth and length are static."""
    while isinstance(ann, ast.Subscript):
        if _dotted(ann.value) != "Optional":
            ann = ann.value
            break
        ann = ann.slice
    return _dotted(ann) in ("list", "List", "tuple", "Tuple", "Sequence",
                            "dict", "Dict")


class ModuleIndex:
    """One module's defs by qualname, each scope's child defs (several
    defs may share a name), each def's class, and its package imports."""

    def __init__(self, repo: Path, relpath: str, tree: ast.Module, sup):
        self.relpath, self.tree, self.sup = relpath, tree, sup
        self.defs: Dict[str, ast.AST] = {}
        self.qual: Dict[int, str] = {}
        self.cls: Dict[int, str] = {}       # id(def) -> its class name
        self.parent: Dict[int, ast.AST] = {}  # id(def) -> enclosing def
        # id(scope def) (0: the module) -> {name: [defs]}
        self.children: Dict[int, Dict[str, List[ast.AST]]] = {0: {}}
        self.obj_imports: Dict[str, Tuple[str, str]] = {}
        self.mod_imports: Dict[str, str] = {}
        self._index(tree, "", 0, None, None)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split(".")[0] == PACKAGE:
                base = node.module.replace(".", "/")
                for a in node.names:
                    if a.name == "*":
                        continue
                    if (repo / base / (a.name + ".py")).is_file():
                        self.mod_imports[a.asname or a.name] = \
                            f"{base}/{a.name}.py"
                    elif (repo / (base + ".py")).is_file():
                        self.obj_imports[a.asname or a.name] = \
                            (base + ".py", a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    path = a.name.replace(".", "/") + ".py"
                    if a.name.split(".")[0] == PACKAGE and a.asname and \
                            (repo / path).is_file():
                        self.mod_imports[a.asname] = path

    def _index(self, node, prefix: str, scope_key: int, cls, enclosing):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self.defs.setdefault(qual, child)
                self.qual[id(child)] = qual
                if cls is not None:
                    self.cls[id(child)] = cls
                if enclosing is not None:
                    self.parent[id(child)] = enclosing
                self.children.setdefault(scope_key, {}).setdefault(
                    child.name, []).append(child)
                self.children.setdefault(id(child), {})
                self._index(child, f"{qual}.", id(child), None, child)
            elif isinstance(child, ast.ClassDef):
                # a method is no name of the enclosing scope: it resolves
                # through ``self.m`` only
                self._index(child, f"{prefix}{child.name}.", id(child),
                            f"{prefix}{child.name}", enclosing)
            else:
                self._index(child, prefix, scope_key, cls, enclosing)

    def chain(self, node) -> List[ast.AST]:
        """The defs enclosing ``node`` (a def), innermost first."""
        out = []
        p = self.parent.get(id(node))
        while p is not None:
            out.append(p)
            p = self.parent.get(id(p))
        return out

    def method_class(self, node) -> Optional[str]:
        """The class of the method ``node`` is, or lies inside."""
        for d in [node] + self.chain(node):
            if id(d) in self.cls:
                return self.cls[id(d)]
        return None


class _Region:
    def __init__(self, mod: ModuleIndex, node, qual: str):
        self.mod, self.node, self.qual = mod, node, qual


class CapturePass:
    def __init__(self, repo: Path, roots=CAPTURE_ROOTS, sites=None,
                 captured_roots=None, cache: Optional[SourceCache] = None):
        if sites is None or captured_roots is None:
            from vpp_tpu_torch.analysis import capture_manifest as m

            sites = m.CAPTURE_SITES if sites is None else sites
            captured_roots = (m.CAPTURED_ROOTS if captured_roots is None
                              else captured_roots)
        self.repo, self.roots = repo, roots
        self.sites = dict(sites)
        self.captured_roots = set(captured_roots)
        self.cache = cache or SourceCache()
        self.findings: List[Finding] = []
        self.modules: Dict[str, ModuleIndex] = {}
        self._emitted: Set[Tuple[str, int, str]] = set()

    def run(self) -> List[Finding]:
        for rel, path in iter_source_files(self.repo, self.roots):
            s = self.cache.get(rel, path)
            self.findings.extend(s.sup.problems)
            if s.tree is not None:
                self.modules[rel] = ModuleIndex(self.repo, rel, s.tree,
                                                s.sup)
        seen, regions = set(), []
        for mod in self.modules.values():
            regions.extend(self._collect_sites(mod, seen))
        for rel, qual in sorted(self.captured_roots):
            mod = self.modules.get(rel)
            node = mod.defs.get(qual) if mod else None
            if node is None:
                self._emit(rel, 1, "capture-manifest-stale",
                           f"captured root {qual!r} is no def of {rel}",
                           mod)
                continue
            regions.append(_Region(mod, node, qual))
        for key, reason in sorted(self.sites.items()):
            if key not in seen:
                self._emit(key[0], 1, "capture-manifest-stale",
                           f"capture site {key[1]!r} / {key[2]!r} matches "
                           f"no call ({reason})", self.modules.get(key[0]))
        self._close_and_check(regions)
        self._module_rules()
        return self.findings

    def _emit(self, rel: str, line: int, rule: str, msg: str,
              mod: Optional[ModuleIndex]) -> None:
        if mod is not None and line in mod.sup.capture:
            return
        if (rel, line, rule) in self._emitted:
            return
        self._emitted.add((rel, line, rule))
        self.findings.append(Finding(rel, line, rule, msg))

    # --- name resolution ---
    def _resolve(self, mod: ModuleIndex, chain, name: str):
        """``name`` seen inside the defs ``chain`` (innermost first):
        a list of (module, def)."""
        for scope in chain:
            hit = mod.children.get(id(scope), {}).get(name)
            if hit:
                return [(mod, d) for d in hit]
        hit = mod.children[0].get(name)
        if hit:
            return [(mod, d) for d in hit]
        target = mod.obj_imports.get(name)
        if target is not None:
            tmod = self.modules.get(target[0])
            if tmod is not None:
                return [(tmod, d)
                        for d in tmod.children[0].get(target[1], [])]
        return []

    def _resolve_attr(self, mod: ModuleIndex, node, attr: ast.Attribute):
        """``module.f`` of an imported package module, ``self.m`` of the
        enclosing class."""
        if not isinstance(attr.value, ast.Name):
            return []
        base = attr.value.id
        if base == "self":
            cls = mod.method_class(node)
            hit = mod.defs.get(f"{cls}.{attr.attr}") if cls else None
            return [(mod, hit)] if hit is not None else []
        target = mod.mod_imports.get(base)
        if target is not None and target in self.modules:
            tmod = self.modules[target]
            return [(tmod, d) for d in tmod.children[0].get(attr.attr, [])]
        return []

    # --- the capture sites ---
    def _collect_sites(self, mod: ModuleIndex, seen) -> List[_Region]:
        regions: List[_Region] = []

        def scan(parent, fstack):
            for child in ast.iter_child_nodes(parent):
                nstack = fstack
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nstack = fstack + [child]
                if isinstance(child, ast.Call):
                    kind = _site_kind(child)
                    if kind is not None:
                        self._one_site(mod, child, kind, fstack, seen,
                                       regions)
                scan(child, nstack)

        scan(mod.tree, [])
        return regions

    def _one_site(self, mod, call, kind, fstack, seen, regions) -> None:
        scope = mod.qual[id(fstack[-1])] if fstack else "<module>"
        fn = None
        if kind == "Part":
            fn = call.args[2] if len(call.args) > 2 else next(
                (kw.value for kw in call.keywords if kw.arg == "fn"), None)
            what = ast.unparse(fn) if fn is not None else "?"
        else:
            what = kind
        key = (mod.relpath, scope, what)
        seen.add(key)
        if key not in self.sites:
            self._emit(mod.relpath, call.lineno, "capture-unregistered",
                       f"{kind} of {what!r} in {scope!r} is no entry of "
                       f"capture_manifest.CAPTURE_SITES", mod)
        if fn is not None:
            regions.extend(self._fn_regions(mod, fn, list(reversed(fstack))))

    def _fn_regions(self, mod, fn, chain) -> List[_Region]:
        """The defs a site's function expression names: a def, a lambda,
        a factory call's def, or — where it is a parameter of the
        enclosing def — what every call of that def in its own scope
        passes there."""
        if isinstance(fn, ast.Lambda):
            return [_Region(mod, fn, "<lambda>")]
        if isinstance(fn, ast.Call) and isinstance(fn.func, ast.Name):
            fn = fn.func
        if not isinstance(fn, ast.Name):
            return []
        hits = self._resolve(mod, chain, fn.id)
        if hits:
            return [_Region(m, d, m.qual[id(d)]) for m, d in hits]
        if not chain:
            return []
        inner = chain[0]
        params = [a.arg for a in inner.args.posonlyargs + inner.args.args]
        if fn.id not in params:
            return []
        pos = params.index(fn.id)
        out: List[_Region] = []
        outer = chain[1] if len(chain) > 1 else mod.tree
        for node in ast.walk(outer):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == inner.name:
                arg = node.args[pos] if len(node.args) > pos else next(
                    (kw.value for kw in node.keywords if kw.arg == fn.id),
                    None)
                if arg is not None:
                    out.extend(self._fn_regions(mod, arg, chain[1:]))
        return out

    # --- the closure and its rules ---
    def _close_and_check(self, regions: List[_Region]) -> None:
        captured: Dict[int, _Region] = {}
        work = list(regions)
        while work:
            r = work.pop()
            if id(r.node) in captured:
                continue
            captured[id(r.node)] = r
            chain = ([r.node] if not isinstance(r.node, ast.Lambda) else []) \
                + self._chain_of(r)
            for node in ast.walk(r.node):
                hits = []
                if isinstance(node, ast.Name):
                    hits = self._resolve(r.mod, chain, node.id)
                elif isinstance(node, ast.Attribute):
                    hits = self._resolve_attr(r.mod, r.node, node)
                for m, d in hits:
                    if id(d) not in captured:
                        work.append(_Region(m, d, m.qual[id(d)]))
        for r in captured.values():
            # a region inside another is checked with it, once
            if any(id(s) in captured for s in self._chain_of(r)):
                continue
            _TaintChecker(self, r).run()

    def _chain_of(self, r: _Region) -> List[ast.AST]:
        if isinstance(r.node, ast.Lambda):
            enclosing = [n for n in ast.walk(r.mod.tree)
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                         and r.node in ast.walk(n)]
            innermost = min(enclosing, key=lambda n: len(list(ast.walk(n))),
                            default=None)
            return ([innermost] + r.mod.chain(innermost)
                    if innermost is not None else [])
        return r.mod.chain(r.node)

    def _module_rules(self) -> None:
        for mod in self.modules.values():
            lru = {}
            for qual, d in mod.defs.items():
                if not any(_is_lru(dec) for dec in d.decorator_list):
                    continue
                lru[d.name] = qual
                args = d.args.posonlyargs + d.args.args
                if args and args[0].arg in ("self", "cls"):
                    self._emit(mod.relpath, d.lineno, "lru-cache-method",
                               f"lru_cache on method {qual!r}: the cache "
                               f"keys on the instance (keeps it alive, "
                               f"behaves per instance); memoize at module "
                               f"scope", mod)
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name) and \
                        node.func.id in lru and \
                        any(isinstance(a, (ast.List, ast.Dict, ast.Set))
                            for a in node.args):
                    self._emit(mod.relpath, node.lineno, "unhashable-arg",
                               f"unhashable literal handed to lru_cache'd "
                               f"{lru[node.func.id]!r}", mod)


class _TaintChecker:
    """A forward walk over one captured region: parameters and torch
    results are tensors unless shown static; host syncs and branches on
    them are findings. A Python container of tensors (a list display or
    comprehension, a parameter annotated ``list`` / ``tuple`` /
    ``Sequence``, a slice of one) carries tensors, but its truth and
    length are static; after ``if torch.is_tensor(x): ... return`` the
    rest of the function sees ``x`` as a host value."""

    def __init__(self, owner: CapturePass, region: _Region):
        self.owner, self.r = owner, region
        self.tainted: Set[str] = set()
        self.masks: Set[str] = set()
        self.containers: Set[str] = set()
        for node in ast.walk(region.node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                self._seed(node.args)

    def _seed(self, a: ast.arguments) -> None:
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
        pairs = list(zip(pos, defaults)) + list(zip(a.kwonlyargs,
                                                    a.kw_defaults))
        for arg, default in pairs:
            if arg.arg in ("self", "cls") or _annotation_static(
                    arg.annotation):
                continue
            if isinstance(default, ast.Constant) and default.value is not None:
                continue  # a Python scalar gate
            if isinstance(default, (ast.Name, ast.Attribute)):
                continue  # a function or a module constant
            self.tainted.add(arg.arg)
            if _annotation_container(arg.annotation):
                self.containers.add(arg.arg)
        for arg in (a.vararg, a.kwarg):
            if arg is not None:
                self.tainted.add(arg.arg)
                self.containers.add(arg.arg)

    def _emit(self, line: int, rule: str, msg: str) -> None:
        self.owner._emit(self.r.mod.relpath, line, rule, msg, self.r.mod)

    # --- what is a tensor ---
    def _returns_static(self, f) -> bool:
        """A call of a package def annotated to return a Python scalar."""
        mod = self.r.mod
        if isinstance(f, ast.Name):
            hits = self.owner._resolve(mod, self._scopes(), f.id)
        elif isinstance(f, ast.Attribute):
            hits = self.owner._resolve_attr(mod, self.r.node, f)
        else:
            return False
        return bool(hits) and all(_annotation_static(d.returns)
                                  for _m, d in hits)

    def _scopes(self):
        node = self.r.node
        own = [] if isinstance(node, ast.Lambda) else [node]
        return own + self.owner._chain_of(self.r)

    def _iter_taint(self, target, it) -> List[Tuple[str, bool]]:
        """(name, tainted) of each name a ``for`` over ``it`` binds:
        element-wise through ``zip``, ``enumerate`` and ``.items()``."""
        if isinstance(target, ast.Tuple) and isinstance(it, ast.Call):
            f = it.func
            parts = None
            if isinstance(f, ast.Name) and f.id == "zip" and \
                    len(it.args) == len(target.elts):
                parts = [self.is_tainted(a) for a in it.args]
            elif isinstance(f, ast.Name) and f.id == "enumerate" and \
                    it.args and len(target.elts) == 2:
                parts = [False, self.is_tainted(it.args[0])]
            elif isinstance(f, ast.Attribute) and f.attr == "items" and \
                    len(target.elts) == 2:
                parts = [False, self.is_tainted(f.value)]
            if parts is not None:
                out = []
                for t, tainted in zip(target.elts, parts):
                    out += [(n.id, tainted) for n in ast.walk(t)
                            if isinstance(n, ast.Name)]
                return out
        tainted = self.is_tainted(it)
        return [(n.id, tainted) for n in ast.walk(target)
                if isinstance(n, ast.Name)]

    def _comprehension(self, expr) -> bool:
        """A comprehension's elements' taint, its targets bound by their
        iterables."""
        saved = set(self.tainted)
        try:
            for gen in expr.generators:
                for name, tainted in self._iter_taint(gen.target, gen.iter):
                    if tainted:
                        self.tainted.add(name)
                    else:
                        self.tainted.discard(name)
            if isinstance(expr, ast.DictComp):
                return self.is_tainted(expr.value)
            return self.is_tainted(expr.elt)
        finally:
            self.tainted = saved

    def is_container(self, expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.containers
        if isinstance(expr, (ast.List, ast.ListComp, ast.Tuple, ast.Dict,
                             ast.DictComp, ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Subscript) and \
                isinstance(expr.slice, ast.Slice):
            return self.is_container(expr.value)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            return self.is_container(expr.left) or \
                self.is_container(expr.right)
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            return expr.func.id in ("list", "tuple", "dict", "sorted")
        return False

    def truth_tainted(self, expr) -> bool:
        """Whether Python takes a tensor's truth on ``expr``."""
        if self.is_container(expr):
            return False
        if isinstance(expr, ast.BoolOp):
            return any(self.truth_tainted(v) for v in expr.values)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            return self.truth_tainted(expr.operand)
        return self.is_tainted(expr)

    def is_tainted(self, expr) -> bool:
        if expr is None or isinstance(expr, ast.Constant):
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return False
            return self.is_tainted(expr.value)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return False  # `x is None`: static whatever x is
            return self.is_tainted(expr.left) or any(
                self.is_tainted(c) for c in expr.comparators)
        if isinstance(expr, (ast.Lambda, ast.JoinedStr)):
            return False
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self._comprehension(expr)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in (
                    "len", "int", "float", "bool", "isinstance", "range",
                    "hasattr", "str", "callable", "type", "id"):
                return False
            if isinstance(f, ast.Attribute):
                if f.attr in HOST_METHODS or f.attr in ("item", "tolist"):
                    return False
                base = _base_name(f)
                if base == "torch":
                    return f.attr not in TORCH_STATIC and not \
                        _dotted(f).startswith("torch.cuda.")
            if self._returns_static(f):
                return False
            return any(self.is_tainted(a) for a in expr.args) or any(
                self.is_tainted(kw.value) for kw in expr.keywords) or \
                self.is_tainted(f)
        return any(self.is_tainted(c) for c in ast.iter_child_nodes(expr))

    def is_mask(self, expr) -> bool:
        """A boolean tensor: a comparison, a logical op or a name bound
        to one."""
        if isinstance(expr, ast.Name):
            return expr.id in self.masks
        if not self.is_tainted(expr):
            return False
        if isinstance(expr, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in expr.ops)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
            return self.is_mask(expr.operand)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(expr.left) or self.is_mask(expr.right)
        if isinstance(expr, ast.Call) and isinstance(expr.func,
                                                     ast.Attribute):
            f = expr.func
            if f.attr == "bool" or (f.attr in MASK_FUNCS
                                    and _base_name(f) == "torch"):
                return True
            if f.attr == "to" and any(_dotted(a) == "torch.bool"
                                      for a in expr.args):
                return True
        return False

    # --- the walk ---
    def run(self) -> None:
        node = self.r.node
        if isinstance(node, ast.Lambda):
            self._check_expr(node.body)
        else:
            self._block(node.body)

    def _block(self, stmts) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _bind(self, targets, value) -> None:
        if value is None:
            return
        tainted, mask = self.is_tainted(value), self.is_mask(value)
        container = self.is_container(value)
        for t in targets:
            if isinstance(t, (ast.Subscript, ast.Attribute)):
                continue  # a store into an object binds no name
            whole = isinstance(t, ast.Name)
            for n in ast.walk(t):
                if not isinstance(n, ast.Name):
                    continue
                (self.tainted.add if tainted else self.tainted.discard)(
                    n.id)
                (self.masks.add if mask and whole else self.masks.discard)(
                    n.id)
                (self.containers.add if container and whole
                 else self.containers.discard)(n.id)

    @staticmethod
    def _tensor_test(test) -> Tuple[Optional[str], bool]:
        """(name, positive) of ``torch.is_tensor(name)`` / ``isinstance(
        name, torch.Tensor)``, possibly under ``not``."""
        positive = True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, positive = test.operand, False
        if isinstance(test, ast.Call) and test.args and \
                isinstance(test.args[0], ast.Name):
            name = _dotted(test.func)
            if name == "torch.is_tensor" or (
                    name == "isinstance" and len(test.args) == 2
                    and _dotted(test.args[1]) == "torch.Tensor"):
                return test.args[0].id, positive
        return None, True

    @staticmethod
    def _ends(stmts) -> bool:
        return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))

    def _stmt(self, stmt) -> None:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            if stmt.value is not None:
                self._check_expr(stmt.value)
            for t in targets:
                if isinstance(t, ast.Subscript):
                    self._check_expr(t)
            if isinstance(stmt, ast.AugAssign):
                if self.is_tainted(stmt.value):
                    self._bind(targets, stmt.value)
                return
            self._bind(targets, stmt.value)
            return
        if isinstance(stmt, ast.If):
            self._check_expr(stmt.test)
            name, positive = self._tensor_test(stmt.test)
            if name is not None:
                # the branch where ``name`` is no tensor sees a host value
                host, tensor = ((stmt.orelse, stmt.body) if positive
                                else (stmt.body, stmt.orelse))
                was = name in self.tainted
                self._block(tensor)
                self.tainted.discard(name)
                self._block(host)
                if was and not self._ends(tensor):
                    self.tainted.add(name)
                return
            if self.truth_tainted(stmt.test):
                self._emit(stmt.lineno, "tensor-branch",
                           "Python `if` on a tensor's truth in captured "
                           "code: a host sync under capture, and a replay "
                           "never re-takes the branch — use torch.where")
            self._block(stmt.body + stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            self._check_expr(stmt.test)
            if self.truth_tainted(stmt.test):
                self._emit(stmt.lineno, "tensor-branch",
                           "Python `while` on a tensor's truth in captured "
                           "code: a host sync per iteration under capture")
            self._block(stmt.body + stmt.orelse)
            return
        if isinstance(stmt, ast.Assert):
            self._check_expr(stmt.test)
            if self.truth_tainted(stmt.test):
                self._emit(stmt.lineno, "tensor-branch",
                           "assert on a tensor's truth in captured code: "
                           "a host sync under capture")
            return
        if isinstance(stmt, ast.For):
            self._check_expr(stmt.iter)
            for name, tainted in self._iter_taint(stmt.target, stmt.iter):
                (self.tainted.add if tainted else self.tainted.discard)(name)
            self._block(stmt.body + stmt.orelse)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._block(stmt.body)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._check_expr(child)
            elif isinstance(child, (ast.stmt, ast.excepthandler)):
                self._stmt(child)
            elif isinstance(child, ast.withitem):
                self._check_expr(child.context_expr)

    def _check_expr(self, expr) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp) and \
                    self.truth_tainted(node.test):
                self._emit(node.lineno, "tensor-branch",
                           "conditional expression on a tensor's truth in "
                           "captured code")
            elif isinstance(node, ast.BoolOp) and any(
                    self.truth_tainted(v) for v in node.values[:-1]):
                self._emit(node.lineno, "tensor-branch",
                           "`and` / `or` on a tensor's truth in captured "
                           "code")
            elif isinstance(node, ast.Subscript) and \
                    self.is_mask(node.slice):
                self._emit(node.lineno, "host-sync",
                           "indexing with a boolean mask in captured code: "
                           "a data-dependent shape (a nonzero and a host "
                           "read)")
            elif isinstance(node, ast.Attribute) and \
                    node.attr in ("float64", "double"):
                self._emit(node.lineno, "float-literal-dtype",
                           f"{node.attr} in captured code: the port's "
                           f"step math is int32 / int64 / float32")
            elif isinstance(node, ast.Call):
                self._check_call(node)

    def _check_call(self, node: ast.Call) -> None:
        f = node.func
        name = _dotted(f)
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS and \
                _base_name(f) not in ("torch", "np", "numpy"):
            if f.attr in ("item", "tolist", "cpu", "numpy") or \
                    self.is_tainted(f.value):
                self._emit(node.lineno, "host-sync",
                           f".{f.attr}() in captured code: a device to "
                           f"host read (illegal under capture)")
            return
        if isinstance(f, ast.Attribute) and f.attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in list(node.args)
                + [kw.value for kw in node.keywords]):
            self._emit(node.lineno, "host-sync",
                       '.to("cpu") in captured code: a device to host '
                       'copy')
            return
        if name in ("torch.cuda.synchronize",) or (
                _base_name(f) == "torch" and isinstance(f, ast.Attribute)
                and f.attr in SYNC_TORCH):
            self._emit(node.lineno, "host-sync",
                       f"{name}() in captured code: a host sync (or a "
                       f"data-dependent shape)")
            return
        if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") \
                and any(self.is_tainted(a) for a in node.args):
            self._emit(node.lineno, "host-sync",
                       f"{f.id}() of a tensor in captured code: a host "
                       f"read")
            return
        if isinstance(f, ast.Attribute) and _base_name(f) in ("np",
                                                              "numpy") \
                and f.attr in NP_SYNC_FUNCS and \
                any(self.is_tainted(a) for a in node.args):
            self._emit(node.lineno, "host-sync",
                       f"np.{f.attr}() of a tensor in captured code: a "
                       f"device to host copy")
            return
        if isinstance(f, ast.Attribute) and _base_name(f) == "torch" and \
                f.attr in FLOAT_CTORS:
            has_float = any(isinstance(n, ast.Constant)
                            and isinstance(n.value, float)
                            for a in node.args for n in ast.walk(a))
            if has_float and not any(kw.arg == "dtype"
                                     for kw in node.keywords):
                self._emit(node.lineno, "float-literal-dtype",
                           f"float literal into torch.{f.attr} with no "
                           f"dtype")


def capture_lint(repo=None, roots=CAPTURE_ROOTS, sites=None,
                 captured_roots=None,
                 cache: Optional[SourceCache] = None) -> List[Finding]:
    """Run the pass; returns the unsuppressed findings (empty == clean)."""
    return CapturePass(Path(repo or REPO), roots, sites, captured_roots,
                       cache).run()
