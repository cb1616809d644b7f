"""The ``--transfers`` pass: device-to-host reads of table state.

The regression class the reference fixed by hand three times: a table's
device tensors read back to the host on a control path ("~270 MB
crosses the transport"). Every value reachable from a
``DataplaneTables`` is tainted — an ``X.tables`` attribute (and the
persistent pump's carry slots), a parameter named ``tables`` or
annotated ``DataplaneTables`` — and a host read of a tainted value is a
finding unless the enclosing function is an approved site
(``transfer_manifest.TRANSFER_SITES``) or the line says why.

Taint flows through names, attributes, subscripts, tuples, arithmetic,
``torch.*`` calls and a tainted tensor's methods; host metadata
(``.shape``, ``.dtype``, ``.device``, ``.numel()``...) and the result of
a host read are untainted. A nested def inherits its scope's taint.

Sinks: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``.to("cpu")``, ``int()`` / ``float()`` / ``bool()``, and
``np.asarray`` / ``np.array`` / ``np.ascontiguousarray``.

Rules:

* ``transfer-host-fetch`` — a host read of a tables-reachable value
  outside an approved site. Suppress one line with ``# transfer-ok:
  <reason>`` (say what bounds the bytes), or approve the function when
  all of it is a sanctioned drain.
* ``transfer-site-stale`` — a ``TRANSFER_SITES`` entry that names no
  scanned file or function.
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

TRANSFER_ROOTS = ("vpp_tpu_torch",)

# attributes that hold a DataplaneTables
TAINT_ATTRS = {"tables", "_tables0", "_tables_pending", "_tables_final"}
# parameter names that carry one
TAINT_PARAMS = {"tables", "tbl", "tables0"}
# host metadata: no device bytes
HOST_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "nbytes",
              "itemsize", "layout"}
HOST_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                "data_ptr", "stride", "is_contiguous", "get_device"}
NP_NAMES = {"np", "numpy", "_np"}
NP_SINKS = {"asarray", "array", "ascontiguousarray"}
SINK_METHODS = {"item", "tolist", "cpu", "numpy"}
DEVICE_MODS = {"torch"}


def _qual(stack: List[str]) -> str:
    return ".".join(stack) if stack else "<module>"


class TransferPass:
    def __init__(self, repo: Path, roots=TRANSFER_ROOTS, manifest=None,
                 cache: Optional[SourceCache] = None):
        if manifest is None:
            from vpp_tpu_torch.analysis import transfer_manifest as manifest
        self.repo, self.roots = repo, roots
        self.sites: Dict[Tuple[str, str], str] = dict(
            manifest.TRANSFER_SITES)
        self.cache = cache or SourceCache()
        self.findings: List[Finding] = []
        self._scopes: Set[Tuple[str, str]] = set()

    def run(self) -> List[Finding]:
        scanned = set()
        for rel, path in iter_source_files(self.repo, self.roots):
            scanned.add(rel)
            s = self.cache.get(rel, path)
            self.findings.extend(s.sup.problems)
            if s.tree is not None:
                self._scan_scope(rel, s.tree.body, [], set(), s.sup)
        for (rel, qual), _reason in sorted(self.sites.items()):
            if rel not in scanned:
                self.findings.append(Finding(
                    rel, 1, "transfer-site-stale",
                    f"TRANSFER_SITES entry ({rel!r}, {qual!r}) names a "
                    f"file outside the scanned tree"))
            elif qual != "*" and (rel, qual) not in self._scopes:
                self.findings.append(Finding(
                    rel, 1, "transfer-site-stale",
                    f"TRANSFER_SITES entry {qual!r} is no function of "
                    f"{rel}: drop or fix it (a dead entry hides the next "
                    f"regression)"))
        return self.findings

    def _allowed(self, rel: str, stack: List[str]) -> bool:
        if (rel, "*") in self.sites:
            return True
        # a nested def is covered by its approved enclosing function
        return any((rel, ".".join(stack[:i])) in self.sites
                   for i in range(len(stack), 0, -1))

    def _scan_scope(self, rel, body, stack, inherited, sup) -> None:
        """One lexical scope: its tainted names, then its sinks; nested
        defs recurse with the taint inherited."""
        self._scopes.add((rel, _qual(stack)))
        tainted: Set[str] = set(inherited)
        nested = []

        def is_tainted(expr) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in tainted
            if isinstance(expr, ast.Attribute):
                if expr.attr in HOST_ATTRS:
                    return False
                if expr.attr in TAINT_ATTRS:
                    return True
                return is_tainted(expr.value)
            if isinstance(expr, (ast.Subscript, ast.Starred)):
                return is_tainted(expr.value)
            if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
                return any(is_tainted(e) for e in expr.elts)
            if isinstance(expr, ast.BinOp):
                return is_tainted(expr.left) or is_tainted(expr.right)
            if isinstance(expr, ast.UnaryOp):
                return is_tainted(expr.operand)
            if isinstance(expr, ast.Compare):
                return is_tainted(expr.left) or \
                    any(is_tainted(c) for c in expr.comparators)
            if isinstance(expr, ast.IfExp):
                return is_tainted(expr.body) or is_tainted(expr.orelse)
            if isinstance(expr, ast.NamedExpr):
                return is_tainted(expr.value)
            if isinstance(expr, ast.Call):
                f = expr.func
                if isinstance(f, ast.Name) and f.id == "getattr" and \
                        expr.args and is_tainted(expr.args[0]):
                    return True
                if isinstance(f, ast.Attribute):
                    root = f.value
                    while isinstance(root, ast.Attribute):
                        root = root.value
                    if isinstance(root, ast.Name) and \
                            root.id in DEVICE_MODS:
                        return any(is_tainted(a) for a in expr.args)
                    if f.attr in SINK_METHODS or f.attr in HOST_METHODS:
                        return False  # the result is on the host
                    if f.attr == "to" and _to_cpu(expr):
                        return False
                    return is_tainted(f.value)
                return False
            return False

        def seed_args(fn) -> Set[str]:
            out = set()
            a = fn.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + [a.vararg, a.kwarg]):
                if arg is None:
                    continue
                ann = arg.annotation
                ann_name = ""
                if isinstance(ann, ast.Name):
                    ann_name = ann.id
                elif isinstance(ann, ast.Attribute):
                    ann_name = ann.attr
                elif isinstance(ann, ast.Constant) and \
                        isinstance(ann.value, str):
                    ann_name = ann.value.split(".")[-1]
                if arg.arg in TAINT_PARAMS or ann_name == "DataplaneTables":
                    out.add(arg.arg)
            return out

        def taint_target(t):
            if isinstance(t, ast.Name):
                tainted.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    taint_target(e)
            elif isinstance(t, ast.Starred):
                taint_target(t.value)

        def collect(stmts):
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(s, ast.Assign):
                    if is_tainted(s.value):
                        for t in s.targets:
                            taint_target(t)
                    elif isinstance(s.value, ast.Tuple) and \
                            len(s.targets) == 1 and \
                            isinstance(s.targets[0], ast.Tuple) and \
                            len(s.targets[0].elts) == len(s.value.elts):
                        for t, v in zip(s.targets[0].elts, s.value.elts):
                            if is_tainted(v):
                                taint_target(t)
                elif isinstance(s, (ast.AnnAssign, ast.AugAssign)):
                    if s.value is not None and is_tainted(s.value):
                        taint_target(s.target)
                elif isinstance(s, ast.For):
                    if is_tainted(s.iter):
                        taint_target(s.target)
                    collect(s.body + s.orelse)
                elif isinstance(s, ast.With):
                    for item in s.items:
                        if item.optional_vars is not None and \
                                is_tainted(item.context_expr):
                            taint_target(item.optional_vars)
                    collect(s.body)
                elif isinstance(s, (ast.If, ast.While)):
                    collect(s.body + s.orelse)
                elif isinstance(s, ast.Try):
                    collect(s.body + s.orelse + s.finalbody)
                    for h in s.handlers:
                        collect(h.body)

        for _ in range(3):
            before = len(tainted)
            collect(body)
            if len(tainted) == before:
                break

        allowed = self._allowed(rel, stack)

        def visit(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested.append(node)
                return
            if isinstance(node, ast.ClassDef):
                return  # its methods are scopes of their own, below
            if isinstance(node, ast.Call):
                self._check_sink(rel, stack, node, is_tainted, allowed, sup)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for s in body:
            visit(s)
        for fn in nested:
            self._scan_scope(rel, fn.body, stack + [fn.name],
                             set(tainted) | seed_args(fn), sup)
        for s in body:
            if isinstance(s, ast.ClassDef):
                for m in s.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._scan_scope(rel, m.body,
                                         stack + [s.name, m.name],
                                         seed_args(m), sup)

    def _check_sink(self, rel, stack, call, is_tainted, allowed, sup):
        f = call.func
        sink = None
        if isinstance(f, ast.Name) and f.id in ("int", "float", "bool"):
            if call.args and is_tainted(call.args[0]):
                sink = f"{f.id}() of a device value"
        elif isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id in NP_NAMES and \
                    f.attr in NP_SINKS:
                if any(is_tainted(a) for a in call.args):
                    sink = f"np.{f.attr}() of a device value"
            elif f.attr in SINK_METHODS and is_tainted(base):
                sink = f".{f.attr}() of a device value"
            elif f.attr == "to" and _to_cpu(call) and is_tainted(base):
                sink = '.to("cpu") of a device value'
        if sink is None or allowed or call.lineno in sup.transfer:
            return
        self.findings.append(Finding(
            rel, call.lineno, "transfer-host-fetch",
            f"{sink} reachable from DataplaneTables in {_qual(stack)}(): a "
            f"device-to-host read outside the approved sites "
            f"(transfer_manifest.TRANSFER_SITES)"))


def _to_cpu(call: ast.Call) -> bool:
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in list(call.args) + [kw.value for kw in call.keywords])


def transfers_lint(repo=None, roots=TRANSFER_ROOTS, manifest=None,
                   cache: Optional[SourceCache] = None) -> List[Finding]:
    """Run the pass; returns the unsuppressed findings (empty == clean)."""
    return TransferPass(Path(repo or REPO), roots, manifest, cache).run()
