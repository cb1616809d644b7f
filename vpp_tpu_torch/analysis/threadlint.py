"""The ``--threads`` pass: lock discipline.

Scope: the modules where the agent's threads, the pump's dispatch and
fetch workers, the device ring's stager and fetcher, the kvstore's
replication threads and the mesh's exchange meet shared state — the
reference's roots (tools/analysis/threadlint.py ``THREAD_ROOTS``) in
the port, and the port's own: its stepping entries hold
``Dataplane._lock`` for the whole step, so the dataplanes
(pipeline/dataplane.py, parallel/cluster.py, parallel/multihost.py),
the program cache (pipeline/capture.py) and the VCL admission server
(hoststack/admission.py) are roots too.

Rules:

* ``unlocked-access`` — per class, an attribute written under ``with
  self.<lock>`` in a method other than ``__init__`` is protected by the
  lock most of its locked writes hold; every other access of it in a
  method must hold that lock. ``__init__`` (nothing runs beside it
  before the object is published) and methods whose name ends in
  ``_locked`` (the caller holds the lock) are exempt.
* ``lock-order`` — per class, ``with self.A:`` nested in ``with
  self.B:`` is the edge B -> A; both orders seen is a deadlock waiting
  for its schedule.

Locks are the attributes ``__init__`` assigns ``threading.Lock()``,
``RLock()`` or ``Condition()``; an alias (``self.commit_lock =
self._lock``) is the lock it names. A nested def or lambda runs later
(a worker handed to a thread): it holds none of the locks of the
``with`` blocks around its definition.

Suppress one line with ``# unlocked: <reason>``: name the caller that
holds the lock, or why the access is safe without it.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from vpp_tpu_torch.analysis.common import (
    REPO,
    Finding,
    SourceCache,
    iter_source_files,
)

THREAD_ROOTS = (
    # the reference's roots
    "vpp_tpu_torch/io/pump.py",
    "vpp_tpu_torch/io/cluster_pump.py",
    "vpp_tpu_torch/io/rings.py",
    "vpp_tpu_torch/io/daemon.py",
    "vpp_tpu_torch/io/governor.py",
    "vpp_tpu_torch/kvstore",
    "vpp_tpu_torch/stats",
    "vpp_tpu_torch/trace",
    "vpp_tpu_torch/pipeline/txn.py",
    "vpp_tpu_torch/pipeline/persistent.py",
    "vpp_tpu_torch/tenancy/sched.py",
    "vpp_tpu_torch/pipeline/snapshot.py",
    "vpp_tpu_torch/testing/faults.py",
    "vpp_tpu_torch/ml/loader.py",
    "vpp_tpu_torch/ops/telemetry.py",
    "vpp_tpu_torch/fleet/steering.py",
    "vpp_tpu_torch/fleet/membership.py",
    "vpp_tpu_torch/io/fleet.py",
    # the port's: the stepping entries hold the dataplane's lock for
    # the whole step, so its state is lock-protected state
    "vpp_tpu_torch/pipeline/dataplane.py",
    "vpp_tpu_torch/parallel/cluster.py",
    "vpp_tpu_torch/parallel/multihost.py",
    "vpp_tpu_torch/pipeline/capture.py",
    "vpp_tpu_torch/hoststack/admission.py",
)

LOCK_CTORS = {"Lock", "RLock", "Condition"}


def _self_attr(expr) -> Optional[str]:
    """'x' for ``self.x``, 'a.b' for ``self.a.b``, else None."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name) and expr.id == "self":
        return ".".join(reversed(parts))
    return None


def _is_lock_ctor(expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        (f.id if isinstance(f, ast.Name) else None)
    return name in LOCK_CTORS


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.locks: Dict[str, str] = {}   # lock attr (or alias) -> lock
        # attr -> {lock: [(method, line)]} of its locked writes
        self.locked_writes: Dict[str, Dict[str, list]] = {}
        # (attr, method, line, is_write, held locks)
        self.accesses: List[Tuple[str, str, int, bool, frozenset]] = []
        # (outer, inner) -> first line seen
        self.edges: Dict[Tuple[str, str], int] = {}


class ThreadPass:
    def __init__(self, repo: Path, roots=THREAD_ROOTS,
                 cache: Optional[SourceCache] = None):
        self.repo, self.roots = repo, roots
        self.cache = cache or SourceCache()
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        for rel, path in iter_source_files(self.repo, self.roots):
            s = self.cache.get(rel, path)
            self.findings.extend(s.sup.problems)
            if s.tree is None:
                continue
            for node in ast.walk(s.tree):
                if isinstance(node, ast.ClassDef):
                    self._check_class(rel, node, s.sup)
        return self.findings

    def _emit(self, rel, line, rule, msg, sup) -> None:
        if line not in sup.unlocked:
            self.findings.append(Finding(rel, line, rule, msg))

    def _check_class(self, rel: str, cls: ast.ClassDef, sup) -> None:
        info = _ClassInfo(cls)
        init = next((m for m in cls.body if isinstance(m, ast.FunctionDef)
                     and m.name == "__init__"), None)
        if init is not None:
            aliases: Dict[str, str] = {}
            for stmt in ast.walk(init):
                if not isinstance(stmt, ast.Assign):
                    continue
                for t in stmt.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if _is_lock_ctor(stmt.value):
                        info.locks[attr] = attr
                    elif _self_attr(stmt.value) is not None:
                        aliases[attr] = _self_attr(stmt.value)
            for dst, src in aliases.items():
                if src in info.locks:
                    info.locks[dst] = info.locks[src]
        if not info.locks:
            return
        for m in cls.body:
            if isinstance(m, ast.FunctionDef):
                self._scan_method(info, m)
        self._report(rel, info, sup)

    def _scan_method(self, info: _ClassInfo, method: ast.FunctionDef):
        exempt = method.name == "__init__" or method.name.endswith("_locked")

        def visit(node, held: tuple):
            if isinstance(node, ast.With):
                new_held = held
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in info.locks:
                        lock = info.locks[attr]
                        for outer in new_held:
                            if outer != lock:
                                info.edges.setdefault(
                                    (outer, lock), item.context_expr.lineno)
                        new_held = new_held + (lock,)
                    else:
                        visit(item.context_expr, held)
                for s in node.body:
                    visit(s, new_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not method:
                # a nested def runs later: no enclosing `with` holds
                for child in ast.iter_child_nodes(node):
                    visit(child, ())
                return
            if isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if attr is None:
                    # `self._buf[0].x`: the inner self.* access counts
                    for child in ast.iter_child_nodes(node):
                        visit(child, held)
                    return
                if attr not in info.locks and not exempt:
                    is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                    info.accesses.append((attr, method.name, node.lineno,
                                          is_write, frozenset(held)))
                    if is_write and held:
                        for lk in held:
                            info.locked_writes.setdefault(
                                attr, {}).setdefault(lk, []).append(
                                (method.name, node.lineno))
                return  # self.a.b was recorded as one access
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(method, ())

    def _report(self, rel: str, info: _ClassInfo, sup) -> None:
        cls = info.node.name
        for attr, by_lock in sorted(info.locked_writes.items()):
            lock = sorted(by_lock, key=lambda lk: (-len(by_lock[lk]), lk))[0]
            for a_attr, meth, line, is_write, held in info.accesses:
                if a_attr != attr or lock in held:
                    continue
                kind = "write" if is_write else "read"
                self._emit(rel, line, "unlocked-access",
                           f"{cls}.{attr} is written under self.{lock} "
                           f"(lock-protected) but {kind} in {meth}() "
                           f"without it", sup)
        for (a, b), line in sorted(info.edges.items()):
            if (b, a) in info.edges and a < b:
                self._emit(rel, line, "lock-order",
                           f"{cls}: self.{a} and self.{b} are taken in "
                           f"both nesting orders (here {a}->{b}, line "
                           f"{info.edges[(b, a)]} {b}->{a}): deadlock by "
                           f"schedule", sup)


def threads_lint(repo=None, roots=THREAD_ROOTS,
                 cache: Optional[SourceCache] = None) -> List[Finding]:
    """Run the pass; returns the unsuppressed findings (empty == clean)."""
    return ThreadPass(Path(repo or REPO), roots, cache).run()
