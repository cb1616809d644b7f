"""The ``--uploads`` pass: every table field ships one way, and every
staged write marks its group.

The incremental-upload contract of ``vpp_tpu_torch/pipeline/tables.py``:
every ``DataplaneTables`` field (``TABLE_FIELDS``) ships through exactly
one ``_UPLOAD_GROUPS`` entry, is carried across swaps by a state ledger
(``SESSION_FIELDS``, ``TELEMETRY_FIELDS``, ``TENANCY_STATE_FIELDS``,
``FIB_STATE_FIELDS``), or is derived on the device from one group
(``DERIVED_GROUPS``: the LPM stack, the MXU operand). A ``TableBuilder``
mutator that writes a staged attribute must mark its group dirty on
every path that does not raise, or the next ``to_device`` ships a stale
plane.

The port declares its field set as module-level tuples and dicts joined
with ``+`` (and ``LPM_FIELDS`` from ops/lpm.py), not as a class body: a
small static evaluator reads them — literals, names, ``+``, slices,
``tuple()`` / ``list()`` of a dict's keys, dict displays and
comprehensions over literals, and ``f(x) for x in range(n)`` where ``f``
returns an f-string of its parameter.

Rules:

* ``upload-field-unplaced`` — a field in no group, no ledger and not
  derived.
* ``upload-field-multi`` — a field with more than one placement.
* ``upload-group-stale`` — a group, ledger or derived entry that names
  no field, or a derived field that follows no group.
* ``upload-manifest-missing`` / ``-stale`` / ``-mismatch`` —
  ``upload_manifest.FIELD_PLACEMENTS`` against what tables.py says.
* ``upload-mark-missing`` — a public ``TableBuilder`` method writes a
  staged attribute (``upload_manifest.STAGED_ATTRS``) and a path that
  does not raise ends without marking its group (``self._mark(g)``,
  ``self._dirty.add / update``, ``self._dirty = set(_UPLOAD_GROUPS)``,
  or a helper that does, to a fixpoint).
* ``upload-dirty-field-foreign`` — a field added to a per-field dirty
  set (``_fib_dirty``, ``_bv_dirty``) that its group does not hold.
* ``upload-extern-write`` — a write to a staged builder attribute from
  outside ``TableBuilder`` (``dp.builder.if_local_table[i] = ...``).
* ``upload-exempt-stale`` — ``EXEMPT_METHODS`` names no method.

Suppress one line with ``# upload-ok: <reason>``.
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

TABLES_REL = "vpp_tpu_torch/pipeline/tables.py"
UPLOAD_ROOTS = ("vpp_tpu_torch",)
LEDGER_NAMES = ("SESSION_FIELDS", "TELEMETRY_FIELDS",
                "TENANCY_STATE_FIELDS", "FIB_STATE_FIELDS")
# per-field dirty sets -> the group whose fields they may name
SUB_DIRTY = {"_fib_dirty": "fib", "_bv_dirty": "glb_bv"}
# calls that mutate a staged dict or list in place
_MUTATING = {"pop", "clear", "update", "append", "extend", "add", "remove",
             "setdefault", "insert"}
_RAISED, _RETURNED = "raised", "returned"


class _Unknown(Exception):
    """The static evaluator cannot read this expression."""


class StaticModules:
    """Module-level constants of package modules, evaluated from the AST
    on demand (module doc)."""

    def __init__(self, repo: Path, cache: SourceCache):
        self.repo, self.cache = repo, cache
        self._env: Dict[str, Dict[str, ast.AST]] = {}
        self._imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._defs: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self._memo: Dict[Tuple[str, str], object] = {}

    def _load(self, rel: str) -> None:
        if rel in self._env:
            return
        tree = self.cache.get(rel, self.repo / rel).tree
        env, imports, defs = {}, {}, {}
        for node in (tree.body if tree is not None else []):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                env[node.targets[0].id] = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Name):
                env[node.target.id] = node.value
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("vpp_tpu_torch"):
                path = node.module.replace(".", "/") + ".py"
                for a in node.names:
                    imports[a.asname or a.name] = (path, a.name)
            elif isinstance(node, ast.FunctionDef):
                defs[node.name] = node
        self._env[rel], self._imports[rel], self._defs[rel] = \
            env, imports, defs

    def value(self, rel: str, name: str):
        """The value of module constant ``name`` of ``rel`` (raises
        ``_Unknown``)."""
        key = (rel, name)
        if key not in self._memo:
            self._load(rel)
            if name in self._env[rel]:
                self._memo[key] = self.eval(rel, self._env[rel][name], {})
            elif name in self._imports[rel]:
                path, target = self._imports[rel][name]
                if not (self.repo / path).is_file():
                    raise _Unknown(name)
                self._memo[key] = self.value(path, target)
            else:
                raise _Unknown(name)
        return self._memo[key]

    def eval(self, rel: str, node, local: dict):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return [self.eval(rel, e, local) for e in node.elts]
        if isinstance(node, ast.Name):
            if node.id in local:
                return local[node.id]
            return self.value(rel, node.id)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            return self.eval(rel, node.left, local) + \
                self.eval(rel, node.right, local)
        if isinstance(node, ast.Dict):
            out = {}
            for k, v in zip(node.keys, node.values):
                if k is None:  # {**other}
                    out.update(self.eval(rel, v, local))
                else:
                    out[self.eval(rel, k, local)] = self._soft(rel, v, local)
            return out
        if isinstance(node, ast.DictComp) and len(node.generators) == 1:
            gen = node.generators[0]
            out = {}
            for x in self._iterate(rel, gen.iter, local):
                inner = dict(local, **self._bind(gen.target, x))
                out[self.eval(rel, node.key, inner)] = self._soft(
                    rel, node.value, inner)
            return out
        if isinstance(node, ast.Subscript):
            base = self.eval(rel, node.value, local)
            if isinstance(node.slice, ast.Slice):
                lo, hi = (None if b is None else self.eval(rel, b, local)
                          for b in (node.slice.lower, node.slice.upper))
                return list(base)[lo:hi]
            return base[self.eval(rel, node.slice, local)]
        if isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                elif isinstance(v, ast.FormattedValue) and \
                        v.format_spec is None and v.conversion == -1:
                    parts.append(str(self.eval(rel, v.value, local)))
                else:
                    raise _Unknown("f-string")
            return "".join(parts)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            fname = node.func.id
            if fname in ("tuple", "list", "set", "frozenset", "sorted") \
                    and len(node.args) == 1:
                return list(self._iterate(rel, node.args[0], local))
            if fname == "range":
                return list(range(*(self.eval(rel, a, local)
                                    for a in node.args)))
            return self._call(rel, fname, [self.eval(rel, a, local)
                                           for a in node.args])
        raise _Unknown(ast.dump(node)[:60])

    def _soft(self, rel, node, local):
        """A dict value: its value where readable, else None (a dict's
        keys are what the field sets use)."""
        try:
            return self.eval(rel, node, local)
        except (_Unknown, LookupError, TypeError, ValueError):
            return None

    def _iterate(self, rel, node, local):
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)) and \
                len(node.generators) == 1:
            gen = node.generators[0]
            return [self.eval(rel, node.elt,
                              dict(local, **self._bind(gen.target, x)))
                    for x in self._iterate(rel, gen.iter, local)]
        v = self.eval(rel, node, local)
        return list(v.keys()) if isinstance(v, dict) else list(v)

    @staticmethod
    def _bind(target, x) -> dict:
        if isinstance(target, ast.Name):
            return {target.id: x}
        raise _Unknown("target")

    def _call(self, rel: str, fname: str, args: list):
        """A module def whose body returns one expression of its
        parameters (``lpm_field``)."""
        self._load(rel)
        d = self._defs[rel].get(fname)
        if d is None and fname in self._imports[rel]:
            path, target = self._imports[rel][fname]
            if (self.repo / path).is_file():
                return self._call_in(path, target, args)
        if d is None:
            raise _Unknown(fname)
        return self._call_in(rel, fname, args)

    def _call_in(self, rel: str, fname: str, args: list):
        self._load(rel)
        d = self._defs[rel].get(fname)
        body = [s for s in (d.body if d else [])
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        if d is None or len(body) != 1 or not isinstance(body[0],
                                                         ast.Return):
            raise _Unknown(fname)
        params = [a.arg for a in d.args.args]
        return self.eval(rel, body[0].value, dict(zip(params, args)))


def _self_attr(expr) -> Optional[str]:
    """'x' for ``self.x...`` (its first hop), else None."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name) and expr.id == "self" and parts:
        return parts[-1]
    return None


def _peel(target):
    """``self.acl[t]["src"][i]`` -> ``self.acl``."""
    while isinstance(target, ast.Subscript):
        target = target.value
    return target


def _str_elts(node) -> Optional[List[str]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            out.append(e.value)
        return out
    return None


class _TablesModel:
    """What tables.py declares."""

    def __init__(self):
        self.fields: Dict[str, int] = {}          # field -> line
        self.fields_line = 1
        self.groups: Dict[str, List[str]] = {}
        self.groups_line = 1
        self.ledgers: Dict[str, List[str]] = {}
        self.derived: Dict[str, str] = {}         # field -> group
        self.derived_line = 1
        self.field_sets: Dict[str, Set[str]] = {}  # readable listings
        self.builder: Optional[ast.ClassDef] = None


def _load_model(tree: ast.Module, rel: str,
                static: StaticModules) -> _TablesModel:
    model = _TablesModel()
    lines = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "TableBuilder":
            model.builder = node
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target = node.target
        if isinstance(target, ast.Name):
            lines[target.id] = node.lineno
    for name, line in lines.items():
        try:
            v = static.value(rel, name)
        except (_Unknown, LookupError, TypeError, ValueError):
            continue  # not a constant the evaluator reads
        if isinstance(v, dict):
            # a dict of field lists names its values' fields, any other
            # dict (a ledger's dtypes) its keys
            vals = list(v.values())
            model.field_sets[name] = (
                {f for x in vals for f in x if isinstance(f, str)}
                if vals and all(isinstance(x, list) for x in vals)
                else {k for k in v if isinstance(k, str)})
        elif isinstance(v, list) and all(isinstance(f, str) for f in v):
            model.field_sets[name] = set(v)
    table_fields = static.value(rel, "TABLE_FIELDS")
    model.fields_line = lines.get("TABLE_FIELDS", 1)
    # each field at the line of its first literal in the module
    first: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value not in first or node.lineno < first[node.value]:
                first[node.value] = node.lineno
    model.fields = {f: first.get(f, model.fields_line) for f in table_fields}
    model.groups = {g: list(v) for g, v in
                    static.value(rel, "_UPLOAD_GROUPS").items()}
    model.groups_line = lines.get("_UPLOAD_GROUPS", 1)
    for name in LEDGER_NAMES:
        if name in lines:
            model.ledgers[name] = list(static.value(rel, name))
    if "DERIVED_GROUPS" in lines:
        model.derived = dict(static.value(rel, "DERIVED_GROUPS"))
        model.derived_line = lines["DERIVED_GROUPS"]
    return model


class _Summary:
    """What calling a TableBuilder method does to the pending groups."""

    def __init__(self):
        self.pending: Dict[str, Tuple[str, int]] = {}
        self.marks: Set[str] = set()

    def key(self):
        return (frozenset(self.pending), frozenset(self.marks))


class _State:
    def __init__(self):
        self.pending: Dict[str, Tuple[str, int]] = {}
        self.marked: Set[str] = set()

    def copy(self) -> "_State":
        st = _State()
        st.pending, st.marked = dict(self.pending), set(self.marked)
        return st


def _merge(states) -> Optional[_State]:
    live = [s for s in states if s is not None]
    if not live:
        return None
    out = live[0].copy()
    for s in live[1:]:
        for g, site in s.pending.items():
            out.pending.setdefault(g, site)
        out.marked &= s.marked
    out.marked -= set(out.pending)
    return out


class UploadPass:
    def __init__(self, repo: Path, tables_rel: str = TABLES_REL,
                 roots=UPLOAD_ROOTS, manifest=None,
                 cache: Optional[SourceCache] = None):
        if manifest is None:
            from vpp_tpu_torch.analysis import upload_manifest as manifest
        self.repo, self.tables_rel, self.roots = repo, tables_rel, roots
        self.placements: Dict[str, str] = dict(manifest.FIELD_PLACEMENTS)
        self.staged: Dict[str, str] = dict(manifest.STAGED_ATTRS)
        self.exempt: Dict[str, str] = dict(manifest.EXEMPT_METHODS)
        self.cache = cache or SourceCache()
        self.findings: List[Finding] = []
        self._sub_dirty: List[Tuple[int, str]] = []

    def run(self) -> List[Finding]:
        s = self.cache.get(self.tables_rel, self.repo / self.tables_rel)
        self.findings.extend(s.sup.problems)
        if s.tree is None:
            return self.findings
        model = _load_model(s.tree, self.tables_rel,
                            StaticModules(self.repo, self.cache))
        self._check_placements(model, s.sup)
        if model.builder is not None:
            self._check_marks(model, s.sup)
        self._check_extern_writes()
        return self.findings

    def _emit(self, rel, line, rule, msg, sup) -> None:
        if line not in sup.upload:
            self.findings.append(Finding(rel, line, rule, msg))

    # --- placements ---
    def _check_placements(self, model: _TablesModel, sup) -> None:
        rel = self.tables_rel
        placed: Dict[str, List[str]] = {}
        for g, fields in model.groups.items():
            for f in fields:
                placed.setdefault(f, []).append(f"group:{g}")
        for ledger, fields in model.ledgers.items():
            for f in fields:
                placed.setdefault(f, []).append(f"ledger:{ledger}")
        for f, g in model.derived.items():
            placed.setdefault(f, []).append(f"derived:{g}")
            if g not in model.groups:
                self._emit(rel, model.derived_line, "upload-group-stale",
                           f"derived field '{f}' follows '{g}', which is "
                           f"no _UPLOAD_GROUPS entry", sup)
        for f, line in model.fields.items():
            got = placed.get(f, [])
            if not got:
                self._emit(rel, line, "upload-field-unplaced",
                           f"DataplaneTables.{f} is in no _UPLOAD_GROUPS "
                           f"entry, no state ledger and not derived: "
                           f"decide how it ships", sup)
            elif len(got) > 1:
                self._emit(rel, line, "upload-field-multi",
                           f"DataplaneTables.{f} has {len(got)} "
                           f"placements ({', '.join(sorted(got))}); "
                           f"exactly one ships it", sup)
        for f, wheres in placed.items():
            if f not in model.fields:
                self._emit(rel, model.groups_line, "upload-group-stale",
                           f"'{f}' ({wheres[0]}) is no DataplaneTables "
                           f"field", sup)
        for f, line in model.fields.items():
            want = placed.get(f, [None])[0]
            have = self.placements.get(f)
            if have is None:
                self._emit(rel, line, "upload-manifest-missing",
                           f"DataplaneTables.{f} has no entry in "
                           f"upload_manifest.FIELD_PLACEMENTS: record the "
                           f"reviewed placement", sup)
            elif want is not None and have != want:
                self._emit(rel, line, "upload-manifest-mismatch",
                           f"the manifest places {f} at '{have}' but "
                           f"tables.py says '{want}'", sup)
        for f in sorted(self.placements):
            if f not in model.fields:
                self._emit(rel, model.fields_line, "upload-manifest-stale",
                           f"FIELD_PLACEMENTS entry '{f}' is no "
                           f"DataplaneTables field: drop it", sup)

    # --- the mark dataflow over TableBuilder ---
    def _check_marks(self, model: _TablesModel, sup) -> None:
        cls = model.builder
        methods = {m.name: m for m in cls.body
                   if isinstance(m, ast.FunctionDef)}
        for name in sorted(self.exempt):
            if name not in methods:
                self._emit(self.tables_rel, cls.lineno,
                           "upload-exempt-stale",
                           f"EXEMPT_METHODS names TableBuilder.{name}(), "
                           f"which does not exist", sup)
        summaries = {n: _Summary() for n in methods}
        todo = {n: m for n, m in methods.items()
                if n != "__init__" and n not in self.exempt}
        for _ in range(8):  # helper summaries to a fixpoint
            changed = False
            for name, m in todo.items():
                new = self._analyze(m, model, summaries)
                if new.key() != summaries[name].key():
                    summaries[name], changed = new, True
            if not changed:
                break
        self._sub_dirty = []
        seen: Set[Tuple[str, str, int]] = set()
        for name, m in sorted(todo.items()):
            summ = self._analyze(m, model, summaries)
            if name.startswith("_"):
                continue  # a helper's pending groups are its callers'
            for g, (attr, line) in sorted(summ.pending.items()):
                if (name, g, line) in seen:
                    continue
                seen.add((name, g, line))
                self._emit(self.tables_rel, line, "upload-mark-missing",
                           f"TableBuilder.{name}() writes staged attr "
                           f"self.{attr} (group '{g}') but a path ends "
                           f"without marking the group dirty: the next "
                           f"to_device() ships a stale plane", sup)
        for line, msg in sorted(set(self._sub_dirty)):
            self._emit(self.tables_rel, line, "upload-dirty-field-foreign",
                       msg, sup)

    def _analyze(self, method, model: _TablesModel, summaries) -> _Summary:
        exits: List[_State] = []
        all_groups = set(model.groups)

        def mark(st: _State, group: str) -> None:
            st.pending.pop(group, None)
            st.marked.add(group)

        def write(st: _State, target, line) -> None:
            if isinstance(target, (ast.Tuple, ast.List)):
                for e in target.elts:
                    write(st, e, line)
                return
            attr = _self_attr(_peel(target))
            if attr in self.staged:
                st.pending.setdefault(self.staged[attr], (attr, line))

        def everything(node) -> bool:
            """``set(_UPLOAD_GROUPS)``"""
            return (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "set" and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "_UPLOAD_GROUPS")

        def call(st: _State, c: ast.Call) -> None:
            f = c.func
            if not isinstance(f, ast.Attribute):
                return
            owner = _self_attr(f.value)
            if _self_attr(f) == "_mark" and owner is None and c.args:
                lits = _str_elts(c.args[0])
                if lits:
                    mark(st, lits[0])
                return
            if owner == "_dirty" and f.attr in ("add", "update"):
                for a in c.args:
                    if everything(a):
                        for g in all_groups:
                            mark(st, g)
                    for g in _str_elts(a) or ():
                        mark(st, g)
                return
            if owner in SUB_DIRTY and f.attr in ("add", "update"):
                group = SUB_DIRTY[owner]
                members = set(model.groups.get(group, ()))
                for a in c.args:
                    lits = _str_elts(a)
                    if lits is None:
                        node = _peel(a)
                        if isinstance(node, ast.Name) and \
                                node.id in model.field_sets:
                            lits = sorted(model.field_sets[node.id])
                        else:
                            continue
                    for fld in lits:
                        if members and fld not in members:
                            self._sub_dirty.append((
                                c.lineno,
                                f"'{fld}' added to self.{owner} but it is "
                                f"not in _UPLOAD_GROUPS['{group}']: the "
                                f"incremental upload never reads it"))
                return
            if owner in self.staged and f.attr in _MUTATING:
                st.pending.setdefault(self.staged[owner], (owner, c.lineno))
                return
            if owner is None and isinstance(f.value, ast.Name) and \
                    f.value.id == "self" and f.attr in summaries:
                summ = summaries[f.attr]
                for g, (attr, _line) in summ.pending.items():
                    st.pending.setdefault(g, (attr, c.lineno))
                for g in summ.marks:
                    mark(st, g)

        def scan(st: _State, expr) -> None:
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    call(st, node)

        def flow(stmts, st):
            for s in stmts:
                if st in (_RAISED, _RETURNED):
                    return st
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                if isinstance(s, ast.Return):
                    if s.value is not None:
                        scan(st, s.value)
                    exits.append(st)
                    return _RETURNED
                if isinstance(s, ast.Raise):
                    return _RAISED
                if isinstance(s, (ast.Assign, ast.AugAssign,
                                  ast.AnnAssign)):
                    if s.value is not None:
                        scan(st, s.value)
                    targets = s.targets if isinstance(s, ast.Assign) \
                        else [s.target]
                    if targets and _self_attr(targets[0]) == "_dirty" and \
                            everything(s.value):
                        for g in all_groups:
                            mark(st, g)
                        continue
                    for t in targets:
                        write(st, t, s.lineno)
                    continue
                if isinstance(s, ast.Delete):
                    for t in s.targets:
                        write(st, t, s.lineno)
                    continue
                if isinstance(s, ast.Expr):
                    scan(st, s.value)
                    continue
                if isinstance(s, ast.If):
                    scan(st, s.test)
                    a, b = flow(s.body, st.copy()), flow(s.orelse, st.copy())
                    nxt = _merge([x if isinstance(x, _State) else None
                                  for x in (a, b)])
                    if nxt is None:
                        return _RETURNED if _RETURNED in (a, b) else _RAISED
                    st = nxt
                    continue
                if isinstance(s, (ast.For, ast.While)):
                    scan(st, s.iter if isinstance(s, ast.For) else s.test)
                    body = flow(s.body + s.orelse, st.copy())
                    st = _merge([st, body if isinstance(body, _State)
                                 else None]) or st
                    continue
                if isinstance(s, ast.With):
                    for item in s.items:
                        scan(st, item.context_expr)
                    r = flow(s.body, st)
                    if r in (_RAISED, _RETURNED):
                        return r
                    st = r
                    continue
                if isinstance(s, ast.Try):
                    body = flow(s.body, st.copy())
                    body_st = body if isinstance(body, _State) else None
                    # a handler runs after any prefix of the body
                    entry = _merge([st, body_st]) or st
                    outs = [body_st]
                    for h in s.handlers:
                        r = flow(h.body, entry.copy())
                        outs.append(r if isinstance(r, _State) else None)
                    nxt = _merge(outs)
                    if nxt is None:
                        return body if body in (_RAISED, _RETURNED) \
                            else _RAISED
                    r = flow(s.finalbody, nxt)
                    if r in (_RAISED, _RETURNED):
                        return r
                    st = r
                    continue
                for node in ast.walk(s):
                    if isinstance(node, ast.Call):
                        call(st, node)
            return st

        end = flow(method.body, _State())
        if isinstance(end, _State):
            exits.append(end)
        summ = _Summary()
        if exits:
            summ.marks = set.intersection(*(e.marked for e in exits))
            for e in exits:
                for g, site in e.pending.items():
                    summ.pending.setdefault(g, site)
            summ.marks -= set(summ.pending)
        return summ

    # --- writers outside TableBuilder ---
    def _check_extern_writes(self) -> None:
        for rel, path in iter_source_files(self.repo, self.roots):
            if rel == self.tables_rel:
                continue
            s = self.cache.get(rel, path)
            self.findings.extend(s.sup.problems)
            if s.tree is None:
                continue
            for node in ast.walk(s.tree):
                targets = []
                if isinstance(node, (ast.Assign, ast.Delete)):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    base = _peel(t)
                    if isinstance(base, ast.Attribute) and \
                            base.attr in self.staged and \
                            isinstance(base.value, ast.Attribute) and \
                            base.value.attr == "builder":
                        self._emit(
                            rel, base.lineno, "upload-extern-write",
                            f"write to builder.{base.attr} (staged, group "
                            f"'{self.staged[base.attr]}') from outside "
                            f"TableBuilder skips the dirty mark: go "
                            f"through a mutator", s.sup)


def uploads_lint(repo=None, tables_rel: str = TABLES_REL,
                 roots=UPLOAD_ROOTS, manifest=None,
                 cache: Optional[SourceCache] = None) -> List[Finding]:
    """Run the pass; returns the unsuppressed findings (empty == clean)."""
    return UploadPass(Path(repo or REPO), tables_rel, roots, manifest,
                      cache).run()
