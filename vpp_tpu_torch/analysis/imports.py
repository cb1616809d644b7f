"""The style pass: the file parses, no unused import, no bare
``except:``, no tab indentation or trailing whitespace, no mutable
default argument, no ``== True / False / None``.

A name counts as used when it appears as a Name anywhere, inside a
string annotation included (``def f(x: "KVStore")``), or when
``__all__`` exports it (a list or tuple, ``__all__ += [...]`` or an
annotated ``__all__: tuple = (...)``). ``import a.b as c`` binds ``c``.
An import with ``# noqa`` on its line, or bound to a leading-underscore
name, is exempt.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from vpp_tpu_torch.analysis.common import (
    REPO,
    SourceCache,
    iter_source_files,
)

STYLE_ROOTS = ("vpp_tpu_torch", "tests/test_torch_*.py", "chip_smoke.py")


class ImportCollector(ast.NodeVisitor):
    def __init__(self):
        self.imports: dict = {}   # bound name -> line
        self.used: set = set()
        self.exported: set = set()

    def visit_Import(self, node):
        for a in node.names:
            # `import a.b` binds `a`; `import a.b as c` binds `c`
            name = a.asname if a.asname else a.name.split(".")[0]
            self.imports[name] = node.lineno

    def visit_ImportFrom(self, node):
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name != "*":
                self.imports[a.asname or a.name] = node.lineno

    def visit_Name(self, node):
        self.used.add(node.id)

    def _collect_annotation(self, ann) -> None:
        """The names of an annotation, those inside string annotations
        included."""
        if ann is None:
            return
        for sub in ast.walk(ann):
            if isinstance(sub, ast.Name):
                self.used.add(sub.id)
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                try:
                    parsed = ast.parse(sub.value, mode="eval")
                except SyntaxError:
                    continue
                self.used.update(n.id for n in ast.walk(parsed)
                                 if isinstance(n, ast.Name))

    def visit_arg(self, node):
        self._collect_annotation(node.annotation)
        self.generic_visit(node)

    def _visit_function(self, node):
        self._collect_annotation(node.returns)
        self.generic_visit(node)

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _record_exports(self, value) -> None:
        try:
            names = ast.literal_eval(value)
        except (ValueError, SyntaxError, TypeError):
            return
        if isinstance(names, (list, tuple, set)):
            self.exported |= {n for n in names if isinstance(n, str)}

    def visit_Assign(self, node):
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == "__all__":
                self._record_exports(node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name) and node.target.id == "__all__":
            self._record_exports(node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if (isinstance(node.target, ast.Name) and node.target.id == "__all__"
                and node.value is not None):
            self._record_exports(node.value)
        self._collect_annotation(node.annotation)
        self.generic_visit(node)


def style_problems(path: Path, src: Optional[str] = None,
                   tree: Optional[ast.Module] = None) -> List[str]:
    """The style checks of one file, as ``path:line: problem`` strings."""
    if src is None:
        src = path.read_text()
    if tree is None:
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError as e:
            return [f"{path}:{e.lineno}: syntax error: {e.msg}"]

    problems = []
    lines = src.splitlines()
    noqa = {i + 1 for i, ln in enumerate(lines) if "# noqa" in ln}
    for i, ln in enumerate(lines, 1):
        if ln.rstrip() != ln and ln.strip():
            problems.append(f"{path}:{i}: trailing whitespace")
        if ln.startswith("\t"):
            problems.append(f"{path}:{i}: tab indentation")

    col = ImportCollector()
    col.visit(tree)
    for name, lineno in col.imports.items():
        if (name in col.used or name in col.exported or lineno in noqa
                or name.startswith("_")):
            continue
        problems.append(f"{path}:{lineno}: unused import '{name}'")

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if node.lineno not in noqa:
                problems.append(f"{path}:{node.lineno}: bare 'except:'")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.args.defaults + node.args.kw_defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        f"{path}:{node.lineno}: mutable default argument "
                        f"in '{node.name}'")
        if isinstance(node, ast.Compare) and node.lineno not in noqa:
            for op, val in zip(node.ops, node.comparators):
                if (isinstance(op, (ast.Eq, ast.NotEq))
                        and isinstance(val, ast.Constant)
                        and any(val.value is c for c in (True, False, None))):
                    problems.append(
                        f"{path}:{node.lineno}: comparison to "
                        f"{val.value!r} — use 'is'/'is not'/truthiness")
    return problems


def style_lint(repo: Optional[Path] = None, roots=STYLE_ROOTS,
               cache: Optional[SourceCache] = None) -> List[str]:
    """The style pass over ``roots`` (empty == clean)."""
    repo = Path(repo or REPO)
    cache = cache or SourceCache()
    out = []
    for rel, path in iter_source_files(repo, roots):
        s = cache.get(rel, path)
        out.extend(style_problems(Path(rel), s.src, s.tree)
                   if s.tree is not None else style_problems(Path(rel),
                                                             s.src))
    return out
