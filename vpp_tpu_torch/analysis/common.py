"""What every pass of the gate shares: the Finding record, suppression
comments read through the tokenizer, the source files under a set of
roots, and a parse cache.

Suppression syntax (the package docstring has the rule catalog):

* ``# capture-ok: <reason>``  — a capture-pass finding on this line.
* ``# unlocked: <reason>``    — a thread-pass finding on this line.
* ``# upload-ok: <reason>``   — an upload-pass finding on this line.
* ``# transfer-ok: <reason>`` — a transfer-pass finding on this line.
* ``# noqa``                  — the style pass's escape.

A suppression on a comment-only line (the last line of a comment block)
also covers the next code line, so a reason too long for the line
itself goes in a block right above it. A suppression without a reason
is itself a finding (``bare-suppression``): the reason is what the next
reader needs.
"""

from __future__ import annotations

import ast
import functools
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

REPO = Path(__file__).resolve().parents[2]

SUPPRESSION_RE = re.compile(
    r"#\s*(capture-ok|unlocked|upload-ok|transfer-ok)\b:?[ \t]*(.*)")

_KINDS = {"capture-ok": "capture", "unlocked": "unlocked",
          "upload-ok": "upload", "transfer-ok": "transfer"}


def _comment_lines(src: str) -> Dict[int, str]:
    """{line: comment text} from the tokenizer, so a suppression token
    inside a string literal never registers. Every line is scanned when
    the file does not tokenize (the style pass reports it)."""
    try:
        return {
            tok.start[0]: tok.string
            for tok in tokenize.generate_tokens(io.StringIO(src).readline)
            if tok.type == tokenize.COMMENT
        }
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {i: ln for i, ln in enumerate(src.splitlines(), 1)}


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Suppressions:
    """One file's suppressions: kind -> {line: reason}."""

    capture: Dict[int, str] = field(default_factory=dict)
    unlocked: Dict[int, str] = field(default_factory=dict)
    upload: Dict[int, str] = field(default_factory=dict)
    transfer: Dict[int, str] = field(default_factory=dict)
    problems: List[Finding] = field(default_factory=list)


def parse_suppressions(src: str, path: str = "<src>") -> Suppressions:
    """Every suppression comment of ``src`` (module doc)."""
    lines = src.splitlines()
    comments = _comment_lines(src)
    sup = Suppressions()
    for i, line in enumerate(lines, 1):
        m = SUPPRESSION_RE.search(comments.get(i, ""))
        if m is None:
            continue
        kind, reason = m.group(1), m.group(2).strip()
        if not reason:
            sup.problems.append(Finding(
                path, i, "bare-suppression",
                f"'# {kind}:' needs a reason (the annotation is the "
                f"documentation)"))
            continue
        target = getattr(sup, _KINDS[kind])
        target[i] = reason
        if line.lstrip().startswith("#"):
            j = i  # the 0-based index of the line after the comment
            while j < len(lines) and lines[j].lstrip()[:1] in ("#", ""):
                j += 1
            if j < len(lines):
                target[j + 1] = reason
    return sup


def iter_source_files(repo: Path,
                      roots: Iterable[str]) -> Iterator[Tuple[str, Path]]:
    """(repo-relative path, absolute path) of every ``.py`` file under
    ``roots``: a file, a directory (recursively, ``__pycache__``
    excluded) or a glob relative to the repo."""
    for root in roots:
        if any(c in root for c in "*?["):
            hits = sorted(repo.glob(root))
        else:
            p = repo / root
            hits = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in hits:
            if "__pycache__" in f.parts or f.suffix != ".py":
                continue
            yield f.relative_to(repo).as_posix(), f


class Source:
    """One parsed file: its text, its tree (None: it does not parse) and,
    read on first use, its suppressions."""

    def __init__(self, relpath: str, src: str, tree: Optional[ast.Module]):
        self.relpath, self.src, self.tree = relpath, src, tree

    @functools.cached_property
    def sup(self) -> Suppressions:
        return parse_suppressions(self.src, self.relpath)


class SourceCache:
    """Parsed files by absolute path, shared by the passes of one run so
    each file is read and parsed once."""

    def __init__(self):
        self._files: Dict[Path, Source] = {}

    def get(self, relpath: str, path: Path) -> Source:
        hit = self._files.get(path)
        if hit is None:
            src = path.read_text()
            try:
                tree = ast.parse(src, filename=relpath)
            except SyntaxError:
                tree = None  # the style pass reports it
            hit = Source(relpath, src, tree)
            self._files[path] = hit
        return hit


def dedupe(findings: Iterable) -> list:
    """Findings (or problem strings) in order, each once."""
    seen, out = set(), []
    for f in findings:
        if str(f) not in seen:
            seen.add(str(f))
            out.append(f)
    return out
