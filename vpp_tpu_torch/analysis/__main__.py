"""``python -m vpp_tpu_torch.analysis [--capture] [--threads] [--uploads]
[--transfers] [--kernels] [--tables] [--all]``: the style pass always,
then each pass asked for (the package docstring has the catalog). Prints
each problem once and exits 1 when anything fires."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from vpp_tpu_torch.analysis.common import REPO, SourceCache, dedupe

PASSES = ("capture", "threads", "uploads", "transfers", "kernels", "tables")


def run(passes, repo: Path = REPO,
        cache: Optional[SourceCache] = None) -> List[str]:
    """The style pass and ``passes`` over ``repo``: every problem once
    (``cache``: a parse cache to share, a fresh one by default)."""
    from vpp_tpu_torch.analysis import (
        capture_lint,
        style_lint,
        threads_lint,
        transfers_lint,
        uploads_lint,
    )

    cache = cache or SourceCache()
    out: list = list(style_lint(repo, cache=cache))
    if "capture" in passes:
        out += capture_lint(repo, cache=cache)
    if "threads" in passes:
        out += threads_lint(repo, cache=cache)
    if "uploads" in passes:
        out += uploads_lint(repo, cache=cache)
    if "transfers" in passes:
        out += transfers_lint(repo, cache=cache)
    if "kernels" in passes or "tables" in passes:
        from vpp_tpu_torch.analysis.registries import kernels_lint, tables_lint

        if "kernels" in passes:
            out += kernels_lint(repo, cache=cache)
        if "tables" in passes:
            out += tables_lint()
    return [str(p) for p in dedupe(out)]


def main(argv: Optional[List[str]] = None,
         cache: Optional[SourceCache] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vpp_tpu_torch.analysis",
        description="the port's static-analysis gate")
    for name in PASSES:
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"run the {name} pass")
    ap.add_argument("--all", action="store_true", help="run every pass")
    ap.add_argument("--repo", type=Path, default=REPO,
                    help="the checkout to scan (default: this one)")
    args = ap.parse_args(argv)
    passes = {p for p in PASSES if args.all or getattr(args, p)}
    problems = run(passes, args.repo.resolve(), cache)
    for p in problems:
        print(p)
    print(f"analysis: style{''.join(f' + {p}' for p in sorted(passes))}, "
          f"{len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
