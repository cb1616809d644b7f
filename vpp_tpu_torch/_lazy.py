"""Package exports that import their module at first use (PEP 562).

``cmd``, ``cni`` and ``io`` re-export names whose modules import torch
and the data plane. The IO daemon process (``cmd/io_daemon.py``) sits
under those packages but is host code only: with lazy exports, starting
it imports no torch, so on the card's host it takes no CUDA context.
"""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict):
    """A module ``__getattr__`` for ``package``: ``exports`` maps each
    re-exported name to the module that defines it; any other name is
    tried as a submodule."""

    def __getattr__(name: str):
        if name in exports:
            return getattr(importlib.import_module(exports[name]), name)
        try:
            return importlib.import_module(f"{package}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{package}.{name}":
                raise
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}") from None

    return __getattr__
