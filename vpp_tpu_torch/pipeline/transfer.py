"""Host/device transfer accounting.

The counterpart of the reference's ``count_device_transfer`` /
``device_transfer_totals`` / ``transfer_budget``
(``vpp_tpu/pipeline/dataplane.py``), which charge every sanctioned
device-to-host fetch to its site (``snapshot.drain``, ``migrate.drain``,
``migrate.adopt``, ``migrate.release``, ``fib.snapshot``). The port also
charges the host-to-device bytes of every table upload to its upload
group (``TableBuilder.to_device``: ``glb``, ``glb_bv``, ``fib``, ...), so
a swap's cost reads as bytes per group and a clean group as 0. The two
directions are kept apart: ``device_transfer_totals()`` is the
reference's device-to-host table, ``device_transfer_totals("h2d")`` the
uploads.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

DIRECTIONS = ("d2h", "h2d")

_BYTES: Dict[str, Dict[str, int]] = {d: {} for d in DIRECTIONS}
_LOCK = threading.Lock()


def _nbytes(fetched) -> int:
    """Bytes of a tensor / array, or of every leaf of a dict, list or
    tuple of them (a scalar counts 8, as the reference's)."""
    if isinstance(fetched, dict):
        return sum(_nbytes(v) for v in fetched.values())
    if isinstance(fetched, (list, tuple)):
        return sum(_nbytes(v) for v in fetched)
    nb = getattr(fetched, "nbytes", None)
    if nb is None and hasattr(fetched, "element_size"):
        nb = fetched.element_size() * fetched.numel()
    return int(nb) if nb is not None else 8


def count_device_transfer(site: str, fetched, direction: str = "d2h"
                          ) -> None:
    """Charge ``fetched``'s bytes (a tensor, an array, an int byte count
    or a dict / list / tuple of them) to ``site`` in ``direction``."""
    total = fetched if isinstance(fetched, int) else _nbytes(fetched)
    with _LOCK:
        table = _BYTES[direction]
        table[site] = table.get(site, 0) + int(total)


def device_transfer_totals(direction: str = "d2h") -> Dict[str, int]:
    """Snapshot of {site: bytes} moved in ``direction`` by this
    process."""
    with _LOCK:
        return dict(_BYTES[direction])


class TransferBudgetExceeded(AssertionError):
    """Raised by transfer_budget() when a scope moves more bytes than it
    declared."""


class _TransferBudget:
    def __init__(self, budget_bytes: int, direction: str):
        self.budget = budget_bytes
        self.direction = direction
        self._before: Optional[Dict[str, int]] = None

    def __enter__(self) -> "_TransferBudget":
        self._before = device_transfer_totals(self.direction)
        return self

    def moved(self) -> Dict[str, int]:
        """{site: bytes} moved since the scope was entered."""
        before = self._before or {}
        return {k: n - before.get(k, 0)
                for k, n in device_transfer_totals(self.direction).items()
                if n - before.get(k, 0) > 0}

    @property
    def spent(self) -> int:
        return sum(self.moved().values())

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        new = self.moved()
        spent = sum(new.values())
        if spent > self.budget:
            detail = ", ".join(
                f"{site}={n}B" for site, n in sorted(new.items()))
            raise TransferBudgetExceeded(
                f"{self.direction} transfer budget exceeded: {spent} "
                f"bytes > declared budget {self.budget} ({detail})")


def transfer_budget(budget_bytes: int,
                    direction: str = "d2h") -> _TransferBudget:
    """Context manager: fail if the enclosed scope moves more than
    ``budget_bytes`` in ``direction`` through the counted sites;
    ``.moved()`` gives the per-site bytes inside the scope."""
    return _TransferBudget(budget_bytes, direction)
