"""Shared jittered exponential backoff.

The port's copy of ``vpp_tpu/net/backoff.py``; the IO pump paces its
ring relaunches with it. Fixed intervals
synchronize: after a kvserver restart every agent in the fleet
reconnects on the same beat (the classic thundering herd), and a
partition heal hits the witness with every standby's claim at once.

``backoff_with_jitter`` is the one pacing policy: exponential growth
to a cap with multiplicative jitter in ``[0.5, 1.0)`` of the
exponential envelope — the jitter decorrelates the herd while the
0.5 floor guarantees forward progress (a full-jitter ``[0, env)`` draw
can return ~0 repeatedly and busy-spin a reconnect loop). Determinism
for tests comes from the optional ``rng``: seed it and the schedule is
reproducible.
"""

from __future__ import annotations

import random
from typing import Optional

__all__ = ["backoff_with_jitter", "Backoff"]


def backoff_with_jitter(attempt: int, base: float = 0.1,
                        cap: float = 2.0,
                        rng: Optional[random.Random] = None) -> float:
    """Delay before retry number ``attempt`` (0-based): jittered
    ``min(cap, base * 2**attempt)``. The jitter factor is drawn in
    [0.5, 1.0) so consecutive callers desynchronize but the delay
    never collapses toward zero."""
    if attempt < 0:
        attempt = 0
    env = min(float(cap), float(base) * (2.0 ** min(attempt, 63)))
    r = rng.random() if rng is not None else random.random()
    return env * (0.5 + 0.5 * r)


class Backoff:
    """Stateful retry pacer: ``next()`` returns the delay for the next
    attempt and advances; ``reset()`` on success returns to the base.
    NOT thread-safe by design — every retry loop owns its instance
    (sharing a pacer across threads would couple their schedules,
    which is exactly what the jitter exists to prevent)."""

    def __init__(self, base: float = 0.1, cap: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.base = float(base)
        self.cap = float(cap)
        self._rng = rng
        self.attempt = 0
        self.last_delay = 0.0

    def next(self) -> float:
        d = backoff_with_jitter(self.attempt, self.base, self.cap,
                                self._rng)
        self.attempt += 1
        self.last_delay = d
        return d

    def reset(self) -> None:
        self.attempt = 0
        self.last_delay = 0.0

    def state(self) -> dict:
        """Snapshot for observability (`show resilience`)."""
        return {"attempt": self.attempt,
                "last_delay_s": round(self.last_delay, 3),
                "base_s": self.base, "cap_s": self.cap}
