"""Named, seeded fault-injection points.

A copy of ``vpp_tpu/testing/faults.py`` (the port never imports the JAX
package): one in-band way to fail on purpose at a named seam, so the
tests run the real error-handling paths. ``fire`` costs one global load
and an ``is None`` branch while no plan is installed. Faults arm by call
count (``after`` / ``times``), so a schedule is reproducible whatever
the thread interleaving; ``inject(exc=...)`` picks the exception type a
site's real failure would raise (as a subclass that also derives
:class:`FaultInjected`).

The seams compiled into this package:

====================  ====================================================
point                 seam
====================  ====================================================
``snapshot.chunk``    pipeline/snapshot.py — chunk file write (torn chunk)
``snapshot.manifest`` pipeline/snapshot.py — manifest publish (torn/crash)
``fleet.migrate``     pipeline/snapshot.py ``drain_bucket_range``, per
                      drained chunk, and fleet/steering.py once a range
                      move before its commit
``fleet.steer``       fleet/steering.py — per ``partition`` call
``ring.dispatch``     pipeline/persistent.py — a window's dispatch (kills
                      the ring's stager: the pump's fault ladder)
``ring.fetch``        pipeline/persistent.py — a window's result copy
``pump.fetch``        io/pump.py — a dispatched batch's result fetch
                      (``drops_error``)
``pump.tx_push``      io/pump.py — a tx-ring push (``drops_tx_stall``)
``pump.priority_starve`` io/pump.py — a priority frame demoted to bulk
``pump.tenant_starve`` io/pump.py — a frame demoted to the default tenant
``governor.tick``     io/governor.py — a governor control tick
``service.churn``     service/configurator.py — after every staged
                      svc-plane mutation of a backend replacement; a
                      failure mid-churn rolls the builder back, so a
                      half-applied backend set never reaches a swap
====================  ====================================================
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Type

__all__ = [
    "FaultInjected", "FaultPlan", "fire", "install", "uninstall",
    "active_plan",
]


class FaultInjected(RuntimeError):
    """Default injected-fault exception (and marker base: injected
    OSError/TimeoutError subclasses mix it in so tests can tell an
    injected failure from an organic one with ``isinstance``)."""


# injected-<Type> subclasses, built once per base type so `except
# OSError` at the site catches them AND `isinstance(e, FaultInjected)`
# still identifies them as injected
_EXC_CACHE: Dict[type, type] = {FaultInjected: FaultInjected}
_EXC_CACHE_LOCK = threading.Lock()


def _exc_type(base: Type[BaseException]) -> type:
    with _EXC_CACHE_LOCK:
        t = _EXC_CACHE.get(base)
        if t is None:
            t = type(f"Injected{base.__name__}", (base, FaultInjected), {})
            _EXC_CACHE[base] = t
        return t


class _Spec:
    __slots__ = ("action", "after", "times", "delay_s", "prob", "exc",
                 "fired")

    def __init__(self, action: str, after: int, times: int,
                 delay_s: float, prob: Optional[float],
                 exc: Type[BaseException]):
        self.action = action
        self.after = after
        self.times = times
        self.delay_s = delay_s
        self.prob = prob
        self.exc = exc
        self.fired = 0


class FaultPlan:
    """A seeded set of armed faults. Install with :func:`install`;
    sites report through :func:`fire`.

    ``inject(point, action=..., after=..., times=...)`` arms one spec:
    calls 1..``after`` of the point pass clean, the next ``times``
    calls fire, later calls pass clean again (``times=-1`` = forever).
    Multiple specs on one point evaluate in arm order — the first
    still-live spec whose window covers the call decides.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._specs: Dict[str, List[_Spec]] = {}
        self._calls: Dict[str, int] = {}

    # --- arming ---
    def inject(self, point: str, action: str = "error", after: int = 0,
               times: int = 1, delay_s: float = 0.0,
               prob: Optional[float] = None,
               exc: Type[BaseException] = FaultInjected) -> "FaultPlan":
        """Arm ``point``. ``action``: ``"error"`` raises ``exc`` (as an
        injected subclass), ``"delay"`` sleeps ``delay_s`` then passes.
        ``prob`` switches the spec from counted to probabilistic (drawn
        from the plan's seeded RNG; ``after``/``times`` still bound the
        window). Returns self for chaining."""
        if action not in ("error", "delay"):
            raise ValueError(f"unknown fault action {action!r}")
        spec = _Spec(action, int(after), int(times), float(delay_s),
                     prob, exc)
        with self._lock:
            self._specs.setdefault(point, []).append(spec)
        return self

    # --- site entry (via module-level fire()) ---
    def _fire(self, point: str) -> None:
        with self._lock:
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            hit: Optional[_Spec] = None
            for spec in self._specs.get(point, ()):
                if n <= spec.after:
                    continue
                if spec.times >= 0 and spec.fired >= spec.times:
                    continue
                if spec.prob is not None and \
                        self._rng.random() >= spec.prob:
                    continue
                spec.fired += 1
                hit = spec
                break
        if hit is None:
            return
        if hit.action == "delay":
            time.sleep(hit.delay_s)
            return
        raise _exc_type(hit.exc)(
            f"injected fault at {point!r} (call {n})")

    # --- introspection (test asserts) ---
    def calls(self, point: str) -> int:
        """How many times ``point`` was reached (fired or not)."""
        with self._lock:
            return self._calls.get(point, 0)

    def fired(self, point: str) -> int:
        """How many times ``point`` actually fired a fault."""
        with self._lock:
            return sum(s.fired for s in self._specs.get(point, ()))


# The installed plan. One global, read without a lock: fire() must cost
# a single load + None check on the idle hot path (pump fetch, kv
# send). Install/uninstall are test-time only.
_PLAN: Optional[FaultPlan] = None


def fire(point: str) -> None:
    """Fault-point hook compiled into production seams. No-op (one
    global read) unless a plan is installed and has the point armed;
    otherwise sleeps or raises per the armed spec."""
    plan = _PLAN
    if plan is not None:
        plan._fire(point)


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide (pair with ``uninstall`` in a
    ``finally``: the plan is global)."""
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN
