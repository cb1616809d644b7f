"""Control-plane span tracer: trace-id'd spans over the config path.

A copy of the reference's ``vpp_tpu/trace/spans.py`` (stdlib only; this
package never imports the JAX package).

The paper's NB pipeline turns a K8s state change into programmed
dataplane tables through a chain of stages — KSR reflector event →
kvstore put → watch delivery → agent watcher dispatch → policy/service
render → ``ConfigTxn`` stage + epoch swap — and per-stage attribution
of that path is exactly what per-packet dataplanes obsess over on the
data path (Taurus, arxiv 2002.08987; nanoPU, arxiv 2212.06658). This
module is the control-plane analog of the packet tracer
(``trace/tracer.py``): spans instead of packets, a bounded in-memory
flight recorder instead of a trace ring.

Design:

  * **Spans** carry (trace_id, span_id, parent_id, stage, name, wall
    start, duration, attrs). ``stage`` is the coarse pipeline position
    ("ksr", "kvstore", "agent", "render", "txn", "swap", "cni", ...);
    ``name`` is the human line ("reflector put k8s/pod/default/web").
  * **Context** propagates through a thread-local span stack: the
    kvstore's synchronous watch delivery runs the whole chain on the
    writer's thread, so a root span opened at the KSR reflector (or the
    CNI server) automatically parents every downstream stage with zero
    plumbing through intermediate signatures. Cross-process hops
    (RemoteKVStore) drop the linkage — each process then records its
    local sub-trace.
  * **Recorder** is one module-level bounded deque (``RECORDER``), the
    `api-trace`-style always-on recorder: config events are rare, so
    recording is unconditional and costs two perf_counter reads per
    span. Layers that would fire per-watch-delivery guard on
    ``active()`` (a thread-local read) so un-traced store traffic pays
    a single dict lookup.

``Dataplane.swap()`` closes the loop: when a swap publishes under an
active trace, it observes ``now - root.t_wall`` into the agent's
``vpp_tpu_config_propagation_seconds`` histogram — the config
propagation latency SLO (event timestamp → epoch-swap complete).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

_local = threading.local()


def _stack() -> List["Span"]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


@dataclass
class Span:
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    stage: str
    name: str
    t_wall: float                 # wall-clock start (time.time)
    t0: float                     # perf_counter start
    duration: float = -1.0        # seconds; -1 = still open
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def done(self) -> bool:
        return self.duration >= 0.0


class SpanTracer:
    """Bounded flight recorder of finished spans + the begin/end API.

    Thread-safe; spans nest via the thread-local context stack, so
    ``begin`` on one thread must be ``end``ed on the same thread (the
    config path is synchronous — see module doc)."""

    def __init__(self, max_spans: int = 4096):
        self.max_spans = max_spans
        self._buf: Deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)

    # --- recording ---
    def begin(self, stage: str, name: str, **attrs: object) -> Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        span = Span(
            trace_id=(parent.trace_id if parent is not None
                      else f"t{next(self._trace_ids):06d}"),
            span_id=next(self._span_ids),
            parent_id=parent.span_id if parent is not None else None,
            stage=stage,
            name=name,
            t_wall=time.time(),
            t0=time.perf_counter(),
            attrs=dict(attrs),
        )
        stack.append(span)
        return span

    def end(self, span: Span) -> Span:
        span.duration = time.perf_counter() - span.t0
        stack = _stack()
        if stack and stack[-1] is span:
            stack.pop()
        else:  # out-of-order end (exception unwinding): drop by identity
            try:
                stack.remove(span)
            except ValueError:
                pass
        with self._lock:
            self._buf.append(span)
        return span

    @contextmanager
    def span(self, stage: str, name: str, **attrs: object):
        s = self.begin(stage, name, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    # --- readback ---
    def entries(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def traces(self) -> "Dict[str, List[Span]]":
        """Finished spans grouped by trace, each trace's spans sorted by
        start time (pipeline order), traces ordered by first start."""
        by_trace: Dict[str, List[Span]] = {}
        for s in self.entries():
            by_trace.setdefault(s.trace_id, []).append(s)
        for spans_ in by_trace.values():
            spans_.sort(key=lambda s: s.t0)
        return dict(sorted(by_trace.items(),
                           key=lambda kv: kv[1][0].t0))

    def format_traces(self, limit: int = 10) -> str:
        """`show spans` body: the most recent ``limit`` traces, one
        stage-tagged line per span, offsets relative to trace start."""
        traces = list(self.traces().items())
        if not traces:
            return "no spans recorded"
        lines: List[str] = []
        for trace_id, spans_ in traces[-limit:]:
            t0 = min(s.t0 for s in spans_)
            total = max(s.t0 + max(s.duration, 0.0) for s in spans_) - t0
            root = next((s for s in spans_ if s.parent_id is None),
                        spans_[0])
            lines.append(
                f"trace {trace_id} ({len(spans_)} spans, "
                f"{total * 1e3:.2f} ms) {root.name}"
            )
            for s in spans_:
                attrs = ""
                if s.attrs:
                    attrs = "  " + " ".join(
                        f"{k}={v}" for k, v in sorted(s.attrs.items())
                    )
                lines.append(
                    f"  [{s.stage:<8}] +{(s.t0 - t0) * 1e3:8.3f}ms "
                    f"{s.duration * 1e3:8.3f}ms  {s.name}{attrs}"
                )
        lines.append(f"{len(traces)} traces recorded, showing last "
                     f"{min(limit, len(traces))}")
        return "\n".join(lines)

    def to_json(self) -> str:
        """`/debug/spans` body: recorded timelines grouped by trace."""
        import json

        traces = []
        for trace_id, spans_ in self.traces().items():
            t0 = min(s.t0 for s in spans_)
            traces.append({
                "trace_id": trace_id,
                "spans": [
                    {
                        "stage": s.stage,
                        "name": s.name,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                        "start_ms": round((s.t0 - t0) * 1e3, 4),
                        "duration_ms": round(max(s.duration, 0.0) * 1e3, 4),
                        "wall_ts": s.t_wall,
                        "attrs": {str(k): str(v)
                                  for k, v in s.attrs.items()},
                    }
                    for s in spans_
                ],
            })
        return json.dumps({"traces": traces})

    def epoch_timings(self) -> Dict[object, Tuple[str, Dict[str, float]]]:
        """swap-epoch → (trace_id, stage → summed EXCLUSIVE seconds)
        over one consistent snapshot — the `show config-history` /
        /debug/txns join (the swap span carries the epoch it
        published).

        Config-path spans are fully nested (ksr wraps kvstore wraps
        agent …), so aggregating raw durations would report every
        upstream stage as "slow" whenever the innermost one is. The
        join therefore aggregates self-time: a span's duration minus
        its direct children's (clamped at 0 — a child evicted from the
        bounded buffer just costs attribution, never negative time)."""
        out: Dict[object, Tuple[str, Dict[str, float]]] = {}
        for trace_id, spans_ in self.traces().items():
            child_sum: Dict[int, float] = {}
            for s in spans_:
                if s.parent_id is not None:
                    child_sum[s.parent_id] = (
                        child_sum.get(s.parent_id, 0.0) + max(s.duration, 0.0)
                    )
            agg: Dict[str, float] = {}
            for s in spans_:
                self_time = max(
                    max(s.duration, 0.0) - child_sum.get(s.span_id, 0.0), 0.0
                )
                agg[s.stage] = agg.get(s.stage, 0.0) + self_time
            for s in spans_:
                if s.stage == "swap" and "epoch" in s.attrs:
                    out[s.attrs["epoch"]] = (trace_id, agg)
        return out


# the process-wide flight recorder every layer records into (the
# `api-trace { on }` discipline: always armed, bounded memory)
RECORDER = SpanTracer()


def active() -> bool:
    """True when the calling thread is inside a span (cheap guard for
    per-event layers like the kvstore watch fan-out)."""
    s = getattr(_local, "stack", None)
    return bool(s)


def current_span() -> Optional[Span]:
    s = getattr(_local, "stack", None)
    return s[-1] if s else None


def current_root() -> Optional[Span]:
    """The root span of the calling thread's active trace (its t_wall
    is the config event timestamp the propagation SLO measures from)."""
    s = getattr(_local, "stack", None)
    return s[0] if s else None
