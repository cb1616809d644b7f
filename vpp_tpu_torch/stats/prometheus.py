"""Minimal Prometheus text-format exposition over stdlib HTTP.

Reference analog: cn-infra's prometheus plugin serving the
statscollector registry at :9999 (docs/Prometheus.md:1-26). No external
client library: gauges and histograms render to text format 0.0.4
directly.
"""

from __future__ import annotations

import bisect
import http.server
import re
import threading
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]

# every exported family must carry the project prefix (tools/lint.py
# metrics pass; the reference's contiv_* namespace discipline)
METRIC_NAME_RE = re.compile(r"^vpp_tpu_[a-z0-9_]+$")

# on-wire label pairs (the registry lint parses rendered histogram
# series to verify exposition completeness)
LABELS_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _labels_key(labels: Dict[str, str]) -> LabelSet:
    return tuple(sorted(labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # 0.0.4 HELP escaping: backslash and newline only (no quotes)
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(value: float) -> str:
    """Exact sample formatting: ':g' would round counters >1e6 (byte
    counters get there in ~1000 packets)."""
    return str(int(value)) if float(value).is_integer() else repr(float(value))


class Gauge:
    """One metric family; holds a value per label set.

    ``kind`` picks the exposition TYPE: "gauge" (default) or
    "counter" — cumulative families (per-stage pump seconds, byte
    totals) should advertise counter so PromQL ``rate()`` applies;
    the set/add/get surface is identical either way."""

    def __init__(self, name: str, help_text: str = "",
                 kind: str = "gauge"):
        if kind not in ("gauge", "counter"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.help = help_text
        self.kind = kind
        self._values: Dict[LabelSet, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = value

    def add(self, delta: float, **labels: str) -> None:
        with self._lock:
            k = _labels_key(labels)
            self._values[k] = self._values.get(k, 0.0) + delta

    def get(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)

    def remove(self, **labels: str) -> None:
        with self._lock:
            self._values.pop(_labels_key(labels), None)

    def render(self) -> List[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = sorted(self._values.items())
        for labels, value in items:
            sval = _fmt_value(value)
            if labels:
                lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
                out.append(f"{self.name}{{{lbl}}} {sval}")
            else:
                out.append(f"{self.name} {sval}")
        return out


class Histogram:
    """One histogram family: configurable cumulative ``le`` buckets,
    thread-safe ``observe()``, text-format 0.0.4 ``_bucket``/``_sum``/
    ``_count`` exposition — the distribution type the p50/p99 gauges
    could never be (PromQL histogram_quantile() aggregates these across
    nodes; a pre-computed quantile gauge cannot be aggregated).

    Bucket bounds are upper-inclusive seconds (or any unit) WITHOUT the
    implicit ``+Inf`` bucket, which is always appended on exposition.
    """

    # latency-shaped default: 500 µs .. 10 s (config-path operations)
    DEFAULT_BUCKETS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name: str, help_text: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help_text
        self.kind = "histogram"
        bounds = tuple(float(b) for b in (buckets or self.DEFAULT_BUCKETS))
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("buckets must be strictly ascending and non-empty")
        if any(b != b or b in (float("inf"), float("-inf")) for b in bounds):
            raise ValueError("buckets must be finite (+Inf is implicit)")
        self.buckets = bounds
        # per label set: per-bucket counts (len(buckets)+1, last = +Inf
        # overflow) + running sum
        self._counts: Dict[LabelSet, List[int]] = {}
        self._sums: Dict[LabelSet, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            k = _labels_key(labels)
            counts = self._counts.get(k)
            if counts is None:
                counts = self._counts[k] = [0] * (len(self.buckets) + 1)
                self._sums[k] = 0.0
            counts[idx] += 1
            self._sums[k] += value

    def get_count(self, **labels: str) -> int:
        with self._lock:
            return sum(self._counts.get(_labels_key(labels), ()))

    def get_sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(_labels_key(labels), 0.0)

    def render(self) -> List[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} histogram")
        with self._lock:
            items = sorted(
                (k, list(v), self._sums[k]) for k, v in self._counts.items()
            )
        for labels, counts, total_sum in items:
            lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
            prefix = f"{lbl}," if lbl else ""
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                out.append(
                    f'{self.name}_bucket{{{prefix}le="{_fmt_value(bound)}"}} '
                    f"{cum}"
                )
            cum += counts[-1]
            out.append(f'{self.name}_bucket{{{prefix}le="+Inf"}} {cum}')
            series = f"{{{lbl}}}" if lbl else ""
            out.append(f"{self.name}_sum{series} {_fmt_value(total_sum)}")
            out.append(f"{self.name}_count{series} {cum}")
        return out


class DeviceHistogram:
    """A histogram family whose buckets are SET wholesale from a
    device-computed bin vector instead of observed sample-by-sample —
    the exposition face of the device-resident telemetry plane
    (ops/telemetry.py; ISSUE 11). The fused step scatter-adds each
    packet into on-device log2 bins; collect fetches the small bin
    vector and publishes it here with the exact bucket boundaries, so
    the scrape side sees a conformant native histogram
    (``_bucket``/``_sum``/``_count``, cumulative, ``le="+Inf"`` ==
    ``_count``) it can ``histogram_quantile()`` across nodes.

    ``bounds`` are the finite upper bounds; the LAST device bin (the
    saturating overflow bucket) maps to the implicit ``+Inf``, so a
    bin vector has ``len(bounds) + 1`` entries. ``_sum`` is supplied
    by the caller (a documented lower-bound approximation — the exact
    sum never crosses the transport) and only has to stay monotone
    with the bins, which a cumulative device counter guarantees."""

    def __init__(self, name: str, help_text: str = "",
                 bounds: Tuple[float, ...] = ()):
        self.name = name
        self.help = help_text
        self.kind = "histogram"
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1
                             for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                "bounds must be strictly ascending and non-empty")
        if any(b != b or b in (float("inf"), float("-inf"))
               for b in bounds):
            raise ValueError("bounds must be finite (+Inf is implicit)")
        # the lint pass reads ``buckets`` off every histogram-kind
        # family — keep the attribute name shared with Histogram
        self.buckets = bounds
        self._bins: Optional[Tuple[int, ...]] = None
        self._sum = 0.0
        self._lock = threading.Lock()

    def set_bins(self, bins, sum_value: float) -> None:
        """Publish one device snapshot: ``bins`` are PER-BUCKET counts
        (len(buckets) + 1 — last is the overflow/+Inf bin)."""
        bins = tuple(int(b) for b in bins)
        if len(bins) != len(self.buckets) + 1:
            raise ValueError(
                f"{self.name}: {len(bins)} bins != {len(self.buckets)}"
                f" bounds + overflow")
        with self._lock:
            self._bins = bins
            self._sum = float(sum_value)

    def get_count(self) -> int:
        with self._lock:
            return sum(self._bins) if self._bins is not None else 0

    def render(self) -> List[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} histogram")
        with self._lock:
            bins, total_sum = self._bins, self._sum
        if bins is None:
            return out  # no snapshot yet: TYPE-only family (legal)
        cum = 0
        for bound, c in zip(self.buckets, bins):
            cum += c
            out.append(
                f'{self.name}_bucket{{le="{_fmt_value(bound)}"}} {cum}')
        cum += bins[-1]
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {_fmt_value(total_sum)}")
        out.append(f"{self.name}_count {cum}")
        return out


class MetricsRegistry:
    """Named path-scoped registries (the cn-infra ':9999/<path>' model).

    Holds any family object exposing ``name``/``help``/``render()``
    (Gauge, Histogram)."""

    def __init__(self):
        self._gauges: Dict[str, List] = {}
        self._lock = threading.Lock()

    def register(self, path: str, gauge):
        with self._lock:
            self._gauges.setdefault(path, []).append(gauge)
        return gauge

    def paths(self) -> List[str]:
        with self._lock:
            return list(self._gauges)

    def families(self) -> List[Tuple[str, object]]:
        """Every registered (path, family) pair — lint/index surface."""
        with self._lock:
            return [(p, g) for p, gs in self._gauges.items() for g in gs]

    def lint(self) -> List[str]:
        """Registry-level metrics lint (tools/lint.py --metrics): every
        family name matches the project namespace, carries non-empty
        help, and no family name is registered twice (within or across
        paths — duplicate names scrape as conflicting series). Every
        histogram-kind family (Histogram AND DeviceHistogram — the
        native-histogram face of the device telemetry plane)
        additionally has strictly increasing finite bucket boundaries
        and renders a COMPLETE ``_bucket``/``_sum``/``_count`` triple
        per label set with cumulative buckets and ``le="+Inf"`` equal
        to ``_count`` (ISSUE 11 satellite)."""
        problems: List[str] = []
        seen: Dict[str, str] = {}
        for path, fam in self.families():
            name = getattr(fam, "name", "")
            if not METRIC_NAME_RE.match(name):
                problems.append(
                    f"{path}: metric name {name!r} does not match "
                    f"{METRIC_NAME_RE.pattern}"
                )
            if not getattr(fam, "help", ""):
                problems.append(f"{path}: metric {name!r} has empty help text")
            if name in seen:
                problems.append(
                    f"duplicate metric family {name!r} registered at "
                    f"{seen[name]} and {path}"
                )
            else:
                seen[name] = path
            if getattr(fam, "kind", "") == "histogram":
                problems.extend(self._lint_histogram(path, fam))
        return problems

    @staticmethod
    def _lint_histogram(path: str, fam) -> List[str]:
        """Boundary + exposition-completeness checks of one
        histogram-kind family (the --metrics satellite of ISSUE 11)."""
        problems: List[str] = []
        name = getattr(fam, "name", "?")
        bounds = tuple(getattr(fam, "buckets", ()))
        if not bounds:
            problems.append(
                f"{path}: histogram {name!r} has no bucket boundaries")
        elif any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            problems.append(
                f"{path}: histogram {name!r} bucket boundaries are "
                f"not strictly increasing: {bounds}")
        if any(b != b or b in (float("inf"), float("-inf"))
               for b in bounds):
            problems.append(
                f"{path}: histogram {name!r} has non-finite bucket "
                f"boundary (+Inf is implicit)")
        # render-side completeness: for every label set that exposes a
        # _bucket series, the cumulative contract must close — last
        # bucket is +Inf, its value equals _count, and _sum exists
        buckets: Dict[str, List[Tuple[str, float]]] = {}
        counts: Dict[str, float] = {}
        sums: Dict[str, float] = {}
        for line in fam.render():
            if line.startswith("#"):
                continue
            series, _, value = line.rpartition(" ")
            base, brace, label_s = series.partition("{")
            label_s = label_s[:-1] if brace else ""
            if base == f"{name}_bucket":
                pairs = dict(LABELS_RE.findall(label_s))
                le = pairs.pop("le", "")
                key = ",".join(f"{k}={v}" for k, v in sorted(pairs.items()))
                buckets.setdefault(key, []).append((le, float(value)))
            elif base == f"{name}_count":
                key = ",".join(
                    f"{k}={v}" for k, v in
                    sorted(LABELS_RE.findall(label_s)))
                counts[key] = float(value)
            elif base == f"{name}_sum":
                key = ",".join(
                    f"{k}={v}" for k, v in
                    sorted(LABELS_RE.findall(label_s)))
                sums[key] = float(value)
        for key, series in buckets.items():
            values = [v for _le, v in series]
            if values != sorted(values):
                problems.append(
                    f"{path}: histogram {name!r}{{{key}}} buckets are "
                    f"not cumulative")
            if not series or series[-1][0] != "+Inf":
                problems.append(
                    f"{path}: histogram {name!r}{{{key}}} missing the "
                    f"+Inf bucket")
                continue
            if key not in counts or key not in sums:
                problems.append(
                    f"{path}: histogram {name!r}{{{key}}} missing "
                    f"_sum/_count series")
            elif series[-1][1] != counts[key]:
                problems.append(
                    f"{path}: histogram {name!r}{{{key}}} +Inf bucket "
                    f"{series[-1][1]} != _count {counts[key]}")
        for key in set(counts) | set(sums):
            if key not in buckets:
                problems.append(
                    f"{path}: histogram {name!r}{{{key}}} has "
                    f"_sum/_count but no _bucket series")
        return problems

    def render(self, path: str) -> Optional[str]:
        with self._lock:
            gauges = list(self._gauges.get(path, ()))
        if not gauges and path not in self.paths():
            return None
        lines: List[str] = []
        for g in gauges:
            lines.extend(g.render())
        return "\n".join(lines) + "\n"


class StatsHTTPServer:
    """Serves every registry path ('/stats', '/metrics', ...) on one port.

    Beyond the registry paths it serves ``/`` (a text index of every
    registered path — registry and debug pages alike, so an operator
    can discover the surface with one curl) and any debug page added
    via ``add_page()`` (the agent's ``/debug/txns`` / ``/debug/spans``).
    HEAD is answered for everything GET serves (a probe that HEADs a
    metrics endpoint must not 501/hang)."""

    PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, registry: MetricsRegistry, port: int = 9999,
                 host: str = "127.0.0.1"):
        self.registry = registry
        # path -> (content-type, zero-arg callable returning body str)
        self._pages: Dict[str, Tuple[str, Callable[[], str]]] = {}
        self._pages_lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _resolve(self) -> Optional[Tuple[str, bytes]]:
                path = urllib.parse.urlsplit(self.path).path
                return outer.resolve(path)

            def _serve(self, include_body: bool) -> None:
                try:
                    resolved = self._resolve()
                except Exception as e:  # noqa: BLE001 — debug pages
                    data = f"{type(e).__name__}: {e}\n".encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    if include_body:
                        self.wfile.write(data)
                    return
                if resolved is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                ctype, data = resolved
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if include_body:
                    self.wfile.write(data)

            def do_GET(self):
                self._serve(include_body=True)

            def do_HEAD(self):
                self._serve(include_body=False)

            def log_message(self, *args):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def add_page(self, path: str, fn: Callable[[], str],
                 content_type: str = "application/json") -> None:
        """Mount a debug page: ``fn()`` is called per request and must
        return the body as a string (e.g. the agent's /debug/txns)."""
        with self._pages_lock:
            self._pages[path] = (content_type, fn)

    def index(self) -> str:
        """The ``/`` body: one served path per line."""
        with self._pages_lock:
            pages = list(self._pages)
        paths = sorted(set(self.registry.paths()) | set(pages))
        return "\n".join(paths) + "\n" if paths else "(no paths registered)\n"

    def resolve(self, path: str) -> Optional[Tuple[str, bytes]]:
        """(content-type, body) for a request path; None = 404."""
        if path == "/":
            return "text/plain; charset=utf-8", self.index().encode()
        body = self.registry.render(path)
        if body is not None:
            return self.PROM_CTYPE, body.encode()
        with self._pages_lock:
            page = self._pages.get(path)
        if page is not None:
            ctype, fn = page
            return ctype, fn().encode()
        return None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="stats-http"
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
