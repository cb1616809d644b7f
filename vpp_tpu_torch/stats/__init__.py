"""Observability: stats collection + Prometheus exposition.

Reference analogs: plugins/statscollector (pod-labelled per-interface
gauges at :9999/stats, plugin_impl_statscollector.go:20-90) and the KSR
per-reflector gauges (plugins/ksr/ksr_statscollector.go:68-160).

Re-exports resolve lazily (PEP 562): StatsCollector pulls in the
torch-backed dataplane, and light processes (kvserver) that only need the
Prometheus primitives must not pay that import.
"""

_LAZY = {
    "StatsCollector": ("vpp_tpu_torch.stats.collector", "StatsCollector"),
    "Gauge": ("vpp_tpu_torch.stats.prometheus", "Gauge"),
    "Histogram": ("vpp_tpu_torch.stats.prometheus", "Histogram"),
    "MetricsRegistry": ("vpp_tpu_torch.stats.prometheus", "MetricsRegistry"),
    "StatsHTTPServer": ("vpp_tpu_torch.stats.prometheus", "StatsHTTPServer"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value  # cache for subsequent lookups
    return value
