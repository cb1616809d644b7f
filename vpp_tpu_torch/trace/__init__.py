"""Tracing: the packet tracer, per-stage timing and the control-plane
span recorder.

``trace.tracer`` is the packet tracer (VPP's ``trace add`` / ``show
trace``) over the port's ``StepResult``; ``trace.cycles`` the per-stage
timing (``show run``: ``profile_stages``, ``format_show_run``);
``trace.spans`` the span recorder over the config path, a copy of the
reference's. Re-exports
resolve lazily (PEP 562), so a process that needs only ``trace.spans``
does not import torch.
"""

_LAZY = {
    "PacketTracer": ("vpp_tpu_torch.trace.tracer", "PacketTracer"),
    "TraceEntry": ("vpp_tpu_torch.trace.tracer", "TraceEntry"),
    "StageTiming": ("vpp_tpu_torch.trace.cycles", "StageTiming"),
    "profile_stages": ("vpp_tpu_torch.trace.cycles", "profile_stages"),
    "format_show_run": ("vpp_tpu_torch.trace.cycles", "format_show_run"),
    "Span": ("vpp_tpu_torch.trace.spans", "Span"),
    "SpanTracer": ("vpp_tpu_torch.trace.spans", "SpanTracer"),
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
