"""Per-stage cycle accounting: the `show run` analog.

Reference: VPP's `show run` prints per-graph-node calls, vectors and
clocks/vector (docs/VPP_PACKET_TRACING_K8S.md:28-50). The port's
counterpart of ``vpp_tpu/trace/cycles.py``, with the same rows, node
names and row order: the nine stages, the FUSED row, then the two BV
rows when the epoch carries real interval-bitmap planes.

How a row is timed differs from the reference, which ``jax.jit``s each
stage and times it in isolation, then times the jitted
``pipeline_step`` as the FUSED row. Here each stage runs eagerly on the
tables' device: one warm-up call (it builds the kernels), then
``iters`` calls, each between two CUDA events (the wall clock on the
CPU). The stages run on a private copy of the state a step writes (the
session, telemetry and tenancy planes and the ECMP counters), restored
between calls outside the timed span, so every call sees the same
tables and the live planes never move. The FUSED row times the captured
step program (``pipeline/capture.py`` ``Program``, the port's unit of
compilation, the counterpart of a jit) of the full chain over the same
copy: its first call runs eagerly and captures, its second is the
first replay, and the timed calls are replays.

Handed a ``Dataplane``, the rows run its selected rungs — with the
``pallas`` knobs on the card, session-lookup launches
``sess_probe_ways``, ip4-lookup ``lpm_fused_lookup`` and the two BV
rows ``bv_first_set`` — and FUSED replays its full-chain step; the
profile holds the dataplane's ``_lock``, so it times one whole epoch.
Handed bare tables, the rows run the reference's rungs (gather, dense,
dense) and FUSED the default ``pipeline_step``. The sum of the rows
exceeds the FUSED row (a captured graph saves the launches between
stages): the rows locate the expensive node, FUSED is the real cost.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List

import torch

from vpp_tpu_torch.ops.acl import acl_classify_global, acl_classify_local
from vpp_tpu_torch.ops.ip4 import ip4_input
from vpp_tpu_torch.ops.nat44 import nat44_dnat, nat44_reverse, nat44_snat
from vpp_tpu_torch.ops.session import session_insert, session_lookup_reverse
from vpp_tpu_torch.pipeline import capture
from vpp_tpu_torch.pipeline.graph import (
    SWEEP_STRIDE_DEFAULT,
    _classifier_fns,
    _fib_fn,
    make_pipeline_step,
)
from vpp_tpu_torch.pipeline.vector import PacketVector


@dataclasses.dataclass
class StageTiming:
    node: str
    calls: int
    vectors: int          # packets per call
    seconds_per_call: float

    @property
    def ns_per_packet(self) -> float:
        if self.vectors == 0:
            return 0.0
        return self.seconds_per_call / self.vectors * 1e9


def _time(fn: Callable, iters: int, reset: Callable, device) -> float:
    """Seconds per call of ``fn()`` after one warm-up, ``reset()`` run
    before every call outside its timed span."""
    reset()
    fn()  # warm: builds kernels, captures a program
    if device.type != "cuda":
        total = 0.0
        for _ in range(iters):
            reset()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        return total / iters
    pairs = []
    for _ in range(iters):
        reset()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize(device)
    return sum(a.elapsed_time(b) for a, b in pairs) / 1e3 / iters


def profile_stages(
    tables,
    pkts: PacketVector,
    now=None,
    iters: int = 20,
) -> List[StageTiming]:
    """Time each pipeline stage in isolation + the fused step.

    ``tables`` is a ``Dataplane`` (its selected rungs and step, under
    its ``_lock``) or bare ``DataplaneTables`` (the reference's rungs).
    ``pkts`` lies on the tables' device. Nothing of the live state
    moves (module doc)."""
    from vpp_tpu_torch.pipeline.dataplane import _MUTABLE_FIELDS

    dp = tables if hasattr(tables, "_get_step") else None
    with dp._lock if dp is not None else contextlib.nullcontext():
        live = dp.tables if dp is not None else tables
        device = live.sess_valid.device
        if dp is not None:
            step = dp._get_step(False)
            sess_impl, fib_impl = dp.session_impl, dp.fib_impl
            bv_impl = "pallas" if dp.classifier_impl == "pallas" else "bv"
            sidecar = dp._sidecar(pkts, None, None)
            stride = dp._sweep_stride
        else:
            step = make_pipeline_step()
            sess_impl, fib_impl, bv_impl = "gather", "dense", "bv"
            sidecar = (None, None)
            stride = SWEEP_STRIDE_DEFAULT
        # the private state every row writes, and its starting values
        scratch = live._replace(**{f: getattr(live, f).clone()
                                   for f in _MUTABLE_FIELDS})
        saved = [getattr(scratch, f).clone() for f in _MUTABLE_FIELDS]

        def reset():
            for f, v in zip(_MUTABLE_FIELDS, saved):
                getattr(scratch, f).copy_(v)

        t = scratch
        n = int(pkts.src_ip.shape[0])
        alive = pkts.valid
        now_i = 1 if now is None else int(now)
        now_t = torch.full((), now_i, dtype=torch.int32, device=device)
        cols = tuple(pkts)
        if sidecar[0] is not None:
            cols += tuple(sidecar[0]) + (sidecar[1],)
        prog = capture.Program(
            "show-run:" + capture.step_label(step, "plain", stride),
            (capture.new_owner(), (len(cols), n),
             capture.table_signature(scratch)),
            scratch, step, "plain", (len(cols), n), device)

        def fused():
            return prog.run(now_i, lambda x: torch.stack(cols, out=x))

        fib = _fib_fn(fib_impl)
        stages = {
            "ip4-input": lambda: ip4_input(pkts),
            "session-lookup": lambda: session_lookup_reverse(
                t, pkts, impl=sess_impl),
            "nat44-reverse": lambda: nat44_reverse(t, pkts, alive),
            "nat44-dnat": lambda: nat44_dnat(t, pkts, alive),
            "acl-classify-local": lambda: acl_classify_local(t, pkts),
            "acl-classify-global": lambda: acl_classify_global(t, pkts),
            "ip4-lookup": lambda: fib(t, pkts),
            "nat44-snat": lambda: nat44_snat(t, pkts, alive),
            "session-insert": lambda: session_insert(t, pkts, alive,
                                                     now_t),
            "FUSED pipeline-step": fused,
        }
        # BV classify rows only when the epoch carries a real interval-
        # bitmap structure (placeholder shapes mean the knob disabled
        # BV)
        if int(t.glb_bv_src.shape[0]) > 2:
            glb_bv, local_bv = _classifier_fns(bv_impl)
            stages["acl-classify-global-bv"] = lambda: glb_bv(t, pkts)
            stages["acl-classify-local-bv"] = lambda: local_bv(t, pkts)
        out = []
        for name, fn in stages.items():
            sec = _time(fn, iters, reset, device)
            out.append(StageTiming(
                node=name, calls=iters, vectors=n, seconds_per_call=sec,
            ))
    return out


def format_show_run(timings: List[StageTiming]) -> str:
    """`show run`-style table."""
    header = (
        f"{'Node':<24}{'Calls':>8}{'Vectors':>10}"
        f"{'us/call':>12}{'ns/packet':>12}"
    )
    lines = [header, "-" * len(header)]
    for t in timings:
        lines.append(
            f"{t.node:<24}{t.calls:>8}{t.vectors:>10}"
            f"{t.seconds_per_call * 1e6:>12.2f}{t.ns_per_packet:>12.2f}"
        )
    return "\n".join(lines)
