"""The dataplane's observability surface: vpp_tpu_torch vs vpp_tpu.

* The span recorder (trace/spans.py): the reference's unit cases of
  ``tests/test_spans.py`` (nesting and trace ids, the bound, per-thread
  context, grouping by start, the empty format) on the port's copy.
* The packet tracer (trace/tracer.py): the ``tests/test_trace.py``
  scenarios run through both packages, every tracer's
  ``format_trace()`` and entries held equal.
* ``on_if_freed`` observers hear of a freed pod interface, outside the
  lock; ``swap`` observes the commit, propagation and FIB-churn
  histograms (test doubles here; the collector sets real ones) and
  journals one entry per epoch that staged something, as the
  reference's does.
* ``kernel_snapshot`` has the reference's keys and ``impl`` / ``knob``
  values on the CPU for every knob of each ladder; ``time_classifier``
  times the selected classifier and sets its accumulators.
* The IO pump runs unchained, through the unpacked step, while a tracer
  is armed, and delivers the same tx frames and traces as the
  reference's.

The port runs on the CPU. Every quantity compared is an integer or a
string: the tolerance is exact equality.
"""

import pytest

import test_spans as jspans_test
import test_trace as jtrace_test
from test_torch_policy import run_case
from test_torch_pump import PKG, assert_same_frames, drain, forwarding_dp
from test_torch_pump import push_frames
from vpp_tpu.ir import rule as jrule
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu.trace import spans as jspans
from vpp_tpu.trace import tracer as jtracer
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.trace import spans as tspans
from vpp_tpu_torch.trace import tracer as ttracer

VEC = 256

# --- spans ---------------------------------------------------------------

SPAN_CASES = ("test_span_nesting_and_trace_ids",
              "test_span_recorder_is_bounded",
              "test_span_context_is_per_thread",
              "test_traces_grouping_sorted_by_start",
              "test_format_traces_empty")


@pytest.mark.parametrize("case", SPAN_CASES)
def test_span_recorder_cases_on_the_port(case):
    run_case(jspans_test, case, dict(spans=tspans))


def test_span_module_is_a_copy():
    """The port's recorder keeps the reference's public surface."""
    names = {n for n in vars(jspans) if not n.startswith("__")}
    assert names <= set(vars(tspans))


# --- the packet tracer ---------------------------------------------------

def recording_tracers(base, made: list):
    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    return Recording


def trace_names(port: bool, made: list) -> dict:
    r, v = (trule, tvector) if port else (jrule, jvector)

    class CpuDataplane(tdp.Dataplane):
        def __init__(self, config=None):
            super().__init__(config, device="cpu")

    return dict(
        Action=r.Action, ContivRule=r.ContivRule, Protocol=r.Protocol,
        Dataplane=CpuDataplane if port else jdp.Dataplane,
        DataplaneConfig=(ttables if port else jtables).DataplaneConfig,
        Disposition=v.Disposition, ip4=v.ip4,
        make_packet_vector=v.make_packet_vector,
        PacketTracer=recording_tracers(
            ttracer.PacketTracer if port else jtracer.PacketTracer, made))


TRACE_CASES = ("test_trace_paths_and_arming",
               "test_trace_established_return_flow",
               "test_trace_arming_counts_down_across_frames",
               "test_dataplane_auto_records_when_tracer_attached")


@pytest.mark.parametrize("case", TRACE_CASES)
def test_packet_tracer_cases(case):
    """Each reference scenario's own assertions hold on the port, and
    every tracer's entries and ``format_trace()`` equal the
    reference's."""
    traces = {}
    for port in (False, True):
        made = []
        run_case(jtrace_test, case, trace_names(port, made))
        traces[port] = [(t.format_trace(), [e.__dict__ for e in t.entries()])
                        for t in made]
    assert traces[True] == traces[False] and traces[True]


def test_tracer_renders_the_ml_and_tenant_nodes():
    """The ML stage's node and the tenant-limit leaf render as the
    reference renders them (a forest model staged, a tenant bucket that
    runs dry)."""
    from test_torch_upload import FOREST

    texts = []
    for port in (False, True):
        tb, v = (ttables, tvector) if port else (jtables, jvector)
        cfg = tb.DataplaneConfig(sess_slots=256, max_tables=4,
                                 ml_stage="enforce", ml_hidden=8,
                                 ml_trees=2, ml_depth=2, tenancy="on")
        dp = (tdp.Dataplane(cfg, device="cpu") if port
              else jdp.Dataplane(cfg))
        up = dp.add_uplink()
        a = dp.add_pod_interface(("default", "a"))
        dp.builder.add_route("10.1.1.2/32", a, v.Disposition.LOCAL)
        dp.builder.set_ml_model(FOREST)
        dp.builder.set_tenant(1, prefixes=["172.16.0.0/16"], rate=1,
                              burst=2)
        dp.swap()
        tr = (ttracer if port else jtracer).PacketTracer()
        dp.tracer = tr
        tr.add(16)
        dp.process(v.make_packet_vector(
            [dict(src=f"172.16.0.{i + 1}", dst="10.1.1.2", proto=6,
                  sport=1000 + i, dport=80, rx_if=up) for i in range(6)]),
            now=5)
        texts.append(tr.format_trace())
    assert texts[0] == texts[1]
    assert "ml-score (score" in texts[1]
    assert "tenant-limit" in texts[1]


# --- on_if_freed, the swap's histograms and journal ----------------------

class Hist:
    """A histogram double: every observation with its labels."""

    def __init__(self):
        self.seen = []

    def observe(self, value, **labels):
        assert value >= 0
        self.seen.append(tuple(sorted(labels.items())))


def _swap_history(port: bool):
    """Three swaps on one package's dataplane with the three histograms
    and an in-memory journal: a route added under a KSR event's span, a
    local table (no FIB change), and one with nothing staged."""
    sp = tspans if port else jspans
    v = tvector if port else jvector
    cfg = (ttables if port else jtables).DataplaneConfig(sess_slots=256)
    dp = tdp.Dataplane(cfg, device="cpu") if port else jdp.Dataplane(cfg)
    hists = {k: Hist() for k in ("txn_commit_hist", "propagation_hist",
                                 "fib_churn_hist")}
    for k, h in hists.items():
        setattr(dp, k, h)
    dp.enable_journal(None)
    freed = []
    dp.on_if_freed.append(lambda idx: freed.append(
        (idx, dp._lock._is_owned())))
    a = dp.add_pod_interface(("default", "a"))
    with sp.RECORDER.span("ksr", "pod add"):
        dp.builder.add_route("10.1.1.2/32", a, v.Disposition.LOCAL)
        dp.swap()
    dp.alloc_table_slot("t")
    r = trule if port else jrule
    dp.builder.set_local_table(0, [r.ContivRule(action=r.Action.DENY)])
    dp.swap()
    dp.swap()
    assert dp.del_pod_interface(("default", "a"))
    assert not dp.del_pod_interface(("default", "a"))
    names = [s.name for s in sp.RECORDER.entries()[-4:]]
    return ({k: h.seen for k, h in hists.items()}, dp.journal.applied,
            dp.epoch, freed, names)


def test_swap_observes_histograms_and_journals_per_epoch():
    port, ref = _swap_history(True), _swap_history(False)
    assert port == ref
    hists, applied, epoch, freed, names = port
    assert len(hists["txn_commit_hist"]) == 3
    assert hists["propagation_hist"] == [(("source", "ksr"),)]
    assert len(hists["fib_churn_hist"]) == 1  # only the route swap
    assert (applied, epoch) == (2, 3)
    assert freed == [(1, False)]  # fired once, outside the lock
    assert names == ["epoch 1", "pod add", "epoch 2", "epoch 3"]


def test_on_if_freed_observers_fire_in_order():
    dp = tdp.Dataplane(ttables.DataplaneConfig(sess_slots=256),
                       device="cpu")
    calls = []
    dp.on_if_freed.extend([lambda i: calls.append(("a", i)),
                           lambda i: calls.append(("b", i))])
    idx = dp.add_pod_interface(("ns", "p"))
    dp.del_pod_interface(("ns", "p"))
    assert calls == [("a", idx), ("b", idx)]
    assert dp.add_pod_interface(("ns", "q")) == idx  # the slot is reused


# --- kernel_snapshot, time_classifier ------------------------------------

KNOBS = ([("classifier", k) for k in ("auto", "dense", "bv", "mxu",
                                      "pallas")]
         + [("fib_impl", k) for k in ("auto", "dense", "lpm", "pallas")]
         + [("session_impl", k) for k in ("auto", "gather", "pallas")])


def _snapshot(port: bool, knob: str, value: str) -> dict:
    tb, v = (ttables, tvector) if port else (jtables, jvector)
    cfg = tb.DataplaneConfig(sess_slots=256, max_global_rules=64,
                             fib_slots=64, **{knob: value})
    dp = tdp.Dataplane(cfg, device="cpu") if port else jdp.Dataplane(cfg)
    r = trule if port else jrule
    dp.builder.set_global_table([r.ContivRule(action=r.Action.DENY,
                                              protocol=r.Protocol.TCP,
                                              dest_port=23)])
    dp.builder.add_route("10.1.0.0/16", 1, v.Disposition.LOCAL)
    dp.swap()
    return dp.kernel_snapshot()


@pytest.mark.parametrize("knob,value", KNOBS)
def test_kernel_snapshot_matches_the_reference(knob, value):
    port, ref = _snapshot(True, knob, value), _snapshot(False, knob, value)
    assert port.keys() == ref.keys()
    assert port["backend"] == ref["backend"] == "cpu"
    assert port["pallas_available"] is False  # no card: the CPU rungs
    for op in ("classifier", "fib", "session"):
        assert port[op].keys() == ref[op].keys()
        assert (port[op]["impl"], port[op]["knob"]) == (
            ref[op]["impl"], ref[op]["knob"]), op
        assert port[op]["why"] in ("explicit knob", "ladder heuristic",
                                   "no cuda device (the kernel rung "
                                   "needs one)")


def test_time_classifier_sets_its_accumulators():
    dp = tdp.Dataplane(ttables.DataplaneConfig(sess_slots=256),
                       device="cpu")
    dp.add_uplink()
    assert dp.classify_ns_pkt is None and dp.classify_seconds == 0.0
    ns = dp.time_classifier(batch=64, iters=2)
    assert ns > 0 and dp.classify_ns_pkt == ns
    assert dp.classify_seconds > 0


# --- the pump's tracing path ---------------------------------------------

def _traced_pump(side: str, n_frames: int):
    dp, a, _b = forwarding_dp(side)
    tr = (ttracer if side == "port" else jtracer).PacketTracer(
        max_entries=4096)
    dp.tracer = tr
    tr.add(4096)
    rings = PKG[side][2].IORingPair(n_slots=32)
    push_frames(side, rings, a, n_frames, per=8)
    pump = PKG[side][2].DataplanePump(dp, rings, max_batch=VEC, chain_k=4)
    steps = []
    if side == "port":
        orig = dp.process_packed_chain

        def chained(*args, **kw):
            steps.append("chain")
            return orig(*args, **kw)

        dp.process_packed_chain = chained
    pump.start()
    try:
        got = drain(rings, n_frames)
    finally:
        assert pump.stop(join_timeout=30.0)
        rings.close()
    return got, dict(pump.stats), tr, steps


def test_pump_runs_unchained_while_a_tracer_is_armed():
    got, stats, tr, steps = _traced_pump("port", 12)
    ref_got, ref_stats, ref_tr, _ = _traced_pump("ref", 12)
    assert_same_frames(got, ref_got)
    assert stats["chain_batches"] == 0 and steps == []
    assert stats["frames"] == 12 and stats["pkts"] == 96
    assert len(tr.entries()) == 96
    # the same packets traced the same way (frame numbers count the
    # dispatches, which may coalesce differently)
    strip = [(e.slot, e.src, e.dst, e.sport, e.dport, e.path)
             for e in tr.entries()]
    assert sorted(strip) == sorted(
        (e.slot, e.src, e.dst, e.sport, e.dport, e.path)
        for e in ref_tr.entries())
