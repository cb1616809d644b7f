"""The IO pump: vpp_tpu_torch's DataplanePump vs vpp_tpu's, both modes.

The same seeded wire frames go into each package's ``IORingPair``, in
front of each package's ``Dataplane`` staged alike (the port's on the
CPU), and through each package's ``DataplanePump``. The tx ring contents
(every ring column of every frame: rewritten headers, disposition,
egress interface, next hop) must be equal, frame by frame and in order,
and so must the per-reason drop counters. The scenarios are those of
tests/test_io.py (a backlog coalesced in order, a resident ring serving
in order, a config swap restarting the ring without loss) and
tests/test_pump_overlap.py (a slow fetch, backpressure, chained against
overlapped, stop under load, repeated stop and start), plus the tx-stall
and fetch-error attribution, the port's twin of tests/test_snapshot.py
``test_sync_sessions_freshens_tables_for_snapshot`` (the graft lands in
the live tensors, moves no epoch and replaces no tensor) and the
ring-fault fallback.

Both sides take their clocks from the wall; nothing compared depends on
them (the session times are left out of the state comparisons). Every
wait has a deadline of at most 30 s. Every quantity compared is an
integer: the tolerance is exact equality.
"""

import threading
import time

import numpy as np
import pytest

from wire import make_frame

from vpp_tpu import io as jio
from vpp_tpu.ir.rule import Action, ContivRule, Protocol
from vpp_tpu.native import pktio as jpktio
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline.vector import Disposition
from vpp_tpu.testing import faults as jfaults
from vpp_tpu_torch import io as tio
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.native import pktio as tpktio
from vpp_tpu_torch.native.ring import RING_COLUMNS
from vpp_tpu_torch.pipeline import capture as tcap
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline.snapshot import SessionSnapshotter
from vpp_tpu_torch.testing import faults as tfaults

VEC = 256
CLIENT_IP = "10.1.1.2"
SERVER_IP = "10.1.1.3"
UNROUTED_IP = "10.2.0.9"
_CFG = dict(max_tables=2, max_rules=16, max_global_rules=32, max_ifaces=8,
            fib_slots=32, sess_slots=256, nat_mappings=4, nat_backends=4)
PKG = {"ref": (jdp, jtables, jio, jpktio, jfaults),
       "port": (tdp, ttables, tio, tpktio, tfaults)}
DEADLINE = 30.0


def forwarding_dp(side, **over):
    """tests/test_pump_overlap.py ``make_forwarding_dp``, with the small
    tables and a global table (deny TCP 23) on an uplink."""
    dp_mod, t_mod = PKG[side][:2]
    cfg = t_mod.DataplaneConfig(**dict(_CFG, **over))
    dp = dp_mod.Dataplane(cfg) if side == "ref" else dp_mod.Dataplane(
        cfg, device="cpu")
    dp.add_uplink()
    a = dp.add_pod_interface(("default", "a"))
    b = dp.add_pod_interface(("default", "b"))
    dp.builder.add_route(f"{CLIENT_IP}/32", a, Disposition.LOCAL)
    dp.builder.add_route(f"{SERVER_IP}/32", b, Disposition.LOCAL)
    m = (ContivRule, Action, Protocol) if side == "ref" else (
        trule.ContivRule, trule.Action, trule.Protocol)
    dp.builder.set_global_table([m[0](action=m[1].DENY,
                                      protocol=m[2].TCP, dest_port=23),
                                 m[0](action=m[1].PERMIT)])
    dp.swap()
    return dp, a, b


def push_frames(side, rings, rx_if, n_frames, per=8, k0=0):
    """``n_frames`` rx frames, frame k tagged sport=20000+k; every third
    packet goes to an unrouted address (a no-route drop), every fifth
    is TCP."""
    codec = PKG[side][3].PacketCodec(snap=rings.rx.snap)
    scratch = np.zeros((VEC, rings.rx.snap), np.uint8)
    for k in range(k0, k0 + n_frames):
        frames = [
            make_frame(CLIENT_IP,
                       UNROUTED_IP if j % 3 == 2 else SERVER_IP,
                       proto=6 if j % 5 == 4 else 17, sport=20000 + k,
                       dport=1000 + k * per + j)
            for j in range(per)]
        cols, n = codec.parse(frames, rx_if, scratch)
        assert rings.rx.push(cols, n, payload=scratch)


def drain(rings, want, timeout=DEADLINE):
    """Up to ``want`` tx frames: every ring column, the count, the
    epoch."""
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        f = rings.tx.peek()
        if f is None:
            time.sleep(0.002)
            continue
        got.append(({c: f.cols[c][:f.n].copy() for c, _ in RING_COLUMNS},
                    f.n, f.epoch))
        rings.tx.release()
    return got


def assert_same_frames(port, ref):
    assert len(port) == len(ref)
    for k, ((tc, tn, te), (jc, jn, je)) in enumerate(zip(port, ref)):
        assert (tn, te) == (jn, je), k
        for c, _dt in RING_COLUMNS:
            np.testing.assert_array_equal(tc[c], jc[c],
                                          err_msg=f"frame {k} {c}")


def drops(stats):
    return {k: stats[k] for k in tio.pump.PUMP_DROP_KEYS}


def run(side, n_frames, per=8, warm=True, dp_over=None, **pump_kw):
    """Push ``n_frames`` before the pump starts (so the coalesce groups
    are the same on both sides), run the pump until every frame left the
    tx ring, stop it. Returns (frames, stats, dp)."""
    dp, a, _b = forwarding_dp(side, **(dp_over or {}))
    rings = PKG[side][2].IORingPair(n_slots=32)
    push_frames(side, rings, a, n_frames, per)
    pump = PKG[side][2].DataplanePump(dp, rings, **pump_kw)
    if warm:
        pump.warm()
    pump.start()
    try:
        got = drain(rings, n_frames)
    finally:
        assert pump.stop(join_timeout=DEADLINE)
        rings.close()
    return got, dict(pump.stats), dp


def both(n_frames, per=8, **kw):
    port = run("port", n_frames, per, **kw)
    ref = run("ref", n_frames, per, **kw)
    assert_same_frames(port[0], ref[0])
    assert drops(port[1]) == drops(ref[1])
    return port, ref


def test_backlog_coalesced_in_order():
    """tests/test_io.py: a 16-frame backlog coalesces into batches,
    delivered per frame in order, equal to the reference's."""
    (got, s, _dp), _ref = both(16, max_batch=VEC)
    assert len(got) == 16
    for k, (cols, n, _e) in enumerate(got):
        assert n == 8 and (cols["sport"] == 20000 + k).all()
        assert list(cols["dport"]) == [1000 + k * 8 + j for j in range(8)]
    assert s["frames"] == 16 and s["pkts"] == 128
    assert s["max_coalesce"] > 1 and s["batches"] < 16
    assert s["io_callbacks"] == 0


def _live(dp):
    return tuple(getattr(dp.tables, f) for f in dp.tables._fields)


def test_resident_ring_serves_frames_in_order():
    """tests/test_io.py: the persistent ring serves small frames,
    compacted into shared descriptor slots, in order; at stop the ring's
    sessions are grafted into the dataplane's live tensors, with no
    epoch bump and no tensor replaced, equal to the reference's."""
    port = run("port", 6, per=4, mode="persistent")
    ref = run("ref", 6, per=4, mode="persistent")
    assert_same_frames(port[0], ref[0])
    assert drops(port[1]) == drops(ref[1])
    s, dp = port[1], port[2]
    assert s["frames"] == 6 and 1 <= s["batches"] <= 6
    assert s["io_callbacks"] == 0 and s["ring_windows"] >= 1
    assert dp.epoch == ref[2].epoch
    jt = ref[2].tables
    for f in ttables.SESSION_FIELDS:
        if f.endswith("_time"):
            continue  # the two wall clocks
        np.testing.assert_array_equal(
            ttables.numpy_of(f, getattr(dp.tables, f)),
            np.asarray(getattr(jt, f)).astype(
                ttables.numpy_of(f, getattr(dp.tables, f)).dtype),
            err_msg=f)
    assert int(dp.tables.sess_valid.sum()) > 0


def test_config_swap_restarts_the_ring_without_loss():
    """tests/test_io.py: a swap mid-traffic restarts the ring (sessions
    carried over) and traffic keeps flowing; the restart changes no
    shape and captures nothing."""
    out = {}
    for side in ("port", "ref"):
        dp, a, b = forwarding_dp(side)
        rings = PKG[side][2].IORingPair(n_slots=32)
        pump = PKG[side][2].DataplanePump(dp, rings, mode="persistent")
        pump.warm()
        pump.start()
        try:
            push_frames(side, rings, a, 1, per=4)
            got = drain(rings, 1)
            epoch0 = pump._persist_epoch
            budget = tcap.capture_budget(0) if side == "port" else None
            if budget is not None:
                budget.__enter__()
            dp.builder.add_route("10.9.9.9/32", b, Disposition.LOCAL)
            dp.swap()
            push_frames(side, rings, a, 1, per=4, k0=1)
            got += drain(rings, 1)
            assert pump._persist_epoch > epoch0
            if budget is not None:
                budget.__exit__(None, None, None)
        finally:
            assert pump.stop(join_timeout=DEADLINE)
            rings.close()
        assert [int(c["sport"][0]) for c, _n, _e in got] == [20000, 20001]
        out[side] = got
    assert_same_frames(out["port"], out["ref"])


def test_frames_after_a_swap_step_on_the_new_epoch():
    """A swap that lands after the persistent dispatch loop checked the
    epoch: the frame pushed after ``swap()`` returned is submitted to a
    ring of the new epoch (the loop is held right after its check until
    the frame is in). The reference's loop submits it to the old ring;
    its run of this order is what made
    ``test_config_swap_restarts_the_ring_without_loss`` fail under load."""
    dp, a, b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=32)
    pump = tio.DataplanePump(dp, rings, mode="persistent")
    pump.warm()
    pump.start()
    held, release = threading.Event(), threading.Event()
    tick = pump._governor_tick

    def hold_after_the_check():
        if not release.is_set():
            held.set()
            assert release.wait(DEADLINE)
        tick()

    try:
        push_frames("port", rings, a, 1, per=4)
        got = drain(rings, 1)
        epoch0 = pump._persist_epoch
        pump._governor_tick = hold_after_the_check
        assert held.wait(DEADLINE)   # past its epoch check, held
        dp.builder.add_route("10.9.9.9/32", b, Disposition.LOCAL)
        dp.swap()
        push_frames("port", rings, a, 1, per=4, k0=1)
        release.set()
        got += drain(rings, 1)
        assert pump._persist_epoch == dp.epoch > epoch0
    finally:
        release.set()
        assert pump.stop(join_timeout=DEADLINE)
        rings.close()
    assert [int(c["sport"][0]) for c, _n, _e in got] == [20000, 20001]


def test_in_order_loss_free_under_slow_fetch():
    """tests/test_pump_overlap.py: fetches that complete out of dispatch
    order across four workers still deliver every frame once, in order,
    equal to the reference's; the delay shows as fetch wait."""
    delay = lambda seq: (0.03, 0.01, 0.02)[seq % 3]  # noqa: E731
    (got, s, _dp), _ref = both(12, max_batch=VEC, fetch_workers=4,
                               max_inflight=4, fetch_delay=delay)
    assert [int(c["sport"][0]) for c, _n, _e in got] == \
        [20000 + k for k in range(12)]
    assert s["frames"] == 12 and s["batch_errors"] == 0
    assert s["t_fetch_wait"] > 0.0


def test_backpressure_engages_at_max_inflight():
    """tests/test_pump_overlap.py: with the fetches wedged, dispatch stops
    at the in-flight cap and leaves the rest of the backlog in the rx
    ring; every frame still leaves in order once the fetches resume."""
    dp, a, _b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=64)
    push_frames("port", rings, a, 40, per=64)
    pump = tio.DataplanePump(dp, rings, max_batch=VEC, fetch_workers=2,
                             max_inflight=3, fetch_delay=0.3)
    pump.warm()
    pump.start()
    try:
        time.sleep(0.6)
        assert pump.stats["inflight_peak"] <= 3 + 2 + 1
        assert pump.stats["inflight"] >= 1
        with pump._held_lock:
            held = len(pump._taken) + len(pump._done_rids)
        assert held < 40  # the backlog waits in the rx ring
        got = drain(rings, 40)
        assert [int(c["sport"][0]) for c, _n, _e in got] == \
            [20000 + k for k in range(40)]
    finally:
        assert pump.stop(join_timeout=DEADLINE)
        rings.close()


def test_chain_and_overlap_modes_identical_results():
    """tests/test_pump_overlap.py: a chained fold delivers the same
    frames as unchained dispatches in fewer device dispatches, and the
    chained pump equals the reference's chained pump."""
    plain = run("port", 24, per=64, max_batch=VEC, chain_k=0)
    (chained, s1, _dp), _ref = both(24, per=64, max_batch=VEC, chain_k=2)
    assert plain[1]["chain_batches"] == 0
    assert s1["chain_batches"] >= 1 and s1["chain_k_peak"] >= 2
    assert s1["batches"] < plain[1]["batches"]
    assert_same_frames(chained, plain[0])


def test_attributed_drops_match_the_reference():
    """A failed fetch (``pump.fetch``) and then a full tx ring: the
    frames leave or are dropped by cause, the same packets on both
    sides (``drops_error``, ``drops_tx_stall``). Three rounds of eight
    32-packet frames into 8-slot rings (the pump holds at most four rx
    frames, so a batch is four frames): the first batch's fetch fails,
    the rest fill the 8-slot tx ring, then the tx ring stalls."""
    out = {}
    for side in ("port", "ref"):
        fmod = PKG[side][4]
        dp, a, _b = forwarding_dp(side)
        rings = PKG[side][2].IORingPair(n_slots=8)
        pump = PKG[side][2].DataplanePump(dp, rings, max_batch=VEC,
                                          fetch_workers=1, max_inflight=1)
        pump.warm()
        fmod.install(fmod.FaultPlan(seed=3)).inject("pump.fetch", times=1)
        s = pump.stats
        try:
            # the first round waits in the rx ring before the start, so
            # the failed batch is its first four frames on both sides;
            # after it every frame is written in order until the tx
            # ring is full, whatever the later batches hold
            push_frames(side, rings, a, 8, per=32)
            pump.start()
            deadline = time.monotonic() + DEADLINE
            for r in range(3):
                if r:
                    push_frames(side, rings, a, 8, per=32, k0=8 * r)
                while (s["pkts"] + s["drops_error"] + s["drops_tx_stall"]
                       < 256 * (r + 1)):
                    assert time.monotonic() < deadline, dict(s)
                    time.sleep(0.005)
            got = drain(rings, 8, timeout=1.0)
        finally:
            assert pump.stop(join_timeout=DEADLINE)
            fmod.uninstall()
            rings.close()
        assert s["pkts"] + s["drops_error"] + s["drops_tx_stall"] == 768
        out[side] = (got, drops(s), s["pkts"])
    assert_same_frames(out["port"][0], out["ref"][0])
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][1]["drops_error"] == 128
    assert out["port"][1]["drops_tx_stall"] > 0


def test_stop_under_load_never_hangs():
    """tests/test_pump_overlap.py: stop while batches are in flight and
    the one fetch worker is slow — every thread joins, each cycle."""
    dp, a, _b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=64)
    try:
        for cycle in range(3):
            push_frames("port", rings, a, 12, per=64)
            pump = tio.DataplanePump(dp, rings, max_batch=VEC,
                                     fetch_workers=1, max_inflight=2,
                                     fetch_delay=0.05)
            if cycle == 0:
                pump.warm()
            pump.start()
            time.sleep(0.05 + cycle * 0.1)
            assert pump.stop(join_timeout=DEADLINE)
            while rings.tx.peek() is not None:
                rings.tx.release()
    finally:
        rings.close()


@pytest.mark.parametrize("seed_frames", [0, 10])
def test_persistent_stop_joins_cleanly_under_load(seed_frames):
    """tests/test_pump_overlap.py: stop with frames between the refill
    queue and the tx writer; every thread exits and every counted batch
    reached the writer."""
    dp, a, _b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=32)
    if seed_frames:
        push_frames("port", rings, a, seed_frames, per=4)
    pump = tio.DataplanePump(dp, rings, mode="persistent", max_inflight=4)
    pump.warm()
    pump.start()
    try:
        if seed_frames:
            deadline = time.monotonic() + DEADLINE
            while (pump.stats["frames"] == 0
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            assert pump.stats["frames"] > 0
        assert pump.stop(join_timeout=DEADLINE)
        assert (pump.stats["frames"] + pump.stats["batch_errors"]
                >= pump.stats["batches"] - pump.max_inflight)
    finally:
        rings.close()


def test_repeated_stop_start_cycles():
    dp, a, _b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=32)
    try:
        for cycle in range(2):
            push_frames("port", rings, a, 4, per=4, k0=4 * cycle)
            pump = tio.DataplanePump(dp, rings, mode="persistent")
            pump.warm()
            pump.start()
            assert len(drain(rings, 4)) == 4
            assert pump.stop(join_timeout=DEADLINE)
    finally:
        rings.close()
    # one ring program for the selection, checked out and back each time
    assert dp._ring is not None and not dp._ring[1].live


def test_sync_sessions_freshens_tables_for_snapshot(tmp_path):
    """tests/test_snapshot.py:391 on the port: the ring keeps its
    sessions privately; ``sync_sessions`` grafts them into the live
    tensors (no epoch bump, no tensor replaced) and a snapshot taken
    after it restores them into a fresh dataplane."""
    dp, a, _b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=32)
    pump = tio.DataplanePump(dp, rings, mode="persistent").start()
    try:
        codec = tpktio.PacketCodec(snap=rings.rx.snap)
        scratch = np.zeros((VEC, rings.rx.snap), np.uint8)
        frames = [make_frame(CLIENT_IP, SERVER_IP, proto=17,
                             sport=30000 + j, dport=40000 + j)
                  for j in range(8)]
        cols, nn = codec.parse(frames, a, scratch)
        assert rings.rx.push(cols, nn, payload=scratch)
        deadline = time.monotonic() + DEADLINE
        while pump.stats["pkts"] < 8:
            assert time.monotonic() < deadline, dict(pump.stats)
            time.sleep(0.01)
        assert int(dp.tables.sess_valid.sum()) == 0  # launch state
        live, epoch = _live(dp), dp.epoch
        assert pump.sync_sessions()
        assert int(dp.tables.sess_valid.sum()) == 8
        assert dp.epoch == epoch
        assert all(x is y for x, y in zip(_live(dp), live))
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        assert snap.snapshot() == 1
    finally:
        assert pump.stop(join_timeout=DEADLINE)
        rings.close()
    dp2, _, _ = forwarding_dp("port")
    assert SessionSnapshotter(dp2, str(tmp_path),
                              chunk_buckets=16).restore_into()
    assert int(dp2.tables.sess_valid.sum()) == 8


def test_ring_faults_fall_back_to_dispatch_mode():
    """``ring_fault_limit`` ring deaths under an injected
    ``ring.dispatch`` fault: the pump sets ``degraded_ring``, serves on
    through the dispatch ladder and accounts for every packet."""
    dp, a, _b = forwarding_dp("port")
    rings = tio.IORingPair(n_slots=32)
    tfaults.install(tfaults.FaultPlan(seed=5)).inject("ring.dispatch",
                                                      times=-1)
    pump = tio.DataplanePump(dp, rings, mode="persistent",
                             ring_fault_limit=2).start()
    pump._ring_backoff.base = pump._ring_backoff.cap = 0.01

    def accounted():
        s = pump.stats
        return (s["pkts"] + s["drops_error"] + s["drops_shutdown"]
                + s["drops_tx_stall"])

    try:
        offered, k = 0, 0
        deadline = time.monotonic() + DEADLINE
        while not pump.degraded_ring:
            assert time.monotonic() < deadline, "no fallback"
            push_frames("port", rings, a, 1, per=4, k0=k)
            offered += 4
            k += 1
            time.sleep(0.05)
        assert pump.mode == "dispatch"
        push_frames("port", rings, a, 4, per=4, k0=100)
        offered += 16
        while accounted() < offered:
            assert time.monotonic() < deadline, dict(pump.stats)
            time.sleep(0.01)
        assert pump.stop(join_timeout=DEADLINE)
        assert accounted() == offered and pump.stats["pkts"] > 0
        assert tfaults.active_plan().fired("ring.dispatch") >= 2
    finally:
        pump.stop(join_timeout=DEADLINE)
        tfaults.uninstall()
        rings.close()
