"""Session snapshots, restore and range migration: vpp_tpu_torch vs vpp_tpu.

The reference's ``tests/test_snapshot.py`` cases that need no pump,
collector, CLI or agent, run on the port (its own fault seams armed):
a restore is bit-identical with ages rebased, age semantics survive the
restart, a geometry mismatch refuses, clean chunks never re-ship, one
dirty bucket drains one chunk, a restarted snapshotter is incremental,
superseded chunk files are collected, a torn chunk or a torn manifest
leaves the previous generation restorable, a CRC failure, a garbage
manifest or a missing chunk refuse the whole restore, the fast tier
survives a restart bit-exact, and a cold start misses it.

Against the reference: the two packages' snapshot directories restore
into each other with equal session arrays, and on the same traffic
their chunk payloads and manifests are equal (but the wall time); the
digest equals the reference's on random columns with high bits set;
the three range functions give the reference's results.

Consistency: a hook in the chunk fetch steps the dataplane from another
thread between two chunks, and the restored table must be one step's
state (a drain of the live tensors fails this). A restore writes into
the live tensors: the step programs keep holding them. The repaired
fault: restored state missing a field raises the reference's
``ValueError``.

Every quantity is an integer: the tolerance is exact equality.
"""

from __future__ import annotations

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import snapshot as jsnap
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import snapshot as tsnap
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.pipeline.snapshot import (
    MANIFEST,
    TABLE_COLS,
    SessionSnapshotter,
    adopt_bucket_range,
    drain_bucket_range,
    release_bucket_range,
)
from vpp_tpu_torch.pipeline.transfer import transfer_budget
from vpp_tpu_torch.testing import faults

from test_snapshot import build_dp as build_ref_dp
from test_snapshot import forward_pkts as ref_forward
from test_snapshot import reply_pkts as ref_reply


def _cfg(**over):
    base = dict(
        max_tables=2, max_rules=16, max_global_rules=16, max_ifaces=8,
        fib_slots=16, sess_slots=256, sess_ways=4, nat_mappings=2,
        nat_backends=2, sess_sweep_stride=0,
    )
    base.update(over)
    return ttables.DataplaneConfig(**base)


def build_dp(**over):
    """The reference test's dataplane, on the port (CPU)."""
    dp = tdp.Dataplane(_cfg(**over), device="cpu")
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "web"))
    dp.builder.add_route("10.1.1.0/24", pod, tvector.Disposition.LOCAL)
    dp.builder.add_route("0.0.0.0/0", up, tvector.Disposition.REMOTE,
                         node_id=1)
    dp.builder.set_global_table([
        ContivRule(action=Action.PERMIT, protocol=Protocol.TCP),
        ContivRule(action=Action.DENY),
    ])
    dp.swap()
    return dp, up, pod


def _port_pv(jpv):
    return tvector.packet_vector_from_numpy(
        {f: np.asarray(getattr(jpv, f)) for f in jvector.PacketVector._fields},
        "cpu")


def forward_pkts(n, base=0, rx_if=1):
    return _port_pv(ref_forward(n, base, rx_if))


def reply_pkts(n, base=0, rx_if=2):
    return _port_pv(ref_reply(n, base, rx_if))


def live_count(dp) -> int:
    return int(dp.tables.sess_valid.sum())


def sessions_of(dp) -> dict:
    """Every session field of either package's live tables, numpy in
    the reference's dtype."""
    out = {}
    for f, dt in ttables.SESSION_FIELDS.items():
        a = getattr(dp.tables, f)
        a = a.numpy().copy() if torch.is_tensor(a) else np.asarray(a)
        out[f] = a.view(np.uint32) if dt == np.uint32 else a.astype(dt)
    return out


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


# --- the reference's cases, on the port ----------------------------------


class TestRoundtrip:
    def test_restore_is_bit_identical_with_rebased_ages(self, tmp_path):
        dp, up, pod = build_dp()
        dp.process(forward_pkts(40, rx_if=up), now=50)
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        assert snap.snapshot() == 1
        with open(os.path.join(str(tmp_path), MANIFEST)) as f:
            snap_now = json.load(f)["now"]
        dp2, _, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert snap2.restore_into()
        assert snap2.stats_snapshot()["restore_outcome"] == "restored"
        assert live_count(dp2) == live_count(dp) == 40
        for fields in TABLE_COLS.values():
            for f in fields:
                a = getattr(dp.tables, f).numpy()
                b = getattr(dp2.tables, f).numpy()
                if f.endswith("_time"):
                    valid = getattr(dp.tables,
                                    f.replace("_time", "_valid")).numpy()
                    assert np.array_equal(
                        (a.astype(np.int64) - snap_now)[valid == 1],
                        b.astype(np.int64)[valid == 1]), f
                else:
                    assert np.array_equal(a, b), f
        assert int(dp2.tables.sess_sweep_cursor) == int(
            dp.tables.sess_sweep_cursor)

    def test_age_semantics_survive_the_restart(self, tmp_path):
        dp, up, pod = build_dp()
        dp.process(forward_pkts(8, rx_if=up), now=10)
        old_now = 10 + dp.config.sess_max_age - 100
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        dp._now = old_now
        assert snap.snapshot() == 1
        dp2, up2, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert snap2.restore_into()
        r = dp2.process(reply_pkts(8), now=50)
        assert int(r.stats.sess_hits) == 8
        r2 = dp2.process(reply_pkts(8), now=50 + 3000 + 100)
        assert int(r2.stats.sess_hits) == 0

    def test_restore_refuses_geometry_mismatch(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(4, rx_if=up), now=5)
        SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16).snapshot()
        dp2, _, _ = build_dp(sess_slots=512)
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert not snap2.restore_into()
        s = snap2.stats_snapshot()
        assert s["restore_outcome"] == "geometry"
        assert s["restores"]["geometry"] == 1
        assert live_count(dp2) == 0


class TestIncremental:
    def test_clean_chunks_never_reship(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(30, rx_if=up), now=5)
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        snap.snapshot()
        first = snap.stats_snapshot()["chunks_written"]
        assert first > 0
        with transfer_budget(0) as tb:
            snap.snapshot()
        assert tb.moved() == {}
        s = snap.stats_snapshot()
        assert s["chunks_written"] == first
        assert s["chunks_skipped"] == first

    def test_one_dirty_bucket_drains_one_chunk(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(30, rx_if=up), now=5)
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        snap.snapshot()
        before = snap.stats_snapshot()["chunks_written"]
        dp.process(forward_pkts(1, base=7000, rx_if=up), now=6)
        with transfer_budget(6 * 16 * 4 * 4) as tb:
            snap.snapshot()
        assert tb.moved() == {"snapshot.drain": 6 * 16 * 4 * 4}
        assert snap.stats_snapshot()["chunks_written"] == before + 1

    def test_incremental_survives_process_restart(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(30, rx_if=up), now=5)
        SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16).snapshot()
        snap2 = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        assert snap2.stats_snapshot()["generation"] == 1
        assert snap2.snapshot() == 2
        s = snap2.stats_snapshot()
        assert s["chunks_written"] == 0
        assert s["chunks_skipped"] > 0

    def test_gc_drops_superseded_chunk_files(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(30, rx_if=up), now=5)
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        snap.snapshot()
        dp.process(forward_pkts(30, base=5000, rx_if=up), now=6)
        snap.snapshot()
        with open(os.path.join(str(tmp_path), MANIFEST)) as f:
            m = json.load(f)
        live = {e["file"] for t in m["tables"].values()
                for e in t["chunks"]}
        on_disk = {os.path.basename(p) for p in
                   glob.glob(os.path.join(str(tmp_path), "*.chunk"))}
        assert on_disk == live


class TestTornSnapshots:
    def test_torn_trailing_chunk_restores_previous_generation(
            self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(30, rx_if=up), now=5)
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        assert snap.snapshot() == 1
        baseline = dp.tables.sess_src.clone()
        dp.process(forward_pkts(30, base=5000, rx_if=up), now=6)
        faults.install(faults.FaultPlan(seed=1)).inject(
            "snapshot.chunk", after=1, times=1)
        assert snap.snapshot() is None
        faults.uninstall()
        assert snap.degraded
        s = snap.stats_snapshot()
        assert s["generation"] == 1
        assert s["consecutive_failures"] == 1
        dp2, _, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert snap2.restore_into()
        assert live_count(dp2) == 30
        assert torch.equal(dp2.tables.sess_src, baseline)
        assert snap.snapshot() == 2
        assert not snap.degraded

    def test_torn_manifest_publish_keeps_previous_generation(
            self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(20, rx_if=up), now=5)
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        assert snap.snapshot() == 1
        dp.process(forward_pkts(20, base=4000, rx_if=up), now=6)
        faults.install(faults.FaultPlan(seed=2)).inject(
            "snapshot.manifest")
        assert snap.snapshot() is None
        faults.uninstall()
        dp2, _, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert snap2.restore_into()
        assert live_count(dp2) == 20

    def test_crc_corruption_refuses_cleanly_cold_start(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(30, rx_if=up), now=5)
        SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16).snapshot()
        with open(os.path.join(str(tmp_path), MANIFEST)) as f:
            m = json.load(f)
        victim = m["tables"]["sess"]["chunks"][1]["file"]
        with open(os.path.join(str(tmp_path), victim), "r+b") as f:
            f.seek(200)
            f.write(b"\xff\xff\xff\xff")
        dp2, _, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert not snap2.restore_into()
        assert snap2.stats_snapshot()["restore_outcome"] == "crc_mismatch"
        assert live_count(dp2) == 0

    def test_garbage_manifest_refuses_cleanly(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(5, rx_if=up), now=5)
        SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16).snapshot()
        with open(os.path.join(str(tmp_path), MANIFEST), "w") as f:
            f.write('{"version": 1, "genera')
        dp2, _, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert not snap2.restore_into()
        assert snap2.stats_snapshot()["restore_outcome"] == "bad_manifest"
        assert live_count(dp2) == 0

    def test_missing_chunk_refuses_cleanly(self, tmp_path):
        dp, up, _ = build_dp()
        dp.process(forward_pkts(5, rx_if=up), now=5)
        SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16).snapshot()
        with open(os.path.join(str(tmp_path), MANIFEST)) as f:
            m = json.load(f)
        os.unlink(os.path.join(
            str(tmp_path), m["tables"]["sess"]["chunks"][0]["file"]))
        dp2, _, _ = build_dp()
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert not snap2.restore_into()
        assert snap2.stats_snapshot()["restore_outcome"] == "missing_chunk"


class TestWarmRestartE2E:
    def test_fastpath_survives_restart_bit_exact(self, tmp_path):
        n = 60
        dp, up, pod = build_dp(sess_slots=2048)
        dp.process(forward_pkts(n, rx_if=up), now=1000)
        dp.process(forward_pkts(12, base=9000, rx_if=up), now=2)
        snap_now = 3500
        dp._now = snap_now
        snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
        assert snap.snapshot() == 1
        snapshotted = live_count(dp)
        assert snapshotted == n + 12
        dp2, up2, pod2 = build_dp(sess_slots=2048)
        snap2 = SessionSnapshotter(dp2, str(tmp_path), chunk_buckets=16)
        assert snap2.restore_into()
        restored_flagged = live_count(dp2)
        expired = dp2.expire_sessions()
        assert restored_flagged == snapshotted
        assert live_count(dp2) + expired == snapshotted
        assert expired == 12
        for batch, base in ((0, 0), (1, 20), (2, 40)):
            pv = reply_pkts(20, base=base)
            ref = dp.process(pv, now=snap_now + 1 + batch)
            got = dp2.process(pv, now=1 + batch)
            hits = int(got.stats.sess_hits)
            rx = int(got.stats.rx)
            assert rx == 20
            assert hits / rx >= 0.9, f"post-restore hit rate {hits}/{rx}"
            assert int(got.stats.fastpath) == 1
            for f in ("disp", "tx_if", "next_hop", "drop_cause"):
                assert torch.equal(getattr(ref, f), getattr(got, f)), f
            for f in pv._fields:
                assert torch.equal(getattr(ref.pkts, f),
                                   getattr(got.pkts, f)), f

    def test_cold_start_without_snapshot_misses_fastpath(self, tmp_path):
        dp, up, pod = build_dp()
        dp.process(forward_pkts(20, rx_if=up), now=5)
        dp2, _, _ = build_dp()
        r = dp2.process(reply_pkts(20), now=6)
        assert int(r.stats.sess_hits) == 0
        assert int(r.stats.fastpath) == 0


# --- the restore writes into the live tensors ----------------------------


def test_restore_keeps_the_programs_and_zeroes_the_state_planes(tmp_path):
    """``restore_into`` writes each session column into the live tensor
    (the step programs keep holding them, none is rebuilt), zeroes the
    telemetry, tenancy and ECMP planes in place and bumps the epoch."""
    dp, up, _ = build_dp(telemetry="full", tenancy="on")
    dp.process(forward_pkts(30, rx_if=up), now=5)
    SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16).snapshot()
    dp2, up2, _ = build_dp(telemetry="full", tenancy="on")
    dp2.process(forward_pkts(10, base=600, rx_if=up2), now=5)
    progs = dict(dp2._programs)
    held = {f: getattr(dp2.tables, f) for f in ttables.TABLE_FIELDS}
    epoch = dp2.epoch
    assert int(dp2.tables.tel_sketched) > 0
    assert SessionSnapshotter(dp2, str(tmp_path),
                              chunk_buckets=16).restore_into()
    assert dp2.epoch == epoch + 1
    assert dp2._programs == progs
    assert all(p.holds(dp2.tables) for p in progs.values())
    for f, t in held.items():
        assert getattr(dp2.tables, f) is t, f
    assert live_count(dp2) == 30
    for f in (tuple(ttables.TELEMETRY_FIELDS)
              + tuple(ttables.TENANCY_STATE_FIELDS) + ("fib_ecmp_c",)):
        assert int(getattr(dp2.tables, f).abs().sum()) == 0, f
    r = dp2.process(reply_pkts(30), now=6)
    assert int(r.stats.sess_hits) == 30


@pytest.mark.parametrize("how", ["to_device", "adopt_sessions"])
def test_missing_field_raises_the_reference_error(how):
    """The repaired fault: restored state that lacks a field raises the
    reference's ValueError (the port raised KeyError)."""
    cfg = _cfg()
    state = {f: np.zeros(s, ttables.SESSION_FIELDS[f])
             for f, s in ttables.state_shapes(cfg).items()
             if f in ttables.SESSION_FIELDS and f != "natsess_kind"}
    with pytest.raises(ValueError) as want:
        jtables.TableBuilder(jtables.DataplaneConfig(
            **cfg._asdict())).to_device(sessions=state)
    with pytest.raises(ValueError) as got:
        if how == "to_device":
            ttables.TableBuilder(cfg, device="cpu").to_device(
                sessions=state)
        else:
            tdp.Dataplane(cfg, device="cpu").adopt_sessions(state)
    assert str(got.value) == str(want.value)
    assert "missing fields: ['natsess_kind']" in str(got.value)


# --- consistency: one step's state, whatever steps run mid-drain ---------


def test_snapshot_is_one_steps_state_under_concurrent_steps(
        tmp_path, monkeypatch):
    """Between the first and the second chunk fetch another thread
    steps the dataplane (new flows in every chunk). The restored table
    must equal the state before that step exactly (the drain reads the
    clone taken under the lock), and the step must have changed the
    live table. A drain of the live tensors restores chunk 0 from before
    the step and the others from after it: this test fails then."""
    dp, up, _ = build_dp(sess_slots=256)
    dp.process(forward_pkts(30, rx_if=up), now=5)
    before = sessions_of(dp)
    orig = tsnap._fetch_fn
    calls = []

    def fetch_fn(cb):
        inner = orig(cb)

        def fetch(cols, start):
            calls.append(start)
            if len(calls) == 2:
                th = threading.Thread(target=lambda: dp.process(
                    forward_pkts(60, base=3000, rx_if=up), now=6))
                th.start()
                th.join(timeout=120)
                assert not th.is_alive()
            return inner(cols, start)
        return fetch

    monkeypatch.setattr(tsnap, "_fetch_fn", fetch_fn)
    snap = SessionSnapshotter(dp, str(tmp_path), chunk_buckets=16)
    assert snap.snapshot() == 1
    monkeypatch.setattr(tsnap, "_fetch_fn", orig)
    after = sessions_of(dp)
    assert len(calls) > 2
    assert live_count(dp) > 30
    sessions, outcome = SessionSnapshotter(
        build_dp()[0], str(tmp_path), chunk_buckets=16).restore()
    assert outcome == "restored"
    with open(os.path.join(str(tmp_path), MANIFEST)) as f:
        snap_now = json.load(f)["now"]
    for f in ("sess_time", "natsess_time"):
        sessions[f] = (sessions[f].astype(np.int64) + snap_now).astype(
            np.int32)
    for f in ttables.SESSION_FIELDS:
        assert np.array_equal(sessions[f], before[f]), f
    assert any(not np.array_equal(before[f], after[f])
               for f in TABLE_COLS["sess"])


# --- against the reference -------------------------------------------------


def _pair(tmp_path, n=40, **over):
    """The reference's dataplane and the port's, the same traffic
    through both, their clocks pinned (the snapshot and range clock is
    ``max(dp._now, clock_ticks())``)."""
    jd, jup, _ = build_ref_dp(**over)
    td, tup, _ = build_dp(**over)
    assert (jup, tup) == (1, 1)
    jd.process(ref_forward(n, rx_if=jup), now=50)
    td.process(forward_pkts(n, rx_if=tup), now=50)
    jd.process(ref_forward(n // 2, base=4000, rx_if=jup), now=60)
    td.process(forward_pkts(n // 2, base=4000, rx_if=tup), now=60)
    for dp in (jd, td):
        dp._now = 1 << 20
    return jd, td


def test_chunks_and_manifests_equal_the_references(tmp_path):
    jd, td = _pair(tmp_path)
    for f, a in sessions_of(jd).items():
        assert np.array_equal(sessions_of(td)[f], a), f
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    assert jsnap.SessionSnapshotter(jd, str(jdir), 16).snapshot() == 1
    assert SessionSnapshotter(td, str(tdir), 16).snapshot() == 1
    jm = json.loads((jdir / MANIFEST).read_text())
    tm = json.loads((tdir / MANIFEST).read_text())
    jm.pop("t_wall")
    tm.pop("t_wall")
    assert tm == jm
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        if name != MANIFEST:  # compared above, but the wall time
            assert (jdir / name).read_bytes() == \
                (tdir / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_restore_across_packages(tmp_path, writer):
    """A directory written by one package restores into the other with
    equal session arrays (ages rebased alike)."""
    jd, td = _pair(tmp_path)
    src = jd if writer == "reference" else td
    mod = jsnap if writer == "reference" else tsnap
    assert mod.SessionSnapshotter(src, str(tmp_path), 16).snapshot() == 1
    jd2, _, _ = build_ref_dp()
    td2, _, _ = build_dp()
    assert jsnap.SessionSnapshotter(jd2, str(tmp_path), 16).restore_into()
    assert SessionSnapshotter(td2, str(tmp_path), 16).restore_into()
    want, got = sessions_of(jd2), sessions_of(td2)
    for f in ttables.SESSION_FIELDS:
        assert np.array_equal(got[f], want[f]), f
    assert live_count(td2) == 60


@pytest.mark.parametrize("cb", [1, 4, 16])
def test_digest_equals_the_references(cb):
    rng = np.random.default_rng(cb)
    cols_np = [rng.integers(0, 2 ** 32, (64, 4), dtype=np.uint64).astype(
        np.uint32) for _ in range(6)]
    cols_np[3] |= np.uint32(0x80000000)
    cols_np[5] = np.full((64, 4), 0xFFFFFFFF, np.uint32)
    import jax.numpy as jnp

    want = np.asarray(jsnap._digest_fn(cb)(
        tuple(jnp.asarray(c) for c in cols_np)))
    got = tsnap._digest_fn(cb)(
        tuple(torch.from_numpy(c.view(np.int32)) for c in cols_np))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_range_functions_equal_the_references(tmp_path):
    """drain -> adopt -> release on both packages, the same traffic and
    clocks: the drained rows, the adopted and the released tables and
    the counts are equal."""
    jd, td = _pair(tmp_path, sess_slots=1024)
    jdst, _, _ = build_ref_dp(sess_slots=1024)
    tdst, _, _ = build_dp(sess_slots=1024)
    for dp in (jdst, tdst):
        dp._now = (1 << 20) + 500
    jcols, jnow = jsnap.drain_bucket_range(jd, 64, 128, chunk_buckets=32)
    with transfer_budget(6 * 128 * 4 * 4) as tb:
        tcols, tnow = drain_bucket_range(td, 64, 128, chunk_buckets=32)
    assert tb.moved() == {"migrate.drain": 6 * 128 * 4 * 4}
    assert tnow == jnow
    for f in TABLE_COLS["sess"]:
        assert np.array_equal(tcols[f], jcols[f]), f
    assert int(tcols["sess_valid"].sum()) > 0
    ja = jsnap.adopt_bucket_range(jdst, jcols, 64, jnow)
    ta = adopt_bucket_range(tdst, tcols, 64, tnow)
    assert ta == ja > 0
    jr = jsnap.release_bucket_range(jd, 64, 128)
    tr = release_bucket_range(td, 64, 128)
    assert tr == jr == ta
    for a, b in ((jdst, tdst), (jd, td)):
        want, got = sessions_of(a), sessions_of(b)
        for f in ttables.SESSION_FIELDS:
            assert np.array_equal(got[f], want[f]), f


def test_range_drain_reads_the_rows_asked_for():
    """An unaligned tail range ([44, 64) of 64 buckets in chunks of 16)
    drains exactly the live rows. (The reference's chunk slice clamps
    its start into the table, so its last chunk there holds rows 48..51
    in place of 60..63: ROADMAP.md records the difference.)"""
    dp, up, _ = build_dp()
    dp.process(forward_pkts(60, rx_if=up), now=5)
    cols, _ = drain_bucket_range(dp, 44, 20, chunk_buckets=16)
    live = sessions_of(dp)
    for f in TABLE_COLS["sess"]:
        assert np.array_equal(cols[f], live[f][44:]), f
    jd, jup, _ = build_ref_dp()
    jd.process(ref_forward(60, rx_if=jup), now=5)
    jcols, _ = jsnap.drain_bucket_range(jd, 44, 20, chunk_buckets=16)
    jlive = sessions_of(jd)
    assert np.array_equal(jcols["sess_src"][:16], jlive["sess_src"][44:60])
    assert np.array_equal(jcols["sess_src"][16:], jlive["sess_src"][48:52])


def test_range_drain_arms_the_migrate_seam():
    dp, up, _ = build_dp()
    dp.process(forward_pkts(20, rx_if=up), now=5)
    plan = faults.install(faults.FaultPlan(seed=4))
    plan.inject("fleet.migrate", after=1)
    with pytest.raises(faults.FaultInjected):
        drain_bucket_range(dp, 0, 64, chunk_buckets=16)
    assert plan.calls("fleet.migrate") == 2
