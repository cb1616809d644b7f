"""The device telemetry plane: vpp_tpu_torch vs vpp_tpu.

Op level, on the same NumPy-seeded inputs: ``tel_flow_hash`` (and its
host twin), ``sketch_cols`` for every row salt, ``lat_bucket`` on the
power-of-two edges (against the reference's device function and both
packages' host twins), ``tel_latency_update``, and ``tel_flow_update``
round by round over a Zipf flow mix whose first round forces top-K ties
(equal estimates among challengers, equal counts among slots): every
telemetry plane after every round must equal the reference's. The host
helpers (bucket bounds, quantiles, the approximate sum) are the
reference's.

Pipeline level, both packages' ``Dataplane`` with ``telemetry`` latency
/ full are driven in lockstep: ``process_packed`` with stamps that span
the bucket edges, an unstamped batch and a negative latency (the bins
also equal a NumPy recompute, as tests/test_telemetry.py checks),
``process_packed_chain`` with ``[K]`` stamps on both tiers and on the
forced full chain's K-step program, and ``process`` on both tiers for
the sketch. The bins survive a swap, ``latency`` sketches nothing, and
``telemetry_snapshot`` equals the reference's. The captured step's op
stream with ML and telemetry on holds no host read and is the same for
two stamps, two clocks and two batches. Every quantity is an integer:
the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ops import telemetry as jtel
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ops import telemetry as ttel
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

from test_ml_stage import proto_model
from test_telemetry import packed_frame, zipf_flows
from test_torch_capture import _host_reads, _record
from test_torch_ml import _CFG, Pair, _fwd, _permit_all, _replies
from test_torch_tables import assert_same, packet_pair

_TEL = tuple(ttables.TELEMETRY_FIELDS)


def rand_cols(rng, n):
    u = lambda: rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(  # noqa
        np.uint32)
    return dict(src_ip=u(), dst_ip=u(),
                proto=rng.integers(-300, 300, n).astype(np.int32),
                sport=rng.integers(-70000, 70000, n).astype(np.int32),
                dport=rng.integers(-70000, 70000, n).astype(np.int32),
                ttl=np.full(n, 64, np.int32), pkt_len=np.full(n, 64, np.int32),
                rx_if=np.ones(n, np.int32), flags=np.ones(n, np.int32))


def tel_tables(mode="full", **over):
    """Both packages' fresh tables with the telemetry planes of
    ``mode``."""
    kw = dict(_CFG, telemetry=mode, **over)
    jt = jtables.TableBuilder(jtables.DataplaneConfig(**kw)).to_device()
    tt = ttables.TableBuilder(ttables.DataplaneConfig(**kw),
                              device="cpu").to_device()
    return jt, tt


def assert_planes(jt, tt):
    for f in _TEL:
        assert_same(getattr(jt, f), getattr(tt, f), f)


# --- op level -------------------------------------------------------------


def test_flow_hash_matches_reference():
    rng = np.random.default_rng(3)
    cols = rand_cols(rng, 300)
    jpv, tpv = packet_pair(cols)
    want = jtel.tel_flow_hash(jpv)
    got = ttel.tel_flow_hash(tpv)
    assert got.dtype == torch.int32
    assert_same(want, got, "hash")
    args = [cols[k] for k in ("src_ip", "dst_ip", "sport", "dport",
                              "proto")]
    np.testing.assert_array_equal(ttel.tel_flow_hash_np(*args),
                                  jtel.tel_flow_hash_np(*args))
    np.testing.assert_array_equal(ttel.tel_flow_hash_np(*args),
                                  np.asarray(want))


@pytest.mark.parametrize("row", range(9))
def test_sketch_cols_match_reference(row):
    rng = np.random.default_rng(row)
    h0 = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    h0[:3] = (0, 0xFFFFFFFF, 0x80000000)
    for w in (1, 16, 1024, 1 << 16):
        want = jtel.sketch_cols(jnp.asarray(h0), row, w)
        got = ttel.sketch_cols(torch.from_numpy(h0.view(np.int32)), row, w)
        assert_same(want, got, f"row {row} w {w}")
        np.testing.assert_array_equal(ttel.sketch_cols(h0, row, w),
                                      jtel.sketch_cols(h0, row, w))


@pytest.mark.parametrize("nb", [4, 24, 31])
def test_lat_bucket_on_power_of_two_edges(nb):
    edges = [0, 1]
    for k in range(33):
        v = 1 << k
        edges += [v - 1, v, v + 1]
    lat = np.clip(np.asarray(edges, np.int64), 0, 0x7FFFFFFF).astype(
        np.int32)
    want = jtel.lat_bucket(jnp.asarray(lat), nb)
    got = ttel.lat_bucket(torch.from_numpy(lat), nb)
    assert_same(want, got, "bucket")
    np.testing.assert_array_equal(ttel.lat_bucket_np(lat, nb),
                                  jtel.lat_bucket_np(lat, nb))
    np.testing.assert_array_equal(got.numpy(), ttel.lat_bucket_np(lat, nb))
    assert got.numpy().max() == nb - 1 and got.numpy()[:2].tolist() == [0, 0]


def test_latency_update_matches_reference():
    jt, tt = tel_tables("latency")
    rng = np.random.default_rng(5)
    for _ in range(4):
        lat = rng.integers(-1000, 1 << 26, 64).astype(np.int32)
        observe = rng.random(64) < 0.7
        jt, jn = jtel.tel_latency_update(jt, jnp.asarray(observe),
                                         jnp.asarray(lat))
        tt, tn = ttel.tel_latency_update(tt, torch.from_numpy(observe),
                                         torch.from_numpy(lat))
        assert int(jn) == int(tn) == int(observe.sum())
        assert_planes(jt, tt)


def _zipf_batch(ids, base=0xC6120000):
    n = len(ids)
    cols = dict(src_ip=(base + ids).astype(np.uint32),
                dst_ip=np.full(n, 0x0A010109, np.uint32),
                proto=np.full(n, 6, np.int32),
                sport=(1024 + ids).astype(np.int32),
                dport=np.full(n, 8080, np.int32),
                ttl=np.full(n, 64, np.int32), pkt_len=np.full(n, 128, np.int32),
                rx_if=np.ones(n, np.int32), flags=np.ones(n, np.int32))
    return packet_pair(cols)


@pytest.mark.parametrize("rows,cols,k", [(2, 1024, 8), (3, 64, 4),
                                         (1, 16, 2)])
def test_flow_update_matches_reference_on_zipf_with_ties(rows, cols, k):
    jt, tt = tel_tables("full", telemetry_sketch_rows=rows,
                        telemetry_sketch_cols=cols, telemetry_topk=k)
    rng = np.random.default_rng(rows)
    # round 0: 2K distinct flows once each (every estimate ties, every
    # slot ties at 0; a narrow sketch also collides), then a Zipf mix
    draws = [np.arange(2 * k)] + zipf_flows(256, 1.3, 10, 64, seed=rows)
    for r, ids in enumerate(draws):
        jpv, tpv = _zipf_batch(ids)
        alive = rng.random(len(ids)) < 0.9
        jt, jn = jtel.tel_flow_update(jt, jpv, jnp.asarray(alive))
        tt, tn = ttel.tel_flow_update(tt, tpv, torch.from_numpy(alive))
        assert int(jn) == int(tn) == int(alive.sum())
        assert_planes(jt, tt)
    assert int((tt.tel_top_cnt > 0).sum()) == k


def test_host_helpers_match_reference():
    rng = np.random.default_rng(7)
    for nb in (4, 24, 31):
        assert ttel.bucket_bounds_seconds(nb) == \
            jtel.bucket_bounds_seconds(nb)
        for bins in (np.zeros(nb, np.int64), rng.integers(0, 50, nb)):
            assert ttel.quantiles_from_bins(bins) == \
                jtel.quantiles_from_bins(bins)
            assert ttel.approx_sum_us(bins) == jtel.approx_sum_us(bins)
    assert 0 <= ttel.tel_clock_us() <= 0x7FFFFFFF
    assert ttel.TEL_MODES == jtel.TEL_MODES


# --- pipeline level -------------------------------------------------------


def _tel_pair(mode, ml_stage="off", model=None, **over):
    return Pair(ml_stage, model, rules=[_permit_all], telemetry=mode,
                **over)


def _snap_equal(pair):
    js, ts = pair.j.telemetry_snapshot(), pair.t.telemetry_snapshot()
    assert set(js) == set(ts)
    for key in js:
        if isinstance(js[key], np.ndarray):
            assert js[key].dtype == ts[key].dtype, key
            np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
        else:
            assert ts[key] == js[key], key
    return ts


def _edge_stamps(now_us, nb):
    """(stamp, now_us) pairs whose latencies span the bucket edges: 0,
    1, 2, 3, 2^k - 1, 2^k, past the last bucket; an unstamped batch; a
    negative latency."""
    lats = [0, 1, 2, 3, 7, 8, 1023, 1024, (1 << (nb + 1)) + 5]
    out = [(now_us - lat, now_us) for lat in lats]
    return out + [(0, now_us), (now_us + 50, now_us)]


@pytest.mark.parametrize("mode", ["latency", "full"])
def test_packed_bins_match_reference_and_host_recompute(mode):
    pair = _tel_pair(mode)
    nb = ttables.tel_capacity(pair.t.config)[0]
    rng = np.random.default_rng(11)
    expect = np.zeros(nb, np.int64)
    sent = 0
    for i, (stamp, now_us) in enumerate(_edge_stamps(1 << 30, nb)):
        n_valid = int(rng.integers(1, 17))
        sent += n_valid
        flat = packed_frame(16, pair.up, sport=3000 + i, n_valid=n_valid)
        jo, ja = pair.j.process_packed(flat, now=i + 1, with_aux=True,
                                       stamp_us=stamp, now_us=now_us)
        to, ta = pair.t.process_packed(flat, now=i + 1, with_aux=True,
                                       stamp_us=stamp, now_us=now_us)
        assert_same(jo, to, "out")
        assert_same(ja, ta, "aux")
        lat = now_us - stamp
        observed = n_valid if stamp > 0 and lat >= 0 else 0
        assert int(ta[tdp.PACKED_AUX_SCHEMA.index("tel_observed")]) \
            == observed
        if observed:
            expect[ttel.lat_bucket_np(np.asarray([lat]), nb)[0]] += observed
        assert_planes(pair.j.tables, pair.t.tables)
    snap = _snap_equal(pair)
    np.testing.assert_array_equal(snap["bins"], expect)
    assert snap["sketched"] == (0 if mode == "latency" else sent)
    # a probe-like classify observes into copies only
    pair.t.process_packed(flat, now=40, commit=False, stamp_us=5,
                          now_us=10)
    np.testing.assert_array_equal(pair.t.telemetry_snapshot()["bins"],
                                  expect)


@pytest.mark.parametrize("fastpath", [True, False])
def test_chain_stamps_match_reference(fastpath):
    """K = 4 chained batches, each with its own stamp (one unstamped),
    through the auto path (the packed program K times: both tiers) or
    the forced full chain (one K-step program)."""
    pair = _tel_pair("full", fastpath=fastpath)
    fwd = [packed_frame(16, 1, sport=5000 + i, src=f"10.1.1.{2 + i}",
                        dst="172.16.0.9") for i in range(2)]
    r0 = pair.step(_fwd(4), now=1)
    assert int(r0.stats.tel_sketched) == 4
    rep = packed_frame(16, pair.up, sport=80, dport=5000, src="172.16.0.10",
                       dst="10.1.1.2", n_valid=1)
    flats = np.stack(fwd + [rep, fwd[0]])
    stamps = np.array([1000, 0, 1500, 1999], np.int32)
    jo, ja = pair.j.process_packed_chain(flats, now=2, with_aux=True,
                                         stamps_us=stamps, now_us=2000)
    to, ta = pair.t.process_packed_chain(flats, now=2, with_aux=True,
                                         stamps_us=stamps, now_us=2000)
    assert_same(jo, to, "outs")
    assert_same(ja, ta, "auxs")
    assert ta[:, tdp.PACKED_AUX_SCHEMA.index("tel_observed")].tolist() == \
        [16, 0, 1, 16]
    if fastpath:
        assert ta[:, 0].tolist() == [0, 0, 1, 0]
    assert_planes(pair.j.tables, pair.t.tables)
    _snap_equal(pair)
    # no stamps: nothing observed
    pair.t.process_packed_chain(flats, now=3)
    pair.j.process_packed_chain(flats, now=3)
    assert_planes(pair.j.tables, pair.t.tables)


def test_sketch_on_both_tiers_and_swap_carry():
    """``process`` feeds the sketch on the full chain and the fast tier
    alike; a swap carries every telemetry plane; the snapshot equals
    the reference's."""
    pair = _tel_pair("full")
    r1 = pair.step(_fwd(8), now=1)
    r2 = pair.step(_replies(8, pair.up), now=2)
    assert int(r2.stats.fastpath) == 1
    assert int(r1.stats.tel_sketched) == int(r2.stats.tel_sketched) == 8
    pair.j.process_packed(packed_frame(8, pair.up, sport=1), now=3,
                          stamp_us=10, now_us=20)
    pair.t.process_packed(packed_frame(8, pair.up, sport=1), now=3,
                          stamp_us=10, now_us=20)
    before = {f: getattr(pair.t.tables, f).clone() for f in _TEL}
    held = [getattr(pair.t.tables, f) for f in _TEL]
    for dp in (pair.j, pair.t):
        dp.builder.add_route("10.3.0.0/24", pair.up,
                             jvector.Disposition.REMOTE, node_id=1)
        dp.swap()
    for f, t in zip(_TEL, held):
        assert getattr(pair.t.tables, f) is t
        assert torch.equal(t, before[f]), f
    snap = _snap_equal(pair)
    assert snap["bins"].sum() == 8 and snap["sketched"] == 24
    pair.step(_replies(8, pair.up), now=4)
    _snap_equal(pair)


def test_latency_mode_sketches_nothing_and_off_has_no_snapshot():
    pair = _tel_pair("latency")
    res = pair.step(_fwd(4), now=1)
    assert int(res.stats.tel_sketched) == 0
    assert pair.t.telemetry_snapshot()["sketched"] == 0
    assert tuple(pair.t.tables.tel_sketch.shape) == (1, 1)
    off = tdp.Dataplane(ttables.DataplaneConfig(**_CFG), device="cpu")
    assert off.telemetry_snapshot() is None
    assert tuple(off.tables.tel_lat_hist.shape) == (1,)


@pytest.mark.parametrize("fast", [False, True])
def test_op_stream_with_ml_and_telemetry_bakes_in_nothing(fast):
    """The captured step's parts with the ML stage (enforce) and
    telemetry (full) on, and the packed boundary's latency observation:
    the same op stream for two clocks, two stamps and two batches, and
    no host read."""
    from vpp_tpu_torch.pipeline.graph import tel_observe

    pair = _tel_pair("full", "enforce", proto_model(action="drop"))
    t = pair.t
    t.process(tvector.make_packet_vector(_fwd(8), n=16), now=1)
    batches = [tvector.make_packet_vector(_replies(8, pair.up), n=16),
               tvector.make_packet_vector(_replies(8, pair.up, proto=17),
                                          n=16)]
    streams = []
    for pkts in batches:
        for now, stamp in ((6, 0), (4000, 12345)):
            scratch = t._scratch()
            now_t = torch.tensor(now, dtype=torch.int32)
            st = torch.tensor(stamp, dtype=torch.int32)
            us = torch.tensor(20000, dtype=torch.int32)
            if fast:
                step = t._get_step(True)
                pre = step.prefix(scratch, pkts, now_t)
                part = lambda: step.fast(scratch, pre, now_t)  # noqa
            else:
                step = t._get_step(False)
                part = lambda: step(scratch, pkts, now_t)  # noqa
            streams.append(_record(lambda: tel_observe(
                scratch, part(), st, us)))
    assert len(streams[0]) > 100
    for s in streams[1:]:
        assert s == streams[0]
    assert _host_reads(streams[0]) == []
