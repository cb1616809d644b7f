"""Session table parity: vpp_tpu_torch/ops/session.py + nat44 record vs
vpp_tpu's, and the session probe kernel's plain version vs the Pallas
kernel in interpret mode.

The same NumPy-seeded state and packets go through the JAX functions
and their ports: the 5-tuple hashes at addresses >= 128.0.0.0 and ports
>= 32768 (the uint32 scheme of pipeline/vector.py), reverse lookup
(gather and fused-probe rungs, fwd and sym hashing), hit age, touch,
the in-step sweep and the bulk expire, the batch insert election
(duplicate flows in one vector, full buckets evicting victims, expired
ways reclaimed, refreshes) and the NAT-session record with payload
conflicts. Every quantity is an integer: the tolerance is exact
equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ops import nat44 as jnat
from vpp_tpu.ops import session as jsess
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu_torch.ops import nat44 as tnat
from vpp_tpu_torch.ops import session as tsess

from test_pallas_kernels import _sess_case
from test_torch_tables import (
    assert_same,
    assert_tables_equal,
    packet_pair,
    torch_tables,
)

SESS_COLS = ("sess_src", "sess_dst", "sess_ports", "sess_proto",
             "sess_valid", "sess_time", "sess_sweep_cursor")
NAT_COLS = ("natsess_a", "natsess_b", "natsess_ports", "natsess_proto",
            "natsess_valid", "natsess_time", "natsess_orig_ip",
            "natsess_orig_port", "natsess_src_ip", "natsess_sport",
            "natsess_kind", "natsess_sweep_cursor")


def _base(sess_slots=64, nat_slots=32, ways=4, rng=None, t_hi=1000):
    """JAX tables of a small config with random session + NAT state
    (about half the ways valid, timestamps in [0, t_hi))."""
    cfg = jtables.DataplaneConfig(
        max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
        fib_slots=16, sess_slots=sess_slots, sess_ways=ways,
        natsess_slots=nat_slots, nat_mappings=2, nat_backends=4)
    jt = jtables.TableBuilder(cfg).to_device()
    if rng is None:
        return jt
    upd = {}
    for f, dt in jtables.SESSION_FIELDS.items():
        shape = np.shape(getattr(jt, f))
        if f.endswith("_sweep_cursor"):
            continue
        if f.endswith("_valid"):
            v = (rng.random(shape) < 0.5).astype(dt)
        elif f.endswith("_time"):
            v = rng.integers(0, t_hi, shape).astype(dt)
        elif f.endswith("_proto"):
            v = rng.choice([1, 6, 17], shape).astype(dt)
        elif f == "natsess_kind":
            v = rng.integers(1, 4, shape).astype(dt)
        else:
            v = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(dt)
        upd[f] = jnp.asarray(v)
    return jt._replace(**upd)


def _flows(rng, n, pool=None):
    """Packet columns of ``n`` flows (high addresses and ports); with
    ``pool`` the flows are drawn with repetition from that many."""
    k = pool or n
    base = dict(
        src_ip=rng.integers(2 ** 31, 2 ** 32, k, dtype=np.uint64),
        dst_ip=rng.integers(0, 2 ** 32, k, dtype=np.uint64),
        proto=rng.choice([1, 6, 17], k),
        sport=rng.integers(32768, 65536, k),
        dport=rng.choice([80, 443, 40000, 65535], k),
    )
    base["dst_ip"][: k // 8] = base["src_ip"][: k // 8]  # hairpins
    pick = rng.integers(0, k, n) if pool else np.arange(n)
    cols = {f: v[pick] for f, v in base.items()}
    cols["src_ip"] = cols["src_ip"].astype(np.uint32)
    cols["dst_ip"] = cols["dst_ip"].astype(np.uint32)
    cols.update(ttl=np.full(n, 64), pkt_len=np.full(n, 100),
                rx_if=np.zeros(n), flags=np.ones(n))
    return cols


def _reverse(cols):
    out = dict(cols)
    out["src_ip"], out["dst_ip"] = cols["dst_ip"], cols["src_ip"]
    out["sport"], out["dport"] = cols["dport"], cols["sport"]
    return out


def test_hash_mix_and_canon_mix_high_values():
    rng = np.random.default_rng(0)
    cols = _flows(rng, 512)
    cols["sport"][:64] = cols["dport"][:64]  # src == dst and port ties
    jp, tp = packet_pair(cols)
    jm = jsess._hash_mix(jp.src_ip, jp.dst_ip,
                         jsess._pack_ports(jp.sport, jp.dport), jp.proto)
    tm = tsess._hash_mix(tp.src_ip, tp.dst_ip,
                         tsess._pack_ports(tp.sport, tp.dport), tp.proto)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).astype(np.int64))
    jc = jsess.canon_mix(jp.src_ip, jp.dst_ip, jp.sport, jp.dport, jp.proto)
    tc = tsess.canon_mix(tp.src_ip, tp.dst_ip, tp.sport, tp.dport, tp.proto)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    # the reply's canon mix equals the forward one
    rp = packet_pair(_reverse(cols))[1]
    tr = tsess.canon_mix(rp.src_ip, rp.dst_ip, rp.sport, rp.dport, rp.proto)
    assert torch.equal(tr, tc)


@pytest.mark.parametrize("impl", ["gather", "pallas"])
@pytest.mark.parametrize("sym", [False, True])
def test_lookup_hit_age_touch(impl, sym):
    rng = np.random.default_rng(11 + sym)
    jt = _base(sess_slots=256, rng=rng)
    fwd = _flows(rng, 200, pool=150)
    jp, _ = packet_pair(fwd)
    jt, *_ = jsess.session_insert(jt, jp, jnp.ones(200, bool),
                                  jnp.int32(3500), sym=sym)
    tt = torch_tables(jt)
    rev = _reverse(fwd)
    junk = _flows(rng, 56)
    rev = {f: np.concatenate([rev[f], junk[f]]) for f in rev}
    jr, tr = packet_pair(rev)
    now = 4200  # the random-state entries (t < 1000) are expired
    jf, jidx = jsess.session_lookup_reverse_idx(jt, jr, jnp.int32(now),
                                                sym=sym)
    tf, tidx = tsess.session_lookup_reverse_idx(tt, tr, now, impl=impl,
                                                sym=sym)
    assert 0 < int(np.asarray(jf).sum()) < 256
    assert_same(jf, tf, "found")
    assert_same(jidx, tidx, "hit_idx")
    assert_same(jsess.session_hit_age(jt, jidx, jf, jnp.int32(now)),
                tsess.session_hit_age(tt, tidx, tf, now), "age")
    jt = jsess.session_touch(jt, jidx, jf, jnp.int32(now))
    tsess.session_touch(tt, tidx, tf, now)
    assert_tables_equal(jt, tt, SESS_COLS)
    # without `now` the (0, _BIG) no-age convention applies
    assert_same(jsess.session_lookup_reverse(jt, jr, sym=sym),
                tsess.session_lookup_reverse(tt, tr, impl=impl, sym=sym))
    assert tsess.sess_probe_ways.launches == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sym", [False, True])
def test_insert_election_pressure(seed, sym):
    """Duplicates in one vector, full buckets (victims), expired ways
    and a second batch that refreshes part of the first."""
    rng = np.random.default_rng(100 + seed)
    jt = _base(sess_slots=64, rng=rng, t_hi=3000)
    tt = torch_tables(jt)
    for now, n, pool in ((4000, 256, 90), (4500, 200, 120)):
        cols = _flows(rng, n, pool=pool)
        want = rng.random(n) < 0.85
        jp, tp = packet_pair(cols)
        jt, *jout = jsess.session_insert(jt, jp, jnp.asarray(want),
                                         jnp.int32(now), sym=sym)
        tt, *tout = tsess.session_insert(tt, tp, torch.from_numpy(want),
                                         now, sym=sym)
        for name, a, b in zip(("inserted", "failed", "evict_expired",
                               "evict_victim"), jout, tout):
            assert_same(a, b, name)
        assert_tables_equal(jt, tt, SESS_COLS)
    assert int(np.asarray(jout[3]).sum()) > 0  # victims were evicted


def test_nat_record_conflicts_and_reclaim():
    rng = np.random.default_rng(5)
    jt = _base(nat_slots=32, rng=rng, t_hi=3000)
    tt = torch_tables(jt)
    for now in (4000, 4100):
        n = 160
        cols = _flows(rng, n, pool=70)
        pay = [rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
               rng.integers(0, 65536, n).astype(np.int32),
               rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
               rng.integers(0, 65536, n).astype(np.int32),
               rng.integers(1, 4, n).astype(np.int32)]
        pay = [np.where(rng.random(n) < 0.8, p[0], p) for p in pay]
        want = rng.random(n) < 0.9
        jp, tp = packet_pair(cols)
        jpay = [jnp.asarray(p) for p in pay]
        tpay = [torch.from_numpy(p.view(np.int32) if p.dtype == np.uint32
                                 else p) for p in pay]
        jt, *jout = jnat.nat44_record(jt, jp, *jpay, jnp.asarray(want),
                                      jnp.int32(now))
        tt, *tout = tnat.nat44_record(tt, tp, *tpay,
                                      torch.from_numpy(want), now)
        for name, a, b in zip(("conflict", "failed", "evict_expired",
                               "evict_victim"), jout, tout):
            assert_same(a, b, name)
        assert_tables_equal(jt, tt, NAT_COLS)
    assert int(np.asarray(jout[0]).sum()) > 0  # conflicts occurred


def test_sweep_and_bulk_expire():
    rng = np.random.default_rng(9)
    jt = _base(sess_slots=256, nat_slots=128, rng=rng, t_hi=5000)
    tt = torch_tables(jt)
    for now, stride in ((6000, 16), (6500, 16), (9000, 64), (9000, 64)):
        jt = jsess.session_sweep(jt, jnp.int32(now), stride)
        tsess.session_sweep(tt, now, stride)
        assert_tables_equal(jt, tt, SESS_COLS + NAT_COLS)
    je = jsess.session_expire(jt, 7000, 1500)
    te = tsess.session_expire(tt, 7000, 1500)
    assert_tables_equal(je, te, ("sess_valid", "natsess_valid"))
    assert jsess.sweep_covered(10, 16, jt) == tsess.sweep_covered(10, 16, tt)


@pytest.mark.parametrize("ways", [1, 2, 4])
def test_probe_plain_vs_interpret_kernel(ways):
    """Planted hits, planted expired entries and random misses: the
    plain version equals the Pallas kernel (interpret mode) and the
    reference twin on both outputs."""
    args = _sess_case(ways, seed=17 + ways)
    now, max_age = 1000, 200
    targs = [torch.from_numpy(np.array(a).view(np.int32)
                              if np.asarray(a).dtype == np.uint32
                              else np.array(a)) for a in args]
    jf, jw = jsess.sess_probe_ways(*args, now, max_age, interpret=True)
    rf, rw = jsess._probe_ways_reference(*args, now, max_age)
    tf, tw = tsess.sess_probe_ways_plain(*targs, now, max_age)
    assert bool(np.asarray(jf).any())
    for ref in ((jf, jw), (rf, rw)):
        assert_same(ref[0], tf, "found")
        assert_same(ref[1], tw, "first")
    assert tsess.sess_probe_ways.launches == 0


def test_probe_all_miss_and_no_age_convention():
    args = _sess_case(4, seed=3, p=33, all_invalid=True)
    targs = [torch.from_numpy(np.array(a).view(np.int32)
                              if np.asarray(a).dtype == np.uint32
                              else np.array(a)) for a in args]
    tf, tw = tsess.sess_probe_ways_plain(*targs, 1000, 200)
    assert not bool(tf.any()) and int(tw.abs().sum()) == 0
    args = _sess_case(2, seed=9, p=65)
    targs = [torch.from_numpy(np.array(a).view(np.int32)
                              if np.asarray(a).dtype == np.uint32
                              else np.array(a)) for a in args]
    jf, jw = jsess.sess_probe_ways(*args, 0, jsess._BIG, interpret=True)
    tf, tw = tsess.sess_probe_ways_plain(*targs, 0, tsess._BIG)
    assert_same(jf, tf)
    assert_same(jw, tw)


# --- the fused lookup kernel: its NumPy model and its plain version -------

_U = np.uint32


def _np_mix(a, b, ports, proto):
    """csrc/sess_probe.cu ``hash_mix``: uint32 arithmetic, so every
    multiply wraps mod 2^32 (the Python splits the constants instead)."""
    with np.errstate(over="ignore"):
        h = ((a * _U(0x9E3779B1)) ^ (b * _U(0x85EBCA77))
             ^ (ports * _U(0xC2B2AE3D)) ^ (proto * _U(0x27D4EB2F)))
        h ^= h >> _U(15)
        h = h * _U(0x2545F491)
        h ^= h >> _U(13)
    return h


def _np_pack(hi, lo):
    return (hi.view(_U) << _U(16)) | lo.view(_U)


def _np_sess_kernel(hdr, cols, now, max_age, sym, vec4, tnt=None):
    """A NumPy model of csrc/sess_probe.cu, statement by statement:
    reversed key, the fwd / canon bucket (with ``tnt`` = (kt, base,
    mask) the key tenant's slice, base[kt] + (mix & mask[kt]) in
    uint32), the W-way compare (one bit mask and its lowest bit when
    ``vec4``, else the downward scan), and (found, slot = b * W +
    first)."""
    src, dst, proto, sport, dport = (np.asarray(c, np.int32) for c in hdr)
    s, d, pr = src.view(_U), dst.view(_U), proto.view(_U)
    ks, kd, kp = d, s, _np_pack(dport, sport)
    fwd = (not sym) | (s > d) | ((s == d) & (sport > dport))
    mix = np.where(fwd, _np_mix(ks, kd, kp, pr),
                   _np_mix(s, d, _np_pack(sport, dport), pr))
    valid, csrc, cdst, cports, cproto, ctime = (
        np.asarray(c, np.int32) for c in cols)
    nb, ways = valid.shape
    if tnt is None:
        b = (mix & _U(nb - 1)).astype(np.int64)
    else:
        kt, base, mask = (np.asarray(c, np.int32) for c in tnt)
        with np.errstate(over="ignore"):
            b = (base[kt].view(_U) + (mix & mask[kt].view(_U))).astype(
                np.int64)
    age = (_U(now & 0xFFFFFFFF) - ctime[b].view(_U)).view(np.int32)
    match = ((valid[b] == 1) & (csrc[b].view(_U) == ks[:, None])
             & (cdst[b].view(_U) == kd[:, None])
             & (cports[b].view(_U) == kp[:, None])
             & (cproto[b].view(_U) == pr[:, None]) & (age <= max_age))
    if vec4:
        hit = (match.astype(np.int64) << np.arange(ways)).sum(axis=1)
        low = hit & -hit  # __ffs
        first = np.where(hit != 0, np.log2(np.maximum(low, 1)).astype(
            np.int64), -1)
    else:
        first = np.full(len(b), -1)
        for w in range(ways - 1, -1, -1):
            first = np.where(match[:, w], w, first)
    slot = b.astype(np.int32) * ways + np.maximum(first, 0)
    return first >= 0, slot.astype(np.int32)


def test_kernel_hash_model_matches_mixes():
    """The kernel's uint32 hash (both branches of its sym select) equals
    the port's ``_hash_mix`` of the reversed key and its ``canon_mix``,
    and the reference's, at high addresses, address ties with
    sport > dport, and the extremes 0 / 2^32 - 1."""
    rng = np.random.default_rng(21)
    cols = _flows(rng, 512)
    cols["src_ip"][:8] = [0, 0xFFFFFFFF, 0x80000000, 1, 0xFFFFFFFF, 7, 7, 0]
    cols["dst_ip"][:8] = [0, 0xFFFFFFFF, 0x7FFFFFFF, 1, 0, 7, 7, 0xFFFFFFFF]
    cols["sport"][:8] = [65535, 1, 2, 80, 0, 443, 80, 3]
    cols["dport"][:8] = [1, 65535, 2, 443, 0, 80, 443, 3]
    cols["proto"][:8] = [255, 0, 6, 17, 1, 6, 6, 17]
    jp, tp = packet_pair(cols)
    hdr = tp.five_tuple
    s, d, pr = (c.numpy().view(_U) for c in (tp.src_ip, tp.dst_ip, tp.proto))
    sp, dp = tp.sport.numpy(), tp.dport.numpy()
    fwd_model = _np_mix(d, s, _np_pack(dp, sp), pr)
    keys = tsess._reverse_keys(*hdr)
    assert np.array_equal(fwd_model.astype(np.int64),
                          tsess._hash_mix(*keys).numpy())
    jkeys = (jp.dst_ip, jp.src_ip, jsess._pack_ports(jp.dport, jp.sport),
             jp.proto)
    np.testing.assert_array_equal(fwd_model,
                                  np.asarray(jsess._hash_mix(*jkeys)))
    swap = (s > d) | ((s == d) & (sp > dp))
    sym_model = np.where(swap, fwd_model, _np_mix(s, d, _np_pack(sp, dp), pr))
    assert np.array_equal(sym_model.astype(np.int64), tsess.canon_mix(
        tp.src_ip, tp.dst_ip, tp.sport, tp.dport, tp.proto).numpy())
    np.testing.assert_array_equal(sym_model, np.asarray(jsess.canon_mix(
        jp.src_ip, jp.dst_ip, jp.sport, jp.dport, jp.proto)))
    assert swap[:8].tolist() == [True, False, True, False, True, True,
                                 False, False]


@pytest.mark.parametrize("ways", [1, 2, 4, 16])
@pytest.mark.parametrize("sym", [False, True])
def test_lookup_plain_and_kernel_model_match_reference(ways, sym):
    """``sess_probe_ways`` on CPU tensors (its plain version) and the
    NumPy model of the kernel, on both of its load paths, against the
    reference's ``session_lookup_reverse_idx``: fwd and sym hashing,
    high addresses and ports, hairpins, live / expired / absent
    sessions; and the no-age convention against
    ``session_lookup_reverse``."""
    rng = np.random.default_rng(40 + ways + 7 * sym)
    jt = _base(sess_slots=16 * ways, ways=ways, rng=rng)
    fwd = _flows(rng, 150, pool=100)
    jp, _ = packet_pair(fwd)
    jt, *_ = jsess.session_insert(jt, jp, jnp.ones(150, bool),
                                  jnp.int32(3500), sym=sym)
    tt = torch_tables(jt)
    rev = _reverse(fwd)
    junk = _flows(rng, 50)
    rev = {f: np.concatenate([rev[f], junk[f]]) for f in rev}
    jr, tr = packet_pair(rev)
    hdr = tr.five_tuple
    cols = tsess._columns(tt)
    for now in (4200, 3600):  # the random-state entries are expired
        jf, jidx = jsess.session_lookup_reverse_idx(jt, jr, jnp.int32(now),
                                                    sym=sym)
        assert 0 < int(np.asarray(jf).sum()) < len(jf)
        tf, tidx = tsess.sess_probe_ways(*hdr, *cols, now, tt.sess_max_age,
                                         sym=sym)
        assert_same(jf, tf, "found")
        assert_same(jidx, tidx, "slot")
        for vec4 in (False, True):
            mf, mslot = _np_sess_kernel(
                hdr, [c.numpy() for c in cols], now,
                int(tt.sess_max_age), sym, vec4)
            np.testing.assert_array_equal(mf, np.asarray(jf))
            np.testing.assert_array_equal(mslot, np.asarray(jidx))
    jf = jsess.session_lookup_reverse(jt, jr, sym=sym)
    tf, _ = tsess.sess_probe_ways(*hdr, *cols, 0, tsess._BIG, sym=sym)
    assert_same(jf, tf, "found, no age")
    assert tsess.sess_probe_ways.launches == 0
