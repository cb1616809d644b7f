"""Tenancy: vpp_tpu_torch/tenancy/ and the tenant forms vs vpp_tpu's.

The same NumPy-seeded inputs go through the reference's tenancy
functions and their ports:

* derivation (``addr_tenant``, ``key_tenant``, ``tenant_ids``,
  ``vni_tenant``), the token bucket (``tenant_limit``, over seeded
  multi-window traffic and at the int32 bounds of
  tests/test_tenancy.py ``test_refill_no_int32_overflow_at_bounds``, also
  against that file's sequential oracle), ``tnt_account`` and
  ``tenant_occupancy``;
* the builder's ``_restage_tenants`` array for array, and
  ``validate_tenancy_config``'s refusals with the same messages;
* the tenant-sliced session and NAT paths (``session_lookup_reverse_idx``
  / ``session_insert`` / ``nat44_record`` / ``nat44_reverse`` with
  ``tnt=True``), the tenant form of the ``sess_probe_ways`` plain
  version and of the NumPy model of its kernel, and the per-tenant ML
  policy (``ml_policy(tid=...)``, ``ml_stage_plain``, the NumPy model of
  csrc/ml_score.cu);
* whole steps through both ``Dataplane``s: quota drops, the
  unconfigured-tenancy identity, slices a flood cannot evict from,
  replies landing in their slice, per-tenant ML modes against one model,
  bucket state carried across swaps, a ``set_tenant_ml`` swap that
  captures nothing, tokens spent once a step on the auto path, and
  ``probe`` / ``process_packed(commit=False)`` moving no tenancy plane.

Every quantity is an integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir import rule as jrule
from vpp_tpu.ops import mlscore as jml
from vpp_tpu.ops import nat44 as jnat
from vpp_tpu.ops import session as jsess
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu.tenancy import derive as jder
from vpp_tpu.tenancy import sched as jsched
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ops import mlscore as tml
from vpp_tpu_torch.ops import nat44 as tnat
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.pipeline import capture as tcap
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import graph as tgraph
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.tenancy import derive as tder
from vpp_tpu_torch.tenancy import sched as tsched

from test_ml_stage import proto_model
from test_tenancy import bucket_oracle
from test_torch_ml import kernel_model, rand_cols, rand_planes, rand_session
from test_torch_session import _flows, _np_sess_kernel, _reverse
from test_torch_tables import (
    assert_same,
    packet_pair,
    torch_packets,
    torch_tables,
)

T1_NET, T2_NET, T3_NET, T4_NET = ("10.50.0.0/16", "10.60.0.0/16",
                                  "10.70.0.0/16", "10.80.0.0/16")
_TNT_PLANES = ("tnt_tokens", "tnt_tok_time", "tnt_rx_c", "tnt_tx_c",
               "tnt_rl_c", "tnt_qf_c")
_CFG = dict(max_tables=2, max_rules=16, max_global_rules=32, max_ifaces=8,
            fib_slots=16, sess_slots=256, nat_mappings=2, nat_backends=2,
            tenancy="on", sess_sweep_stride=0)
TENANTS = (
    {"id": 1, "prefixes": ["10.50.7.0/24", T1_NET], "rate": 3, "burst": 8,
     "sess_buckets": 4, "vni": 100},
    {"id": 2, "prefixes": [T2_NET], "rate": 1, "burst": 2,
     "nat_buckets": 8, "ml_mode": "score"},
    {"id": 3, "prefixes": [T3_NET, "192.168.0.0/24"], "sess_buckets": 8,
     "nat_buckets": 4, "ml_thresh": 5},
    {"id": 7, "prefixes": [T4_NET], "vni": 700, "ml_mode": "off"},
)


def _both_builders(tenants=TENANTS, **over):
    kw = dict(_CFG, **over)
    jb = jtables.TableBuilder(jtables.DataplaneConfig(**kw))
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    for b in (jb, tb):
        for e in tenants:
            b.set_tenant(e["id"], **{k: v for k, v in e.items()
                                     if k != "id"})
    return jb, tb


def _addresses(rng, n):
    """Addresses inside each tenant's prefixes, outside all, and at the
    uint32 extremes."""
    nets = [0x0A320000, 0x0A320700, 0x0A3C0000, 0x0A460000, 0x0A500000,
            0xC0A80000, 0xAC100000]
    base = np.array(nets, np.uint32)[rng.integers(0, len(nets), n)]
    out = base | rng.integers(0, 1 << 16, n).astype(np.uint32)
    out[:4] = [0, 0xFFFFFFFF, 0x0A500001, 0xC0A800FF]
    return out


# --- derivation ----------------------------------------------------------


def test_derivation_matches_reference():
    """First match wins (same-tenant nesting), unmatched is tenant 0,
    and the pair tenant is the max, symmetric under a swap."""
    jb, tb = _both_builders()
    jt, tt = jb.to_device(), tb.to_device()
    rng = np.random.default_rng(3)
    a, b = _addresses(rng, 300), _addresses(rng, 300)
    ja, jbb = jnp.asarray(a), jnp.asarray(b)
    ta = torch.from_numpy(a.view(np.int32))
    tb_ = torch.from_numpy(b.view(np.int32))
    assert_same(jder.addr_tenant(jt, ja), tder.addr_tenant(tt, ta), "addr")
    kt = tder.key_tenant(tt, ta, tb_)
    assert_same(jder.key_tenant(jt, ja, jbb), kt, "key")
    assert torch.equal(kt, tder.key_tenant(tt, tb_, ta))
    assert set(kt.tolist()) >= {0, 1, 2, 3, 7}
    cols = rand_cols(rng, 64)
    cols["src_ip"], cols["dst_ip"] = a[:64], b[:64]
    jp, tp = packet_pair(cols)
    assert_same(jder.tenant_ids(jt, jp), tder.tenant_ids(tt, tp), "ids")


def test_vni_tenant_matches_reference():
    """Tenants' VNIs name them; unknown, negative and (tenancy on) the
    default VNI are not known; with tenancy off slot 0 admits the
    default VNI."""
    for over in ({}, {"tenancy": "off"}):
        jb, tb = _both_builders(() if over else TENANTS, **over)
        jt, tt = jb.to_device(), tb.to_device()
        vni = np.array([100, 700, 999, -1, 10, 0, 100, 700], np.int32)
        jtid, jknown = jder.vni_tenant(jt, jnp.asarray(vni))
        ttid, tknown = tder.vni_tenant(tt, torch.from_numpy(vni))
        assert_same(jtid, ttid, "tid")
        assert_same(jknown, tknown, "known")
        assert bool(tknown[4]) == bool(over)


# --- the token bucket ----------------------------------------------------


def test_tenant_limit_matches_reference_and_oracle():
    """Seeded traffic over 3 tenants x 6 windows with varying gaps (one
    past the refill clamp): the dropped mask and the bucket planes equal
    the reference's and tests/test_tenancy.py's sequential oracle."""
    jb, tb = _both_builders()
    jt, tt = jb.to_device(), tb.to_device()
    rng = np.random.default_rng(11)
    now = 5
    for w, gap in enumerate((0, 1, 2, 7, 40000, 1)):
        now += gap
        tids = rng.choice([0, 1, 2, 3, 7], 48).astype(np.int32)
        alive = rng.random(48) < 0.85
        want = bucket_oracle(np.asarray(jt.tnt_rate),
                             np.asarray(jt.tnt_burst),
                             np.asarray(jt.tnt_tokens),
                             np.asarray(jt.tnt_tok_time), tids, alive, now)
        jt, jdrop = jder.tenant_limit(jt, jnp.asarray(tids),
                                      jnp.asarray(alive), jnp.int32(now))
        tdrop = tder.tenant_limit(tt, torch.from_numpy(tids),
                                  torch.from_numpy(alive),
                                  torch.tensor(now, dtype=torch.int32))
        assert_same(jdrop, tdrop, f"window {w} dropped")
        np.testing.assert_array_equal(tdrop.numpy(), want[0])
        for f in ("tnt_tokens", "tnt_tok_time"):
            assert_same(getattr(jt, f), getattr(tt, f), f"window {w} {f}")
        np.testing.assert_array_equal(tt.tnt_tokens.numpy(), want[1])
    assert int(tt.tnt_rl_c.sum()) == 0  # the limit counts nothing itself


def test_refill_no_int32_overflow_at_bounds():
    """rate 2^16 and burst 2^30 (the validator's bounds) with idle gaps
    at the clamp: the naive refill sum reaches 2^31; the capped one
    keeps a full bucket at burst and admits in-quota traffic, as the
    reference's does."""
    tenants = ({"id": 1, "prefixes": [T1_NET], "rate": 1 << 16,
                "burst": 1 << 30},)
    jb, tb = _both_builders(tenants)
    jt, tt = jb.to_device(), tb.to_device()
    z_t, z_a = np.zeros(16, np.int32), np.zeros(16, bool)
    jt, _ = jder.tenant_limit(jt, jnp.asarray(z_t), jnp.asarray(z_a),
                              jnp.int32(1 << 14))
    tder.tenant_limit(tt, torch.from_numpy(z_t), torch.from_numpy(z_a),
                      1 << 14)
    assert int(tt.tnt_tokens[1]) == 1 << 30
    tids = np.array([1] * 8 + [0] * 8, np.int32)
    alive = np.ones(16, bool)
    jt, jdrop = jder.tenant_limit(jt, jnp.asarray(tids), jnp.asarray(alive),
                                  jnp.int32(2 << 14))
    tdrop = tder.tenant_limit(tt, torch.from_numpy(tids),
                              torch.from_numpy(alive), 2 << 14)
    assert not tdrop.any()
    assert_same(jdrop, tdrop, "dropped")
    assert int(tt.tnt_tokens[1]) == (1 << 30) - 8
    for f in ("tnt_tokens", "tnt_tok_time"):
        assert_same(getattr(jt, f), getattr(tt, f), f)


def test_account_and_occupancy_match_reference():
    jb, tb = _both_builders()
    jt = jb.to_device()
    rng = np.random.default_rng(5)
    nb, ways = np.shape(jt.sess_valid)
    jt = jt._replace(
        sess_valid=jnp.asarray((rng.random((nb, ways)) < 0.6)
                               .astype(np.int32)),
        sess_time=jnp.asarray(rng.integers(0, 4000, (nb, ways))
                              .astype(np.int32)))
    tt = torch_tables(jt)
    for k in range(3):
        masks = [rng.random(64) < p for p in (0.9, 0.6, 0.2, 0.1)]
        tids = rng.choice([0, 1, 2, 3, 7], 64).astype(np.int32)
        jt = jder.tnt_account(jt, jnp.asarray(tids),
                              *(jnp.asarray(m) for m in masks))
        tder.tnt_account(tt, torch.from_numpy(tids),
                         *(torch.from_numpy(m) for m in masks))
    for f in ("tnt_rx_c", "tnt_tx_c", "tnt_rl_c", "tnt_qf_c"):
        assert_same(getattr(jt, f), getattr(tt, f), f)
    for now, max_age in ((3000, 3000), (4500, 1000), (100, 50)):
        want = jder.tenant_occupancy(jt.sess_valid, jt.sess_time,
                                     jnp.int32(now), jnp.int32(max_age),
                                     jt.tnt_sess_base, jt.tnt_sess_mask + 1)
        got = tder.tenant_occupancy(tt.sess_valid, tt.sess_time,
                                    torch.tensor(now, dtype=torch.int32),
                                    max_age, tt.tnt_sess_base,
                                    tt.tnt_sess_mask + 1)
        assert_same(want, got, f"occupancy now={now}")


# --- staging and validation ---------------------------------------------


@pytest.mark.parametrize("case", ["none", "mixed", "tenant0-sliced",
                                  "nat-only", "off"])
def test_restage_tenants_matches_reference(case):
    """The tenant planes, array for array: slices from the top down in
    tenant order, the unsliced residual's power of two, ML modes and
    thresholds, VNIs; and the carried state planes' shapes."""
    tenants = {
        "none": (), "mixed": TENANTS, "off": (),
        "tenant0-sliced": ({"id": 0, "sess_buckets": 32, "nat_buckets": 32},
                           {"id": 1, "prefixes": [T1_NET],
                            "sess_buckets": 32, "nat_buckets": 16}),
        "nat-only": ({"id": 5, "prefixes": [T2_NET], "nat_buckets": 16},),
    }[case]
    jb, tb = _both_builders(tenants, **(
        {"tenancy": "off"} if case == "off" else {}))
    jh, th = jb.host_arrays(), tb.host_arrays()
    for f in jb.tnt:
        np.testing.assert_array_equal(th[f], jh[f], err_msg=f)
        assert th[f].dtype == jh[f].dtype, f
    assert tb.tenants == jb.tenants
    jt, tt = jb.to_device(), tb.to_device()
    for f in _TNT_PLANES:
        assert_same(getattr(jt, f), getattr(tt, f), f)


@pytest.mark.parametrize("entries,frag", [
    ([{"id": 1}, {"id": 1}], "duplicate"),
    ([{"id": 99}], "outside"),
    ([{"id": 1, "prefixes": ["not-a-net"]}], ""),
    ([{"id": 1, "prefixes": ["fd00::/8"]}], "IPv4"),
    ([{"id": 1, "rate": (1 << 16) + 1}], "rate"),
    ([{"id": 1, "burst": (1 << 30) + 1}], "burst"),
    ([{"id": 1, "rate": 5}], "burst"),
    ([{"id": 1, "sess_buckets": 3}], "power of two"),
    ([{"id": 1, "sess_buckets": 128}], "exceeds"),
    ([{"id": 1, "sess_buckets": 32}, {"id": 2, "sess_buckets": 64}],
     "oversubscribed"),
    ([{"id": 1, "prefixes": ["10.0.0.0/8"]},
      {"id": 2, "prefixes": ["10.60.0.0/16"]}], "overlap"),
    ([{"id": 1, "sess_buckets": 64}], "residual"),
    ([{"id": 1, "nat_buckets": 64}], "residual"),
    ([{"id": 1, "weight": 0}], "weight"),
    ([{"id": 1, "ml_mode": "bogus"}], "ml_mode"),
    ([{"id": 1, "nonsense_key": 1}], "unknown"),
    ([{"name": "anonymous"}], "missing"),
])
def test_validation_refusals_match_reference(entries, frag):
    """tests/test_tenancy.py's refusals, with the reference's exception
    type and message."""
    kw = dict(_CFG, max_rules=8, max_global_rules=8, max_ifaces=4)
    with pytest.raises(Exception) as jerr:
        jsched.validate_tenancy_config(jtables.DataplaneConfig(**kw),
                                       entries)
    with pytest.raises(type(jerr.value)) as terr:
        tsched.validate_tenancy_config(ttables.DataplaneConfig(**kw),
                                       entries)
    assert str(terr.value) == str(jerr.value)
    assert frag.lower() in str(terr.value).lower()


def test_validation_acceptances_match_reference():
    """Full slicing with tenant 0 sliced; the normalised entries (the
    defaults filled in) are the reference's; a prefix map larger than
    the device plane is refused at validation."""
    kw = dict(_CFG, max_rules=8, max_global_rules=8, max_ifaces=4)
    entries = [{"id": 0, "sess_buckets": 32},
               {"id": 1, "prefixes": [T1_NET], "sess_buckets": 32,
                "weight": 3, "vni": 5}]
    got = tsched.validate_tenancy_config(ttables.DataplaneConfig(**kw),
                                         entries)
    assert got == jsched.validate_tenancy_config(
        jtables.DataplaneConfig(**kw), entries)
    assert tsched.ML_MODE_CODES == jsched.ML_MODE_CODES
    assert (tsched.MAX_RATE, tsched.MAX_BURST) == (jsched.MAX_RATE,
                                                    jsched.MAX_BURST)
    with pytest.raises(ValueError, match="slots"):
        tsched.validate_tenancy_config(
            ttables.DataplaneConfig(**dict(kw, tenancy_prefixes=2)),
            [{"id": 1, "prefixes": [T1_NET, "10.51.0.0/16",
                                    "10.52.0.0/16"]}])


def test_builder_refusals_leave_staging_intact():
    """``set_tenant`` needs tenancy on; an oversubscribing tenant and an
    unknown tenant's ML flip are refused before anything is staged."""
    b = ttables.TableBuilder(ttables.DataplaneConfig(
        **dict(_CFG, tenancy="off")), device="cpu")
    with pytest.raises(ValueError, match="tenancy"):
        b.set_tenant(1, prefixes=[T1_NET])
    _, b = _both_builders(({"id": 1, "prefixes": [T1_NET],
                            "sess_buckets": 32},))
    before = {k: v.copy() for k, v in b.tnt.items()}
    with pytest.raises(ValueError, match="oversubscribed"):
        b.set_tenant(2, prefixes=[T2_NET], sess_buckets=64)
    with pytest.raises(ValueError, match="not registered"):
        b.set_tenant_ml(4, ml_mode="score")
    for k, v in b.tnt.items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert set(b.tenants) == {1}
    b.set_tenant_ml(1, ml_mode="enforce", ml_thresh=-3)
    assert (int(b.tnt["glb_ml_tnt_mode"][1]),
            int(b.tnt["glb_ml_tnt_thresh"][1])) == (3, -3)
    b.clear_tenants()
    assert b.tenants == {} and int(b.tnt["tnt_pfx_id"].max()) == -1


# --- the tenant-sliced session and NAT paths ----------------------------


def _sliced_state(ways=4, seed=0):
    """Reference tables with TENANTS staged (sliced and unsliced tenants)
    and random session / NAT columns, and flows whose addresses fall in
    every tenant and in none."""
    rng = np.random.default_rng(seed)
    jb, _ = _both_builders(sess_slots=64 * ways, sess_ways=ways)
    jt = jb.to_device()
    upd = {}
    for f, dt in jtables.SESSION_FIELDS.items():
        shape = np.shape(getattr(jt, f))
        if f.endswith("_sweep_cursor"):
            continue
        v = (rng.random(shape) < 0.5 if f.endswith("_valid")
             else rng.integers(0, 1000, shape) if f.endswith("_time")
             else rng.integers(1, 4, shape) if f == "natsess_kind"
             else rng.integers(0, 2 ** 32, shape, dtype=np.uint64))
        upd[f] = jnp.asarray(np.asarray(v).astype(dt))
    jt = jt._replace(**upd)
    fwd = _flows(rng, 160, pool=120)
    fwd["src_ip"] = _addresses(rng, 160)
    fwd["dst_ip"][::3] = _addresses(rng, 160)[::3]
    return jt, fwd, rng


@pytest.mark.parametrize("ways", [1, 2, 4, 16])
@pytest.mark.parametrize("sym", [False, True])
def test_sliced_session_paths_match_reference(ways, sym):
    """Insert into the key tenant's slice, then the replies' lookup (the
    gather rung and the fused probe's plain version), the batch summary,
    the no-age lookup and the NumPy model of the kernel's tenant form on
    both load paths: each against the reference's ``tnt=True`` form."""
    jt, fwd, rng = _sliced_state(ways, seed=ways + 10 * sym)
    jp, tp = packet_pair(fwd)
    want = np.ones(160, bool)
    tt = torch_tables(jt)
    jt, *jout = jsess.session_insert(jt, jp, jnp.asarray(want),
                                     jnp.int32(3500), tnt=True, sym=sym)
    tout = tsess.session_insert(tt, tp, torch.from_numpy(want), 3500,
                                tnt=True, sym=sym)[1:]
    for w, g, what in zip(jout, tout, ("inserted", "failed", "exp", "vic")):
        assert_same(w, g, what)
    for f in ("sess_valid", "sess_src", "sess_time"):
        assert_same(getattr(jt, f), getattr(tt, f), f)
    rev = _reverse(fwd)
    junk = _flows(rng, 40)
    rev = {f: np.concatenate([rev[f], junk[f]]) for f in rev}
    jr, tr = packet_pair(rev)
    jf, jidx = jsess.session_lookup_reverse_idx(jt, jr, jnp.int32(3600),
                                                tnt=True, sym=sym)
    assert 0 < int(np.asarray(jf).sum()) < 200
    kt = tder.key_tenant(tt, tr.dst_ip, tr.src_ip)
    assert {0, 1, 3} <= set(kt.tolist())
    tnt = (kt, tt.tnt_sess_base, tt.tnt_sess_mask)
    for impl in ("gather", "pallas"):
        tf, tidx = tsess.session_lookup_reverse_idx(tt, tr, 3600, tnt=True,
                                                    impl=impl, sym=sym)
        assert_same(jf, tf, f"{impl} found")
        assert_same(jidx, tidx, f"{impl} slot")
    for vec4 in (False, True):
        mf, mslot = _np_sess_kernel(
            tr.five_tuple, [c.numpy() for c in tsess._columns(tt)], 3600,
            int(tt.sess_max_age), sym, vec4, tnt=[x.numpy() for x in tnt])
        np.testing.assert_array_equal(mf, np.asarray(jf))
        np.testing.assert_array_equal(mslot, np.asarray(jidx))
    alive = rng.random(200) < 0.9
    jh, jhi, jall = jsess.session_batch_summary(
        jt, jr, jnp.asarray(alive), jnp.int32(3600), tnt=True, sym=sym)
    th, thi, tall = tsess.session_batch_summary(
        tt, tr, torch.from_numpy(alive), 3600, tnt=True, impl="pallas",
        sym=sym)
    for w, g in ((jh, th), (jhi, thi), (jall, tall)):
        assert_same(w, g, "summary")
    assert_same(jsess.session_lookup_reverse(jt, jr, tnt=True, sym=sym),
                tsess.session_lookup_reverse(tt, tr, tnt=True, sym=sym),
                "no-age found")
    assert tsess.sess_probe_ways.launches == 0


def test_unsliced_default_staging_is_the_unsliced_bucket():
    """Tenancy on with nothing registered: ``tenant_bucket`` is the
    unsliced bucket, key for key (the identity the reference pins)."""
    jb, tb = _both_builders(())
    tt = tb.to_device()
    rng = np.random.default_rng(2)
    cols = _flows(rng, 200)
    _, tp = packet_pair(cols)
    mix = tsess._hash_mix(tp.src_ip, tp.dst_ip,
                          tsess._pack_ports(tp.sport, tp.dport), tp.proto)
    got = tsess.tenant_bucket(tt, tp.src_ip, tp.dst_ip, mix,
                              tt.tnt_sess_base, tt.tnt_sess_mask)
    assert torch.equal(got, tsess._bucket(mix, tt.sess_valid.shape[0]))


def test_sliced_nat_paths_match_reference():
    """The NAT record lands in the reply key's tenant slice and the
    reply's reverse finds it there, as in the reference."""
    jt, fwd, rng = _sliced_state(4, seed=31)
    jp, tp = packet_pair(fwd)
    tt = torch_tables(jt)
    n = len(fwd["src_ip"])
    o_dst = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    o_dport = rng.integers(1, 65536, n).astype(np.int32)
    kind = rng.integers(1, 4, n).astype(np.int32)
    want = rng.random(n) < 0.8
    jt, *jout = jnat.nat44_record(
        jt, jp, jnp.asarray(o_dst), jnp.asarray(o_dport), jp.src_ip,
        jp.sport, jnp.asarray(kind), jnp.asarray(want), jnp.int32(2000),
        tnt=True)
    tout = tnat.nat44_record(
        tt, tp, torch.from_numpy(o_dst.view(np.int32)),
        torch.from_numpy(o_dport), tp.src_ip, tp.sport,
        torch.from_numpy(kind), torch.from_numpy(want), 2000, tnt=True)[1:]
    for w, g, what in zip(jout, tout, ("conflict", "failed", "exp", "vic")):
        assert_same(w, g, what)
    for f in ("natsess_valid", "natsess_a", "natsess_orig_ip"):
        assert_same(getattr(jt, f), getattr(tt, f), f)
    jr, tr = packet_pair(_reverse(fwd))
    alive = np.ones(n, bool)
    jpk, japp, jidx = jnat.nat44_reverse(jt, jr, jnp.asarray(alive),
                                         jnp.int32(2100), tnt=True)
    tpk, tapp, tidx = tnat.nat44_reverse(tt, tr, torch.from_numpy(alive),
                                         2100, tnt=True)
    assert int(np.asarray(japp).sum()) > 0
    assert_same(japp, tapp, "applied")
    assert_same(jidx, tidx, "hit_idx")
    for f in jvector.PacketVector._fields:
        assert_same(getattr(jpk, f), getattr(tpk, f), f)


# --- the per-tenant ML policy -------------------------------------------


def _ml_tables(tenants, **over):
    kw = dict(_CFG, ml_stage="enforce", ml_hidden=4, **over)
    jb = jtables.TableBuilder(jtables.DataplaneConfig(**kw))
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    for b in (jb, tb):
        b.set_ml_model(proto_model(flag_thresh=10, action="drop").to_dict())
        for e in tenants:
            b.set_tenant(e["id"], **{k: v for k, v in e.items()
                                     if k != "id"})
    return jb.to_device(), tb.to_device()


_ML_TENANTS = ({"id": 1, "ml_mode": "off"},
               {"id": 2, "ml_mode": "score"},
               {"id": 3, "ml_mode": "enforce", "ml_thresh": 2},
               {"id": 4, "ml_thresh": (1 << 31) - 1},
               {"id": 5, "ml_mode": "score", "ml_thresh": -(1 << 31) + 1},
               {"id": 7, "ml_mode": "enforce"})


@pytest.mark.parametrize("action", ["mark", "drop", "ratelimit"])
def test_ml_policy_tid_matches_reference(action):
    """Each mode (inherit, off, score, enforce), the inherit sentinel
    and a tenant threshold override, tid at 0 and T - 1: the port's
    policy, its stage's plain version and the NumPy model of the
    kernel's tenant form, against the reference's ``ml_policy``."""
    jt, tt = _ml_tables(_ML_TENANTS)
    rng = np.random.default_rng(len(action))
    cols = rand_cols(rng, 128)
    cols["proto"] = rng.choice([1, 6, 17], 128).astype(np.int32)
    jpv, tpv = packet_pair(cols)
    alive = rng.random(128) < 0.85
    tids = rng.integers(0, 8, 128).astype(np.int32)
    tids[:2] = [0, 7]
    act = {"mark": 0, "drop": 1, "ratelimit": 2}[action]
    jt = jt._replace(glb_ml_action=jnp.int32(act),
                     glb_ml_rl_shift=jnp.int32(1))
    tt = tt._replace(glb_ml_action=torch.tensor(act, dtype=torch.int32),
                     glb_ml_rl_shift=torch.tensor(1, dtype=torch.int32))
    scores = rng.integers(-30, 30, 128).astype(np.int32)
    jf, jd = jml.ml_policy(jt, jpv, jnp.asarray(alive), jnp.asarray(scores),
                           tid=jnp.asarray(tids))
    tf, td = tml.ml_policy(tt, tpv, torch.from_numpy(alive),
                           torch.from_numpy(scores),
                           tid=torch.from_numpy(tids))
    assert_same(jf, tf, "flagged")
    assert_same(jd, td, "drop_wanted")
    assert np.asarray(jf).any() and (action == "mark"
                                     or np.asarray(jd).any())
    est, age = rand_session(rng, 128)
    got = tml.ml_stage_plain(tt, tpv, torch.from_numpy(alive),
                             torch.from_numpy(est), torch.from_numpy(age),
                             "mlp", tid=torch.from_numpy(tids))
    want = jml.ml_score(jt, jpv, jnp.asarray(est), jnp.asarray(age))
    wf, wd = jml.ml_policy(jt, jpv, jnp.asarray(alive), want,
                           tid=jnp.asarray(tids))
    for w, g, what in zip((want, wf, wd), got, ("scores", "flag", "drop")):
        assert_same(w, g, what)
    planes = {f: np.asarray(getattr(tt, f).numpy())
              for f in ("glb_ml_w1", "glb_ml_b1", "glb_ml_s1", "glb_ml_w2",
                        "glb_ml_b2", "glb_ml_thresh", "glb_ml_action",
                        "glb_ml_rl_shift")}
    model = kernel_model(cols, est, age, alive, planes, "mlp", tnt=(
        tids, tt.glb_ml_tnt_mode.numpy(), tt.glb_ml_tnt_thresh.numpy()))
    for w, g, what in zip(got, model, ("scores", "flag", "drop")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=what)
    assert tml.ml_stage.launches == 0


@pytest.mark.parametrize("kind", ["mlp", "forest"])
def test_kernel_model_tenant_form_matches_plain_version(kind):
    """Random planes and random per-tenant vectors (every mode, the
    sentinel, extreme thresholds): the NumPy model of csrc/ml_score.cu's
    tenant form equals ``ml_stage_plain(tid=...)``."""
    rng = np.random.default_rng(7 if kind == "mlp" else 8)
    planes = rand_planes(rng, kind)
    n_t = 6
    modes = rng.integers(0, 4, n_t).astype(np.int32)
    threshs = rng.choice([-(1 << 31), -(1 << 31) + 1, -5, 0, 40,
                          (1 << 31) - 1], n_t).astype(np.int32)
    planes["glb_ml_thresh"] = np.int32(0)
    planes["glb_ml_action"] = np.int32(rng.choice([1, 2]))
    tables = type("Planes", (), {
        **{f: torch.from_numpy(np.array(a)) for f, a in planes.items()},
        "glb_ml_tnt_mode": torch.from_numpy(modes),
        "glb_ml_tnt_thresh": torch.from_numpy(threshs)})
    cols = rand_cols(rng, 96)
    est, age = rand_session(rng, 96)
    alive = rng.random(96) < 0.9
    tids = rng.integers(0, n_t, 96).astype(np.int32)
    _, tpv = packet_pair(cols)
    got = tml.ml_stage_plain(tables, tpv, torch.from_numpy(alive),
                             torch.from_numpy(est), torch.from_numpy(age),
                             kind, tid=torch.from_numpy(tids))
    want = kernel_model(cols, est, age, alive, planes, kind,
                        tnt=(tids, modes, threshs))
    for w, g, what in zip(want, got, ("scores", "flagged", "drop")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


# --- whole steps through both Dataplanes --------------------------------


def _stage(dp, m, tenants, ml_model=None):
    """tests/test_tenancy.py ``build_dp``: a pod route, a default-route
    uplink, permit TCP 80 + permit UDP + deny, the tenant registry."""
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "web"))
    dp.builder.add_route("10.1.1.0/24", pod, jvector.Disposition.LOCAL)
    dp.builder.add_route("0.0.0.0/0", up, jvector.Disposition.REMOTE,
                         node_id=1)
    R, A, P = m.ContivRule, m.Action, m.Protocol
    dp.builder.set_global_table([R(action=A.PERMIT, protocol=P.TCP,
                                   dest_port=80),
                                 R(action=A.PERMIT, protocol=P.UDP),
                                 R(action=A.DENY)])
    if ml_model is not None:
        dp.builder.set_ml_model(ml_model.to_dict())
    for e in tenants:
        dp.builder.set_tenant(e["id"], **{k: v for k, v in e.items()
                                          if k != "id"})
    dp.swap()
    return up, pod


class Pair:
    """One tenancy-on Dataplane per package, staged alike and driven in
    lockstep; every step's results, counters and the session, NAT, ECMP
    and tenancy planes must agree."""

    def __init__(self, tenants, ml_model=None, graphs=True, **over):
        kw = dict(_CFG, **over)
        self.j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
        self.t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu",
                               graphs=graphs)
        for dp, m in ((self.j, jrule), (self.t, trule)):
            self.up, self.pod = _stage(dp, m, tenants, ml_model)

    def step(self, jpv, now):
        jr = self.j.process(jpv, now=now)
        tr = self.t.process(torch_packets(jpv), now=now)
        for f in jvector.PacketVector._fields:
            assert_same(getattr(jr.pkts, f), getattr(tr.pkts, f), f)
        for f in ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
                  "established", "dnat_applied", "snat_applied",
                  "ml_flagged", "ml_scores"):
            assert_same(getattr(jr, f), getattr(tr, f), f)
        for f in jr.stats._fields:
            assert_same(getattr(jr.stats, f), getattr(tr.stats, f),
                        f"stats.{f}")
        for f in tuple(ttables.SESSION_FIELDS) + _TNT_PLANES + (
                "fib_ecmp_c",):
            assert_same(getattr(jr.tables, f), getattr(tr.tables, f), f)
        js, ts = self.j.tenant_snapshot(), self.t.tenant_snapshot()
        for k in js:
            if k == "tenants":
                assert ts[k] == js[k]
            else:
                np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        return tr


def _traffic(up, nets, n=None, seed=0, dport=80, proto=6):
    """tests/test_tenancy.py ``tenant_traffic``: one packet per (net, i),
    src inside the tenant's net, dst a pod address."""
    rng = np.random.default_rng(seed)
    pkts = []
    for net, count in nets:
        base = net.split("/")[0].rsplit(".", 2)[0]
        for i in range(count):
            pkts.append(dict(
                src=f"{base}.{rng.integers(0, 250)}.{rng.integers(1, 250)}",
                dst=f"10.1.1.{2 + (i % 200)}", proto=proto,
                sport=int(rng.integers(1024, 65000)), dport=dport,
                rx_if=up))
    return jvector.make_packet_vector(pkts, n=n or max(16, len(pkts)))


def _replies(jpv, res, rx_if):
    """The replies of a step's forwarded packets (reversed endpoints)."""
    fwd = np.nonzero(res.disp.numpy() != int(tvector.Disposition.DROP))[0]
    src, dst = np.asarray(jpv.src_ip), np.asarray(jpv.dst_ip)
    sp, dp_ = np.asarray(jpv.sport), np.asarray(jpv.dport)
    pr = np.asarray(jpv.proto)
    return jvector.make_packet_vector(
        [dict(src=int(dst[i]), dst=int(src[i]), proto=int(pr[i]),
              sport=int(dp_[i]), dport=int(sp[i]), rx_if=rx_if)
         for i in fwd], n=len(src))


@pytest.mark.parametrize("graphs", [False, True])
def test_quota_drops_attributed_conserved_and_no_session(graphs):
    """Over-quota packets: DROP_TENANT, counted in rx and the tenant's
    planes, no session installed; the snapshot equals the reference's."""
    pair = Pair(({"id": 1, "prefixes": [T1_NET], "rate": 1,
                  "burst": 4},), graphs=graphs)
    r = pair.step(_traffic(pair.up, [(T1_NET, 10), ("172.16.0.0/16", 3)],
                           n=16, seed=1), now=100)
    assert int(r.stats.tnt_limited) == 6
    assert int((r.drop_cause == tgraph.DROP_TENANT).sum()) == 6
    assert int(r.stats.rx) == 13
    assert int(pair.t.tables.sess_valid.sum()) == 7
    snap = pair.t.tenant_snapshot()
    assert (int(snap["rl_drops"][1]), int(snap["rx"][1]),
            int(snap["tx"][1])) == (6, 10, 4)
    pair.step(_traffic(pair.up, [(T1_NET, 6)], n=16, seed=2), now=103)


def test_unconfigured_tenancy_is_the_identity():
    """Tenancy on with no tenant registered forwards as tenancy off,
    the session cells included; both equal the reference's."""
    on = Pair(())
    off = tdp.Dataplane(ttables.DataplaneConfig(**dict(_CFG,
                                                       tenancy="off")),
                        device="cpu")
    _stage(off, trule, ())
    for now, seed in ((1, 3), (2, 3), (3, 4)):
        jpv = _traffic(on.up, [(T1_NET, 6), (T2_NET, 4),
                               ("172.16.0.0/16", 4)], n=16, seed=seed)
        ra = on.step(jpv, now)
        rb = off.process(torch_packets(jpv), now=now)
        for f in ("disp", "tx_if", "drop_cause", "established"):
            assert torch.equal(getattr(ra, f), getattr(rb, f)), f
        for f in ttables.SESSION_FIELDS:
            assert torch.equal(getattr(on.t.tables, f),
                               getattr(off.tables, f)), f


_SLICED = ({"id": 1, "prefixes": [T1_NET], "sess_buckets": 4},
           {"id": 2, "prefixes": [T2_NET], "sess_buckets": 4})


@pytest.mark.parametrize("flood", [T1_NET, "172.16.0.0/16"])
def test_flood_never_evicts_another_tenant(flood):
    """A 64-flow flood, from a sliced tenant or from the unsliced
    default, leaves tenant 2's sessions untouched; a sliced flood fails
    inserts counted against it alone."""
    pair = Pair(_SLICED)
    pair.step(_traffic(pair.up, [(T2_NET, 8)], n=16, seed=5), now=1)
    t2_live = int(pair.t.tenant_snapshot()["occupancy"][2])
    assert t2_live >= 6
    r = pair.step(_traffic(pair.up, [(flood, 64)], n=64, seed=6, dport=5000,
                           proto=17), now=2)
    snap = pair.t.tenant_snapshot()
    assert int(snap["occupancy"][2]) == t2_live
    assert int(snap["quota_fails"][2]) == 0
    if flood == T1_NET:
        assert int(snap["occupancy"][1]) <= 16
        assert int(r.stats.tnt_qfail) > 0
        assert int(snap["quota_fails"][1]) == int(r.stats.tnt_qfail)


@pytest.mark.parametrize("graphs", [False, True])
def test_reply_lands_in_the_same_slice(graphs):
    """Forward flows of a sliced tenant install in its slice; their
    replies hit established."""
    pair = Pair(_SLICED, graphs=graphs)
    fwd = _traffic(pair.up, [(T1_NET, 6)], n=16, seed=8)
    r0 = pair.step(fwd, now=1)
    assert int(r0.stats.tx) == 6
    r1 = pair.step(_replies(fwd, r0, pair.pod), now=2)
    assert bool(r1.established[:6].all())


@pytest.mark.parametrize("fastpath", [False, True])
def test_per_tenant_ml_modes_against_one_model(fastpath):
    """One flag-everything drop model, enforcing: tenant 1 off, 2 score,
    3 a never-flag threshold, the default inherits enforce (all its
    packets ML-dropped); then a ``set_tenant_ml`` swap (tenant 1 to
    enforce) captures nothing and flips its packets, on both tiers."""
    model = proto_model(flag_thresh=-(1 << 30), action="drop")
    pair = Pair(({"id": 1, "prefixes": [T1_NET], "ml_mode": "off"},
                 {"id": 2, "prefixes": [T2_NET], "ml_mode": "score"},
                 {"id": 3, "prefixes": [T3_NET],
                  "ml_thresh": (1 << 31) - 1}),
                ml_model=model, ml_stage="enforce", ml_hidden=4,
                fastpath=fastpath)
    nets = [(T1_NET, 4), (T2_NET, 4), (T3_NET, 4), ("172.16.0.0/16", 4)]
    jpv = _traffic(pair.up, nets, n=16, seed=9)
    r = pair.step(jpv, now=1)
    assert int(r.stats.ml_drops) == 4
    assert bool((r.drop_cause[12:16] == tgraph.DROP_ML).all())
    r1 = pair.step(_replies(jpv, r, pair.pod), now=2)
    assert int(r1.stats.fastpath) == int(fastpath)
    with tcap.capture_budget(0):
        for dp in (pair.j, pair.t):
            dp.builder.set_tenant_ml(1, ml_mode="enforce")
            dp.swap()
        r2 = pair.step(_replies(jpv, r, pair.pod), now=3)
        assert int(r2.stats.fastpath) == int(fastpath)
        assert int(r2.stats.ml_drops) == 4  # tenant 1's four replies
        pair.step(_traffic(pair.up, nets, n=16, seed=10), now=4)


def test_bucket_state_carries_across_swaps():
    """Bucket levels and counters ride a swap by reference (the same
    tensors), and a rule change neither refills nor zeroes them."""
    pair = Pair(({"id": 1, "prefixes": [T1_NET], "rate": 1,
                  "burst": 4},))
    pair.step(_traffic(pair.up, [(T1_NET, 10)], n=16, seed=12), now=1)
    held = {f: getattr(pair.t.tables, f) for f in _TNT_PLANES}
    before = {f: t.clone() for f, t in held.items()}
    assert int(before["tnt_rl_c"][1]) > 0
    for dp, m in ((pair.j, jrule), (pair.t, trule)):
        dp.builder.set_global_table([m.ContivRule(action=m.Action.PERMIT)])
        dp.swap()
    for f, t in held.items():
        assert getattr(pair.t.tables, f) is t
        assert torch.equal(t, before[f]), f
    pair.step(_traffic(pair.up, [(T1_NET, 3)], n=16, seed=13), now=2)


def test_auto_path_spends_the_tokens_once(monkeypatch):
    """On the two-tier path the tenant stage runs once a step whichever
    tier serves (the prefix runs it, the full chain takes its ingress):
    counted through ``graph._tenant_eval`` on the eager and the program
    path, with the buckets equal to the reference's every step."""
    calls = []
    real = tgraph._tenant_eval

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tgraph, "_tenant_eval", counted)
    for graphs in (False, True):
        tgraph.make_pipeline_step.cache_clear()
        pair = Pair(({"id": 1, "prefixes": [T1_NET], "rate": 2,
                      "burst": 6},), graphs=graphs, fastpath=True)
        calls.clear()
        tiers = []
        for k in range(3):
            fwd = _traffic(pair.up, [(T1_NET, 5)], n=16, seed=20 + k)
            r = pair.step(fwd, now=10 * k + 1)
            tiers.append(int(r.stats.fastpath))
            r = pair.step(_replies(fwd, r, pair.pod), now=10 * k + 2)
            tiers.append(int(r.stats.fastpath))
        assert tiers == [0, 1] * 3
        assert len(calls) == 6
    tgraph.make_pipeline_step.cache_clear()


@pytest.mark.parametrize("entry", ["probe", "process_packed"])
def test_side_effect_free_entries_move_no_tenancy_plane(entry):
    """``probe`` and ``process_packed(commit=False)`` spend no token and
    count nothing: the live tenancy planes keep their values (and the
    tensors), and the next real step equals the reference's."""
    pair = Pair(({"id": 1, "prefixes": [T1_NET], "rate": 1,
                  "burst": 3},), fastpath=True)
    pair.step(_traffic(pair.up, [(T1_NET, 2)], n=16, seed=30), now=1)
    live = {f: getattr(pair.t.tables, f).clone()
            for f in tdp._MUTABLE_FIELDS}
    jpv = _traffic(pair.up, [(T1_NET, 8)], n=16, seed=31)
    if entry == "probe":
        res = pair.t.probe(torch_packets(jpv), now=50)
        assert int(res.stats.tnt_limited) == 5
    else:
        flat = tdp.packed_input_zeros(16)
        tdp.pack_packet_columns(flat.view(np.uint32), {
            f: np.asarray(getattr(jpv, f))
            for f in jvector.PacketVector._fields}, 16)
        _, aux = pair.t.process_packed(flat, now=50, commit=False,
                                       with_aux=True)
        assert int(aux[tdp.PACKED_AUX_SCHEMA.index("tnt_limited")]) == 5
    for f, t in live.items():
        assert torch.equal(getattr(pair.t.tables, f), t), f
    pair.step(jpv, now=50)


@pytest.mark.parametrize("graphs", [False, True])
def test_packed_aux_carries_the_tenancy_rows(graphs):
    """tests/test_tenancy.py ``test_packed_aux_carries_tenancy_rows``:
    the aux rider's tnt_limited / tnt_qfail rows, and every row and
    output equal to the reference's packed call."""
    pair = Pair(({"id": 1, "prefixes": [T1_NET], "rate": 1, "burst": 2},),
                graphs=graphs)
    jpv = _traffic(pair.up, [(T1_NET, 8)], n=16, seed=22)
    flat = tdp.packed_input_zeros(16)
    tdp.pack_packet_columns(flat.view(np.uint32), {
        f: np.asarray(getattr(jpv, f))
        for f in jvector.PacketVector._fields}, 16)
    jout, jaux = pair.j.process_packed(flat.copy(), now=3, with_aux=True)
    tout, taux = pair.t.process_packed(flat, now=3, with_aux=True)
    assert_same(jout, tout, "packed out")
    assert_same(jaux, taux, "aux")
    schema = tdp.PACKED_AUX_SCHEMA
    assert int(taux[schema.index("tnt_limited")]) == 6
    assert int(taux[schema.index("tnt_qfail")]) == 0
