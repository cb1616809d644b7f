"""The VXLAN overlay, service VIPs and ECMP groups: the port vs vpp_tpu.

The same NumPy-seeded inputs go through the reference and the port:

* ops: ``vxlan_encap`` (and its RFC 7348 entropy port), ``vxlan_decap``
  and the step's ``vxlan_decap_step`` on random lane mixes (framed
  good / unknown VNI / wrong port / not our VTEP / plain), with tenancy
  off and on and the VTEP unset and set;
* staging: ``set_service`` (the sticky weighted way fill through
  tests/test_service_churn.py's rolls, weight changes, scale-outs and
  refusals) and ``set_nh_group`` / ``del_nh_group`` array for array;
  ``set_vtep_ip``;
* steps through both ``Dataplane``s: tests/test_overlay.py's decap ->
  forward -> re-encap round trip, its random decap differential, the
  VNI-tenant pact, the overlay-off identity and the packed forms'
  ``ValueError``; tests/test_vxlan.py's ``encap_remote``; service DNAT
  sticky across a backend roll; ECMP member accounting and
  ``fib_snapshot``; and whole steps with all four stages on (tenancy,
  the overlay, service VIPs, ECMP, the ML stage enforcing) on the pallas
  rungs and on the MXU two-tier path, eager and from programs, step for
  step, with ``tenant_snapshot`` and ``fib_snapshot``.

Every quantity is an integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir import rule as jrule
from vpp_tpu.ops import vxlan as jvx
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ops import vxlan as tvx
from vpp_tpu_torch.pipeline import capture as tcap
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import graph as tgraph
from vpp_tpu_torch.pipeline import tables as ttables

from test_ml_stage import proto_model
from test_torch_capture import _host_reads, _record
from test_torch_pipeline import _KernelRungs
from test_torch_tables import assert_same, packet_pair, torch_packets

ip4 = jvector.ip4
VTEP_A = ip4("192.168.16.1")   # this node
VTEP_B = ip4("192.168.16.2")   # a peer
PV = jvector.PacketVector._fields
D = jvector.Disposition


def _lanes(rng, n, up=1, vtep=VTEP_A):
    """(outer cols, inner cols, vni, kind) of a random lane mix: 0 framed
    with a known VNI, 1 an unknown VNI, 2 the wrong UDP port, 3 another
    VTEP, 4 plain TCP, 5 no framing found (vni -1), 6 framed with an
    invalid inner header."""
    kind = rng.integers(0, 7, n)
    outer = dict(
        src_ip=np.full(n, VTEP_B, np.uint32),
        dst_ip=np.where(kind == 3, ip4("192.168.16.7"), vtep).astype(
            np.uint32),
        proto=np.where(kind == 4, 6, 17).astype(np.int32),
        sport=(49152 + rng.integers(0, 16384, n)).astype(np.int32),
        dport=np.where(kind == 2, 5789, jvx.VXLAN_PORT).astype(np.int32),
        ttl=np.full(n, jvx.OUTER_TTL, np.int32),
        pkt_len=np.full(n, 178, np.int32),
        rx_if=np.full(n, up, np.int32),
        flags=np.ones(n, np.int32))
    inner = dict(
        src_ip=(ip4("10.50.0.0") + rng.integers(2, 1 << 16, n)).astype(
            np.uint32),
        dst_ip=(ip4("10.1.1.0") + rng.integers(2, 250, n)).astype(
            np.uint32),
        proto=rng.choice([6, 17], n).astype(np.int32),
        sport=(1024 + rng.integers(0, 50000, n)).astype(np.int32),
        dport=rng.choice([80, 53], n).astype(np.int32),
        ttl=rng.integers(2, 64, n).astype(np.int32),
        pkt_len=rng.integers(60, 1400, n).astype(np.int32),
        rx_if=np.zeros(n, np.int32),
        flags=np.where(kind == 6, 0, 1).astype(np.int32))
    vni = np.where(kind == 1, 999, np.where(kind == 5, -1, 100)).astype(
        np.int32)
    return outer, inner, vni, kind


# --- ops ----------------------------------------------------------------------


def test_constants_match_reference():
    assert (tvx.VXLAN_PORT, tvx.DEFAULT_VNI, tvx.ENCAP_OVERHEAD,
            tvx.OUTER_TTL) == (jvx.VXLAN_PORT, jvx.DEFAULT_VNI,
                               jvx.ENCAP_OVERHEAD, jvx.OUTER_TTL)


def test_encap_matches_reference():
    """The outer header of masked lanes (entropy port of high addresses
    and ports, the VTEPs, TTL, length) and invalid outers elsewhere."""
    rng = np.random.default_rng(1)
    _, cols, _, _ = _lanes(rng, 200)
    cols["src_ip"] = rng.integers(0, 2 ** 32, 200, dtype=np.uint64).astype(
        np.uint32)
    cols["sport"][:50] = rng.integers(32768, 65536, 50)
    cols["flags"][::7] = 0
    jp, tp = packet_pair(cols)
    mask = rng.random(200) < 0.7
    remote = rng.integers(0, 2 ** 32, 200, dtype=np.uint64).astype(np.uint32)
    for vtep in (VTEP_A, 0xFFFFFFFE):
        jo = jvx.vxlan_encap(jp, jnp.asarray(mask), jnp.uint32(vtep),
                             jnp.asarray(remote))
        for local in (vtep, torch.tensor(vtep & 0xFFFFFFFF).to(
                torch.int64).to(torch.int32)):
            to = tvx.vxlan_encap(tp, torch.from_numpy(mask), local,
                                 torch.from_numpy(remote.view(np.int32)))
            for f in PV:
                assert_same(getattr(jo, f), getattr(to, f), f)
    assert_same(jvx._flow_entropy_sport(jp), tvx._flow_entropy_sport(tp),
                "entropy sport")


def test_decap_matches_reference():
    """``vxlan_decap``: the VNI check, the VTEP check, the inner re-admit
    with the outer's rx interface."""
    rng = np.random.default_rng(2)
    outer, inner, vni, _ = _lanes(rng, 128)
    vni = np.where(vni == 100, jvx.DEFAULT_VNI, vni).astype(np.int32)
    (jo, to), (ji, ti) = packet_pair(outer), packet_pair(inner)
    for local in (None, VTEP_A, VTEP_B):
        jr = jvx.vxlan_decap(jo, ji, jnp.asarray(vni), local_vtep=(
            None if local is None else jnp.uint32(local)))
        tr = tvx.vxlan_decap(to, ti, torch.from_numpy(vni),
                             local_vtep=local)
        assert_same(jr.ok, tr.ok, "ok")
        for f in PV:
            assert_same(getattr(jr.inner, f), getattr(tr.inner, f), f)


@pytest.mark.parametrize("tenancy", ["off", "on"])
@pytest.mark.parametrize("vtep", [0, VTEP_A])
def test_decap_step_matches_reference(tenancy, vtep):
    """The step's decap stage on a random lane mix: the rewritten
    vector, the fail-closed lanes, the decapped lanes and their VNI
    tenants."""
    kw = dict(max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
              fib_slots=16, sess_slots=256, nat_mappings=2, nat_backends=2,
              tenancy=tenancy, overlay="vxlan")
    jb = jtables.TableBuilder(jtables.DataplaneConfig(**kw))
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    for b in (jb, tb):
        b.set_vtep_ip(vtep)
        if tenancy == "on":
            b.set_tenant(3, prefixes=["10.50.0.0/16"], vni=100)
            b.set_tenant(5, vni=200)
    jt, tt = jb.to_device(), tb.to_device()
    rng = np.random.default_rng(3 + vtep % 5)
    outer, inner, vni, kind = _lanes(rng, 256)
    if tenancy == "off":
        vni = np.where(vni == 100, jvx.DEFAULT_VNI, vni).astype(np.int32)
    else:
        vni[::5] = 200
    (jo, to), (ji, ti) = packet_pair(outer), packet_pair(inner)
    jout = jvx.vxlan_decap_step(jt, jo, ji, jnp.asarray(vni))
    tout = tvx.vxlan_decap_step(tt, to, ti, torch.from_numpy(vni))
    for f in PV:
        assert_same(getattr(jout[0], f), getattr(tout[0], f), f)
    for w, g, what in zip(jout[1:], tout[1:], ("bad", "decapped", "tid")):
        assert_same(w, g, what)
    assert tout[1].any() and tout[2].any()


# --- staging ------------------------------------------------------------------


def _svc_builders(**over):
    kw = dict(dict(max_tables=2, max_rules=8, max_global_rules=8,
                   max_ifaces=8, fib_slots=32, sess_slots=512,
                   nat_mappings=2, nat_backends=4, svc_vips=16,
                   svc_backend_ways=8, fib_ecmp_groups=4, fib_ecmp_ways=8),
              **over)
    return (jtables.TableBuilder(jtables.DataplaneConfig(**kw)),
            ttables.TableBuilder(ttables.DataplaneConfig(**kw),
                                 device="cpu"))


def _backends(n, base=10, port=8080, w=1):
    return [(ip4(f"10.200.0.{base + j}"), port, w) for j in range(n)]


KEY = (ip4("10.96.0.10"), 80, 6)


def _same_staging(jb, tb, fields):
    jh, th = jb.host_arrays(), tb.host_arrays()
    for f in fields:
        np.testing.assert_array_equal(th[f], jh[f], err_msg=f)
        assert th[f].dtype == jh[f].dtype, f


def test_service_staging_matches_reference():
    """tests/test_service_churn.py's sticky fill: a roll of one backend
    of four, a weight change alone, an idempotent re-stage, a scale-out,
    a second and third VIP (rows sorted), a delete, and the refusals that
    leave the staging as it was — the svc planes and the assignment
    array for array after each."""
    jb, tb = _svc_builders()
    bks = _backends(4)
    ops = [
        ("set", KEY, bks, False),
        ("set", KEY, bks[:3] + [(ip4("10.200.0.99"), 8080, 1)], False),
        ("set", KEY, [(bks[0][0], bks[0][1], 3), bks[1]], True),
        ("set", KEY, [(bks[0][0], bks[0][1], 3), bks[1]], True),
        ("set", (ip4("10.96.0.5"), 53, 17), _backends(3, 40, 53), False),
        ("set", KEY, _backends(3) + [(ip4("10.200.0.40"), 8080, 2)], False),
        ("set", (ip4("10.96.0.5"), 443, 6), _backends(8, 60, 443, 5), True),
        ("del", (ip4("10.96.0.5"), 53, 17)),
        ("del", (ip4("10.96.0.77"), 53, 17)),
    ]
    for op in ops:
        for b in (jb, tb):
            if op[0] == "set":
                b.set_service(*op[1], op[2], self_snat=op[3])
            else:
                assert b.del_service(*op[1]) == (op[1][0] != ip4(
                    "10.96.0.77"))
        _same_staging(jb, tb, jb.svc)
        assert tb.services == jb.services
    for bad, match in ((dict(port=0), "port"),
                       (dict(backends=[(1, 80, 0)]), "weight"),
                       (dict(backends=[]), "at least one"),
                       (dict(backends=_backends(9)), "exceed")):
        args = dict(dict(vip_ip=KEY[0], port=KEY[1], proto=KEY[2],
                         backends=bks), **bad)
        for b in (jb, tb):
            with pytest.raises(ValueError, match=match):
                b.set_service(**args)
        _same_staging(jb, tb, jb.svc)
    tb.clear_services()
    jb.clear_services()
    _same_staging(jb, tb, jb.svc)
    full_j, full_t = _svc_builders(svc_vips=1)
    for b in (full_j, full_t):
        b.set_service(*KEY, bks)
        with pytest.raises(ValueError, match="table full"):
            b.set_service(KEY[0], 81, 6, bks)
    off = ttables.TableBuilder(ttables.DataplaneConfig(svc_vips=0),
                               device="cpu")
    with pytest.raises(ValueError, match="svc_vips is 0"):
        off.set_service(*KEY, bks)


def test_ecmp_group_staging_matches_reference():
    """``set_nh_group``'s sticky fill through member churn (duplicates
    collapsed), ``del_nh_group``, routes naming a group, and the
    refusals, array for array."""
    jb, tb = _svc_builders()
    m = [(ip4(f"192.168.16.{10 + j}"), 1, j) for j in range(5)]
    ops = [("set", 0, m[:3]), ("set", 0, m[:2] + [m[4]]),
           ("set", 0, m[:2] + [m[4]] + [m[4]]), ("set", 2, m),
           ("set", 0, m[:1]), ("del", 2), ("del", 3), ("set", 3, m[1:])]
    fields = ("fib_grp_nh", "fib_grp_tx_if", "fib_grp_node", "fib_grp_n",
              "fib_grp")
    for k, op in enumerate(ops):
        for b in (jb, tb):
            if op[0] == "set":
                b.set_nh_group(op[1], op[2])
            else:
                assert b.del_nh_group(op[1]) == (op[1] == 2)
            b.add_route(f"10.{40 + k}.0.0/16", 1, D.REMOTE, group=op[1])
        _same_staging(jb, tb, fields)
        assert tb.nh_groups == jb.nh_groups
    for args, match in (((9, m[:1]), "out of range"), ((0, []), "at least"),
                        ((0, m * 2 + [(1, 2, 9), (3, 4, 5), (6, 7, 8),
                                      (9, 9, 9)]), "exceed")):
        for b in (jb, tb):
            with pytest.raises(ValueError, match=match):
                b.set_nh_group(*args)
    for b in (jb, tb):
        with pytest.raises(ValueError, match="out of range"):
            b.add_route("10.99.0.0/16", 1, D.REMOTE, group=4)
    off = ttables.TableBuilder(ttables.DataplaneConfig(), device="cpu")
    with pytest.raises(ValueError, match="fib_ecmp_groups is 0"):
        off.set_nh_group(0, m[:1])
    with pytest.raises(ValueError, match="fib_ecmp_groups is 0"):
        off.add_route("10.0.0.0/8", 1, D.REMOTE, group=0)


# --- steps through both Dataplanes ------------------------------------


def _assert_step(jr, tr, overlay=True):
    for f in PV:
        assert_same(getattr(jr.pkts, f), getattr(tr.pkts, f), f"pkts.{f}")
    for f in ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
              "established", "dnat_applied", "snat_applied", "ml_flagged",
              "ml_scores"):
        assert_same(getattr(jr, f), getattr(tr, f), f)
    for f in jr.stats._fields:
        assert_same(getattr(jr.stats, f), getattr(tr.stats, f), f"stats.{f}")
    if not overlay:
        assert jr.ovl_outer is None and tr.ovl_outer is None
        assert tr.ovl_encap is None and tr.ovl_vni is None
        return
    for f in PV:
        assert_same(getattr(jr.ovl_outer, f), getattr(tr.ovl_outer, f),
                    f"ovl_outer.{f}")
    assert_same(jr.ovl_encap, tr.ovl_encap, "ovl_encap")
    assert_same(jr.ovl_vni, tr.ovl_vni, "ovl_vni")


_STATE = (tuple(ttables.SESSION_FIELDS) + tuple(ttables.TENANCY_STATE_FIELDS)
          + ("fib_ecmp_c",))


def _assert_planes(j, t):
    """The state planes and both snapshots (the FIB's but its rung name
    where the port is forced onto its kernel rungs, and but the
    reference's timing and upload record)."""
    for f in _STATE:
        assert_same(getattr(j.tables, f), getattr(t.tables, f), f)
    js, ts = j.fib_snapshot(), t.fib_snapshot()
    skip = ("lpm_build_ms", "upload") + (
        ("impl",) if isinstance(t, _KernelRungs) else ())
    for k in js:
        if k in skip:
            continue
        if k == "ecmp_c":
            np.testing.assert_array_equal(ts[k], js[k])
        else:
            assert ts[k] == js[k], k
    js, ts = j.tenant_snapshot(), t.tenant_snapshot()
    assert (js is None) == (ts is None)
    if js is not None:
        for k in js:
            if k == "tenants":
                assert ts[k] == js[k]
            else:
                np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def _overlay_stage(dp, m, tenants=()):
    """tests/test_overlay.py ``mk_dp``: an uplink and a pod, the VTEP,
    the pod /24, a remote /16 behind the peer VTEP and the underlay
    /24 the outer header resolves through."""
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "a"))
    dp.set_vtep(VTEP_A)
    dp.builder.add_route("10.1.1.0/24", pod, D.LOCAL)
    dp.builder.add_route("10.2.0.0/16", up, D.REMOTE, next_hop=VTEP_B,
                         node_id=2)
    dp.builder.add_route("192.168.16.0/24", up, D.REMOTE)
    for e in tenants:
        dp.builder.set_tenant(e["id"], **{k: v for k, v in e.items()
                                          if k not in ("id", "route")})
        dp.builder.add_route(e["route"], pod, D.LOCAL)
    dp.swap()
    return up, pod


class OverlayPair:
    def __init__(self, tenants=(), graphs=True, **over):
        kw = dict(max_tables=2, max_rules=8, max_global_rules=8,
                  max_ifaces=8, fib_slots=32, sess_slots=1024,
                  nat_mappings=2, nat_backends=4, overlay="vxlan", **over)
        self.j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
        self.t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu",
                               graphs=graphs)
        for dp, m in ((self.j, jrule), (self.t, trule)):
            self.up, self.pod = _overlay_stage(dp, m, tenants)

    def step(self, outer, now, inner=None, vni=None):
        jo = (outer if isinstance(outer, jvector.PacketVector)
              else packet_pair(outer)[0])
        kw_j, kw_t = {}, {}
        if inner is not None:
            ji, ti = packet_pair(inner)
            kw_j = dict(ovl_inner=ji, ovl_vni=jnp.asarray(vni))
            kw_t = dict(ovl_inner=ti, ovl_vni=torch.from_numpy(vni))
        jr = self.j.process(jo, now=now, **kw_j)
        tr = self.t.process(torch_packets(jo), now=now, **kw_t)
        _assert_step(jr, tr)
        _assert_planes(self.j, self.t)
        return tr


def _vx(up, specs):
    """tests/test_overlay.py ``vxlan_lanes``: (outer, inner, vni) cols
    of (inner_src, inner_dst, sport, vni) lanes."""
    n = len(specs)
    outer = jvector.make_packet_vector(
        [{"src": "192.168.16.2", "dst": "192.168.16.1", "proto": 17,
          "sport": 49152 + i, "dport": jvx.VXLAN_PORT, "ttl": jvx.OUTER_TTL,
          "len": 128 + jvx.ENCAP_OVERHEAD, "rx_if": up}
         for i in range(n)], n=n)
    inner = jvector.make_packet_vector(
        [{"src": s[0], "dst": s[1], "proto": 6, "sport": s[2], "dport": 80,
          "ttl": 64, "len": 128, "rx_if": up} for s in specs], n=n)
    cols = [{f: np.asarray(getattr(v, f)) for f in PV}
            for v in (outer, inner)]
    return cols[0], cols[1], np.array([s[3] for s in specs], np.int32)


@pytest.mark.parametrize("graphs", [False, True])
def test_decap_forward_reencap_round_trip(graphs):
    """Deliver, transit (re-encapped toward the peer through the outer
    FIB walk), an unknown VNI (fail closed); then plain pod traffic to
    the remote /16 encapped, twice (the program replays)."""
    pair = OverlayPair(graphs=graphs)
    outer, inner, vni = _vx(pair.up, [
        ("10.9.0.2", "10.1.1.5", 40000, jvx.DEFAULT_VNI),
        ("10.9.0.3", "10.2.1.5", 40001, jvx.DEFAULT_VNI),
        ("10.9.0.4", "10.1.1.5", 40002, 999)])
    r = pair.step(outer, 1, inner, vni)
    assert (int(r.stats.ovl_decap), int(r.stats.drop_overlay),
            int(r.stats.ovl_encap)) == (2, 1, 1)
    assert int(r.drop_cause[2]) == tgraph.DROP_OVERLAY
    assert int(r.ovl_outer.dst_ip[1]) & 0xFFFFFFFF == VTEP_B
    assert int(r.ovl_vni[1]) == jvx.DEFAULT_VNI
    pkts = jvector.make_packet_vector(
        [{"src": f"10.1.1.{2 + i}", "dst": f"10.2.3.{2 + i}", "proto": 6,
          "sport": 41000 + 977 * i, "dport": 80, "ttl": 64, "len": 200,
          "rx_if": pair.pod} for i in range(8)], n=8)
    for now in (2, 3):
        r = pair.step(pkts, now)
        assert bool(r.ovl_encap.all())
    # the default sidecar: overlay-addressed frames fail closed
    r = pair.step(outer, 4)
    assert int(r.stats.drop_overlay) == 3
    rp = pair.t.probe(torch_packets(packet_pair(outer)[0]), now=5)
    assert int(rp.stats.drop_overlay) == 3


def test_decap_differential_vs_reference():
    """A random 64-lane mix of framed, unknown-VNI, wrong-port,
    not-ours, plain, unframed and invalid-inner lanes, step for step
    (the reference's own oracle mask is tests/test_overlay.py's)."""
    pair = OverlayPair()
    rng = np.random.default_rng(19)
    for now in (1, 2):
        outer, inner, vni, kind = _lanes(rng, 64, up=pair.up)
        vni = np.where(vni == 100, jvx.DEFAULT_VNI, vni).astype(np.int32)
        inner["dst_ip"][::2] = (ip4("10.2.1.0")
                                + rng.integers(2, 250, 32)).astype(np.uint32)
        r = pair.step(outer, now, inner, vni)
        assert int(r.stats.ovl_decap) == int(((kind == 0)).sum())


def test_vni_names_the_tenant_and_unknown_vnis_fail_closed():
    """tests/test_overlay.py ``TestVniTenantMap``: the wire VNI names
    the tenant over the inner addresses, an unregistered VNI fails
    closed, and under tenancy the default VNI is not admitted."""
    tenants = ({"id": 1, "prefixes": ["10.61.0.0/16"], "vni": 100,
                "route": "10.61.1.0/24"},
               {"id": 2, "prefixes": ["10.62.0.0/16"], "vni": 200,
                "route": "10.62.1.0/24"})
    pair = OverlayPair(tenants, tenancy="on", tenancy_tenants=4)
    outer, inner, _ = _vx(pair.up, [("10.61.0.9", "10.61.1.5", 40000, 0)])
    rx0 = pair.t.tenant_snapshot()["rx"].copy()
    pair.step(outer, 1, inner, np.array([200], np.int32))
    d = pair.t.tenant_snapshot()["rx"] - rx0
    assert (int(d[1]), int(d[2])) == (0, 1)
    outer, inner, _ = _vx(pair.up, [("10.61.0.9", "10.61.1.5", 40000, 0),
                                    ("10.62.0.9", "10.62.1.5", 40001, 0),
                                    ("10.61.0.9", "10.61.1.6", 40002, 0)])
    r = pair.step(outer, 2, inner, np.array([100, 200, 300], np.int32))
    assert (int(r.stats.ovl_decap), int(r.stats.drop_overlay)) == (2, 1)
    r = pair.step(outer, 3, inner, np.full(3, jvx.DEFAULT_VNI, np.int32))
    assert int(r.stats.drop_overlay) == 3


def test_overlay_off_identity_and_packed_refusal():
    """Overlay off: no overlay fields, zero counters, the same verdicts
    as the reference; overlay on: the packed forms raise the reference's
    ValueError (the packed boundary has no sidecar lane)."""
    kw = dict(max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
              fib_slots=32, sess_slots=512, nat_mappings=2, nat_backends=4)
    j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
    t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
    for dp, m in ((j, jrule), (t, trule)):
        _overlay_stage(dp, m)
    pkts = jvector.make_packet_vector(
        [{"src": f"10.1.1.{5 + i}", "dst": f"10.2.3.{4 + i}", "proto": 6,
          "sport": 40000 + i, "dport": 80, "rx_if": 2} for i in range(8)],
        n=8)
    _assert_step(j.process(pkts, now=1), t.process(torch_packets(pkts),
                                                    now=1), overlay=False)
    pair = OverlayPair()
    flat = np.zeros((5, 8), np.int32)
    for call in (lambda dp: dp.process_packed(flat),
                 lambda dp: dp.process_packed(flat, commit=False),
                 lambda dp: dp.process_packed_chain(flat[None])):
        with pytest.raises(ValueError) as jerr:
            call(pair.j)
        with pytest.raises(ValueError) as terr:
            call(pair.t)
        assert str(terr.value) == str(jerr.value)


def test_encap_remote_matches_reference():
    """tests/test_vxlan.py ``test_dataplane_encap_remote_path``: REMOTE
    packets with a tunnel next hop get outer headers (a fabric peer and
    an edge peer), local packets none; before ``set_vtep`` it raises."""
    kw = dict(max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
              fib_slots=32, sess_slots=512, nat_mappings=2, nat_backends=4)
    j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
    t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
    with pytest.raises(RuntimeError, match="set_vtep"):
        t.encap_remote(None)
    for dp in (j, t):
        up = dp.add_uplink()
        pod = dp.add_pod_interface(("default", "a"))
        dp.builder.add_route("10.1.1.0/24", pod, D.LOCAL)
        dp.builder.add_route("10.2.0.0/16", up, D.REMOTE, next_hop=VTEP_B,
                             node_id=2)
        dp.builder.add_route("10.3.0.0/16", up, D.REMOTE,
                             next_hop=ip4("192.168.16.99"))
        dp.swap()
        dp.set_vtep(VTEP_A)
    pkts = jvector.make_packet_vector(
        [dict(src="10.1.1.5", dst=d, proto=17, sport=1000 + i, dport=53,
              rx_if=pod) for i, d in enumerate(
                  ("10.2.3.4", "10.3.1.1", "10.1.1.6", "8.8.8.8"))], n=8)
    jr, tr = j.process(pkts, now=1), t.process(torch_packets(pkts), now=1)
    jo, to = j.encap_remote(jr), t.encap_remote(tr)
    for f in PV:
        assert_same(getattr(jo, f), getattr(to, f), f)
    assert to.valid.tolist()[:4] == [True, True, False, False]


def test_service_dnat_sticky_across_a_backend_roll():
    """tests/test_service_churn.py ``TestDnatStickiness``: 64 flows
    through a 4-backend VIP, one backend rolled: the reference's picks,
    step for step (probes and committed steps)."""
    kw = dict(max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
              fib_slots=32, sess_slots=512, nat_mappings=2, nat_backends=4,
              svc_vips=16, svc_backend_ways=8)
    j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
    t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
    bks = _backends(4)
    for dp in (j, t):
        up = dp.add_uplink()
        pod = dp.add_pod_interface(("default", "web"))
        dp.builder.add_route("10.1.1.0/24", pod, D.LOCAL)
        dp.builder.add_route("10.200.0.0/16", pod, D.LOCAL)
        dp.builder.add_route("0.0.0.0/0", up, D.REMOTE)
        dp.builder.set_service(*KEY, bks)
        dp.swap()
    flows = jvector.make_packet_vector(
        [{"src": f"10.9.0.{i + 1}", "dst": "10.96.0.10", "proto": 6,
          "sport": 1024 + 37 * i, "dport": 80, "rx_if": up}
         for i in range(64)], n=64)
    tf = torch_packets(flows)
    p0 = t.probe(tf, now=1)
    _assert_step(j.probe(flows, now=1), p0, overlay=False)
    assert bool((p0.dnat_applied).all())
    _assert_step(j.process(flows, now=1), t.process(tf, now=1),
                 overlay=False)
    for dp in (j, t):
        dp.builder.set_service(*KEY, bks[:3] + [(ip4("10.200.0.99"), 8080,
                                                 1)])
        dp.swap()
    p1 = t.probe(tf, now=2)
    _assert_step(j.probe(flows, now=2), p1, overlay=False)
    moved = p0.pkts.dst_ip != p1.pkts.dst_ip
    assert bool(moved.any())
    assert bool((p0.pkts.dst_ip[moved] == bks[3][0]).all())
    assert bool((p1.pkts.dst_ip[moved] == ip4("10.200.0.99")).all())


# --- all four stages on ---------------------------------------------------

_ALL = dict(max_tables=2, max_rules=16, max_global_rules=32, max_ifaces=8,
            fib_slots=64, sess_slots=1024, sess_ways=4, nat_mappings=4,
            nat_backends=8, sess_sweep_stride=64, tenancy="on",
            tenancy_tenants=8, tenancy_prefixes=16, overlay="vxlan",
            svc_vips=8, svc_backend_ways=4, fib_ecmp_groups=4,
            fib_ecmp_ways=4, ml_stage="enforce", ml_hidden=4)
PATHS = {"pallas": dict(classifier="pallas", fib_impl="pallas",
                        session_impl="pallas", fastpath=False),
         "mxu": dict(classifier="mxu", fib_impl="lpm", session_impl="gather",
                     fastpath=True)}
PEERS = [ip4(f"192.168.16.{10 + k}") for k in range(3)]
SVC = ip4("10.96.0.20")


def _all_stage(dp, m, up, pod):
    """Every stage on: the VTEP, tenants with VNIs, a rate limit, slices
    and ML overrides, a 3-backend service VIP, an ECMP group of three
    peer VTEPs carrying the remote /16s, the underlay, a global table
    and a UDP-flagging model."""
    b = dp.builder
    dp.set_vtep(VTEP_A)
    b.add_route("10.1.1.0/24", pod, D.LOCAL)
    b.add_route("192.168.16.0/24", up, D.REMOTE)
    b.set_nh_group(0, [(p, up, 2 + k) for k, p in enumerate(PEERS)])
    b.add_route("10.2.0.0/16", up, D.REMOTE, group=0)
    b.add_route("10.3.0.0/16", up, D.REMOTE, next_hop=VTEP_B, node_id=5)
    b.add_route("0.0.0.0/0", up, D.REMOTE, snat=True)
    b.set_snat_ip(ip4("203.0.113.1"))
    b.set_service(SVC, 80, 6, [(ip4("10.1.1.40"), 8080, 1),
                               (ip4("10.1.1.41"), 8080, 2),
                               (ip4("10.1.1.42"), 8080, 1)])
    R, A, P = m.ContivRule, m.Action, m.Protocol
    b.set_global_table([R(action=A.PERMIT, protocol=P.TCP, dest_port=80),
                        R(action=A.PERMIT, protocol=P.TCP, dest_port=8080),
                        R(action=A.PERMIT, protocol=P.UDP),
                        R(action=A.DENY)])
    b.set_ml_model(proto_model(flag_thresh=10, action="drop").to_dict())
    b.set_tenant(1, prefixes=["10.50.0.0/16"], vni=100, rate=3, burst=6)
    b.set_tenant(2, prefixes=["10.60.0.0/16"], vni=200, sess_buckets=1,
                 nat_buckets=1, ml_mode="score")
    b.set_tenant(3, prefixes=["10.70.0.0/16"], vni=300, ml_thresh=100)
    dp.swap()


def _all_traffic(rng, n, up, pod):
    """A forward vector: tenant sources to pods, the VIP, the ECMP /16,
    the tunnel /16 and the internet; a quarter VXLAN frames (tenant
    VNIs and an unknown one)."""
    srcs = np.array([ip4("10.50.0.0"), ip4("10.60.0.0"), ip4("10.70.0.0"),
                     ip4("172.16.0.0")], np.uint32)
    dsts = np.array([ip4("10.1.1.0"), SVC, ip4("10.2.0.0"), ip4("10.3.0.0"),
                     ip4("8.8.8.0")], np.uint32)
    pick = rng.integers(0, len(dsts), n)
    dst = dsts[pick] | np.where(pick == 1, 0, rng.integers(2, 250, n)
                                ).astype(np.uint32)
    inner = dict(
        src_ip=(srcs[rng.integers(0, 4, n)]
                | rng.integers(1, 1 << 12, n).astype(np.uint32)),
        dst_ip=dst.astype(np.uint32),
        proto=rng.choice([6, 6, 17], n).astype(np.int32),
        sport=rng.integers(1024, 65535, n).astype(np.int32),
        dport=np.where(pick == 1, 80, rng.choice([80, 8080, 53, 22], n)
                       ).astype(np.int32),
        ttl=np.full(n, 64, np.int32), pkt_len=np.full(n, 200, np.int32),
        rx_if=np.full(n, up, np.int32), flags=np.ones(n, np.int32))
    framed = rng.random(n) < 0.25
    outer = {k: v.copy() for k, v in inner.items()}
    outer["src_ip"][framed] = VTEP_B
    outer["dst_ip"][framed] = VTEP_A
    outer["proto"][framed] = 17
    outer["dport"][framed] = jvx.VXLAN_PORT
    vni = np.where(framed, rng.choice([100, 200, 300, 999], n), -1).astype(
        np.int32)
    return outer, inner, vni


def _all_replies(res, pod):
    """Replies of a step's forwarded, non-encapped packets (reversed
    post-NAT endpoints), from the pod."""
    ok = ((res.disp != int(D.DROP)) & ~res.ovl_encap).numpy()
    cols = {f: getattr(res.pkts, f).numpy() for f in PV}
    n = len(ok)
    rep = dict(
        src_ip=cols["dst_ip"].view(np.uint32), dst_ip=cols["src_ip"].view(
            np.uint32), proto=cols["proto"], sport=cols["dport"],
        dport=cols["sport"], ttl=np.full(n, 64, np.int32),
        pkt_len=np.full(n, 300, np.int32), rx_if=np.full(n, pod, np.int32),
        flags=ok.astype(np.int32))
    return {k: np.ascontiguousarray(v) for k, v in rep.items()}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("graphs", [False, True])
def test_all_four_stages_step_for_step(path, graphs):
    """Tenancy, the overlay, service VIPs, ECMP and the ML stage
    enforcing, on the pallas rungs (the port forced onto its kernel
    rungs' plain versions) and on the MXU two-tier path: forward
    vectors with VXLAN frames, then the replies of what they forwarded
    (the fast tier on the MXU path), bit-exact every step with the
    session, NAT, ECMP and tenancy planes, ``tenant_snapshot`` and
    ``fib_snapshot``; every stage fires; a ``set_tenant_ml`` swap
    captures nothing."""
    kw = dict(_ALL, **PATHS[path])
    j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
    cls = _KernelRungs if path == "pallas" else tdp.Dataplane
    t = cls(ttables.DataplaneConfig(**kw), device="cpu", graphs=graphs)
    for dp, m in ((j, jrule), (t, trule)):
        up = dp.add_uplink()
        pod = dp.add_pod_interface(("default", "web"))
        _all_stage(dp, m, up, pod)
    rng = np.random.default_rng(7)
    seen = dict.fromkeys(("tnt_limited", "drop_overlay", "ovl_decap",
                          "ovl_encap", "dnat", "snat", "ml_drops",
                          "tnt_qfail", "fastpath"), 0)
    now = 10
    for k in range(3):
        if k == 2:
            for dp in (j, t):
                dp.builder.set_tenant_ml(2, ml_mode="enforce")
        with tcap.capture_budget(0 if k == 2 else 64):
            if k == 2:
                for dp in (j, t):
                    dp.swap()
            outer, inner, vni = _all_traffic(rng, 48, up, pod)
            jo, to = packet_pair(outer)
            ji, ti = packet_pair(inner)
            jr = j.process(jo, now=now, ovl_inner=ji,
                           ovl_vni=jnp.asarray(vni))
            tr = t.process(to, now=now, ovl_inner=ti,
                           ovl_vni=torch.from_numpy(vni))
            _assert_step(jr, tr)
            _assert_planes(j, t)
            rep = _all_replies(tr, pod)
            jp, tp = packet_pair(rep)
            jr2 = j.process(jp, now=now + 1)
            tr2 = t.process(tp, now=now + 1)
            _assert_step(jr2, tr2)
            _assert_planes(j, t)
        for r in (tr, tr2):
            for f in seen:
                seen[f] += int(getattr(r.stats, f))
        now += 5
    assert all(seen[f] > 0 for f in seen if f != "fastpath"), str(seen)
    assert (seen["fastpath"] > 0) == (path == "mxu")
    ecmp = t.fib_snapshot()["ecmp_groups"][0]
    assert sum(m["pkts"] > 0 for m in ecmp) >= 2


@pytest.mark.parametrize("tier", ["pallas", "fast", "slow"])
def test_four_stages_op_stream_bakes_in_nothing(tier):
    """Capture safety with every stage on: the op stream of the pallas
    full chain, and of the MXU path's prefix then its fast or full tier,
    is the same for two clocks and two batches (framed and plain lanes,
    rate-limited tenants, service VIPs, encaps) and reads nothing back
    to the host, so a CUDA graph of it bakes in neither the data, the
    clock, the tenants' buckets nor the overlay's sidecar."""
    kw = dict(_ALL, **PATHS["pallas" if tier == "pallas" else "mxu"])
    cls = _KernelRungs if tier == "pallas" else tdp.Dataplane
    t = cls(ttables.DataplaneConfig(**kw), device="cpu", graphs=False)
    up = t.add_uplink()
    pod = t.add_pod_interface(("default", "web"))
    _all_stage(t, trule, up, pod)
    rng = np.random.default_rng(11)
    streams = []
    for k, now in enumerate((20, 4000)):
        outer, inner, vni = _all_traffic(rng, 48, up, pod)
        res = t.process(packet_pair(outer)[1], now=now, **dict(
            ovl_inner=packet_pair(inner)[1], ovl_vni=torch.from_numpy(vni)))
        pkts = packet_pair(_all_replies(res, pod))[1]
        scratch = t._scratch()
        now_t = torch.tensor(now + 1, dtype=torch.int32)
        if tier == "pallas":
            step = t._get_step(False)
            streams.append(_record(lambda: step(scratch, pkts, now_t)))
        else:
            step = t._get_step(True)
            pre = step.prefix(scratch, pkts, now_t)
            part = step.fast if tier == "fast" else step.slow
            streams.append(_record(lambda: part(scratch, pre, now_t)))
    assert len(streams[0]) > 100
    assert streams[1] == streams[0]
    assert _host_reads(streams[0]) == []
