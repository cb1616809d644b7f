"""The slice as a whole: vpp_tpu_torch's ``Dataplane.process`` vs vpp_tpu's.

The tests/test_dataplane.py scenarios (forwarding + TTL, longest-prefix
match, FIB miss, ACL enforcement, reflective return traffic and its
expiry, DNAT + reverse, NAT backend balance, many flows, an
unconfigured interface, SNAT + reverse) are staged identically through
both packages' ``Dataplane`` and builder, and the same packet vectors
go through several ``process`` steps at explicit clocks. After every
step every ``StepResult`` field, every ``StepStats`` counter and the
session, NAT and ECMP state columns must agree.

Four rung sets: the reference rungs (``dense`` classifier, ``lpm`` FIB,
``gather`` session probe) on both sides; the fused-kernel rungs
(``pallas`` everywhere); the ``mxu`` classifier with the fast path on;
and the fused-kernel rungs with the fast path on (``fastpath``). On the
CPU the JAX ladders resolve ``pallas`` to the jnp rungs; the port's
Dataplane is made to select its ``pallas`` rungs anyway, whose wrappers
then take their plain versions because the tensors lie on the CPU (the
launch counters stay 0). With the fast path on, ``stats.fastpath`` is
compared too: both packages must pick the same tier at every step.
Every quantity is an integer: the tolerance is exact equality.
"""

import ipaddress
from types import SimpleNamespace

import numpy as np
import pytest

from vpp_tpu.ir import rule as jrule
from vpp_tpu.parallel import partition as jpart
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ops import acl_bv as tbv
from vpp_tpu_torch.ops import acl_mxu as tmxu
from vpp_tpu_torch.ops import lpm as tlpm
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import selection as tsel
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

from test_torch_tables import assert_same

ip4 = jvector.ip4
IF_POD1, IF_POD2, IF_POD3, IF_UPLINK, IF_HOST = 1, 2, 3, 4, 5
POD1, POD2, POD3 = "10.1.1.1", "10.1.1.2", "10.1.1.3"
VIP = "10.96.0.10"

_SMALL = dict(max_tables=4, max_rules=16, max_global_rules=64,
              max_ifaces=16, fib_slots=64, sess_slots=1024, sess_ways=4,
              nat_mappings=4, nat_backends=16, fastpath=False,
              sess_sweep_stride=64)
RUNGS = {
    "reference": dict(classifier="dense", fib_impl="lpm",
                      session_impl="gather"),
    "kernel": dict(classifier="pallas", fib_impl="pallas",
                   session_impl="pallas"),
    "mxu": dict(classifier="mxu", fib_impl="lpm", session_impl="gather",
                fastpath=True),
    "fastpath": dict(classifier="pallas", fib_impl="pallas",
                     session_impl="pallas", fastpath=True),
}
# rung sets whose port Dataplane is forced onto its kernel rungs
_FORCED = ("kernel", "fastpath")
_STATE = tuple(ttables.SESSION_FIELDS) + ("fib_ecmp_c",)


class _KernelRungs(tdp.Dataplane):
    """The port's Dataplane with its ladders' kernel bit forced on, so
    the ``pallas`` rungs serve on CPU tensors (their plain versions)."""

    def _kernels_serve(self) -> bool:
        return True


JAX = SimpleNamespace(rule=jrule, Disp=jvector.Disposition,
                      make=jvector.make_packet_vector)
TORCH = SimpleNamespace(rule=trule, Disp=tvector.Disposition,
                        make=lambda specs: tvector.make_packet_vector(
                            specs, device="cpu"))


def _assert_results(jr, tr):
    for f in jvector.PacketVector._fields:
        assert_same(getattr(jr.pkts, f), getattr(tr.pkts, f), f"pkts.{f}")
    for f in ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
              "established", "dnat_applied", "snat_applied", "ml_flagged",
              "ml_scores"):
        assert_same(getattr(jr, f), getattr(tr, f), f)
    for f in jr.stats._fields:
        assert_same(getattr(jr.stats, f), getattr(tr.stats, f), f"stats.{f}")
    assert jr.ovl_outer is None and tr.ovl_outer is None
    for f in _STATE:
        assert_same(getattr(jr.tables, f), getattr(tr.tables, f), f)


class Pair:
    """One Dataplane per package, staged and driven in lockstep."""

    def __init__(self, rungs: str):
        kw = dict(_SMALL, **RUNGS[rungs])
        self.j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
        cls = _KernelRungs if rungs in _FORCED else tdp.Dataplane
        self.t = cls(ttables.DataplaneConfig(**kw), device="cpu")
        self.rungs = rungs
        self.fast_steps = 0

    def stage(self, fn):
        fn(self.j, JAX)
        fn(self.t, TORCH)
        self.j.swap()
        self.t.swap()
        if self.rungs in _FORCED:
            assert (self.t.classifier_impl, self.t.fib_impl,
                    self.t.session_impl) == ("pallas", "pallas", "pallas")
        else:
            assert self.t.classifier_impl == self.j.classifier_impl
            assert self.t.fib_impl == self.j.fib_impl
            assert self.t.session_impl == self.j.session_impl
        assert self.t._use_fastpath == self.j._use_fastpath

    def step(self, specs, now):
        jr = self.j.process(JAX.make(specs), now=now)
        tr = self.t.process(TORCH.make(specs), now=now)
        _assert_results(jr, tr)
        self.fast_steps += int(tr.stats.fastpath)
        return jr


def _base(dp, m, snat=False):
    b = dp.builder
    for i in (IF_POD1, IF_POD2, IF_POD3):
        b.set_interface(i, 1)
    b.set_interface(IF_UPLINK, 2, apply_global=True)
    b.set_interface(IF_HOST, 3)
    b.add_route(f"{POD1}/32", IF_POD1, m.Disp.LOCAL)
    b.add_route(f"{POD2}/32", IF_POD2, m.Disp.LOCAL)
    b.add_route(f"{POD3}/32", IF_POD3, m.Disp.LOCAL)
    b.add_route("10.2.0.0/16", IF_UPLINK, m.Disp.REMOTE,
                next_hop=ip4("192.168.16.2"), node_id=2)
    b.add_route("0.0.0.0/0", IF_UPLINK, m.Disp.REMOTE,
                next_hop=ip4("192.168.16.100"), snat=snat)


def _policy(m):
    R, A, P = m.rule.ContivRule, m.rule.Action, m.rule.Protocol
    return [R(action=A.PERMIT, protocol=P.TCP, dest_port=80),
            R(action=A.PERMIT, protocol=P.UDP, dest_port=53),
            R(action=A.DENY, protocol=P.TCP),
            R(action=A.DENY, protocol=P.UDP)]


def _deny_all(m):
    R, A, P = m.rule.ContivRule, m.rule.Action, m.rule.Protocol
    return [R(action=A.DENY, protocol=P.TCP), R(action=A.DENY, protocol=P.UDP)]


def _pkt(src, dst, proto, sport, dport, rx_if, **kw):
    return dict(src=src, dst=dst, proto=proto, sport=sport, dport=dport,
                rx_if=rx_if, **kw)


# --- the scenarios ------------------------------------------------------


def sc_forwarding_ttl(pair):
    pair.stage(_base)
    pkts = [_pkt(POD1, POD2, 6, 1234, 80, IF_POD1),
            _pkt(POD1, "10.2.0.9", 17, 53, 53, IF_POD1),
            _pkt(POD1, POD2, 6, 1, 2, IF_POD1, ttl=1),
            _pkt(POD1, POD2, 6, 1, 2, IF_POD1, len=12)]
    r = pair.step(pkts, 100)
    assert int(r.stats.drop_ip4) == 2 and int(r.stats.tx) == 2
    pair.step(pkts, 101)


def sc_longest_prefix(pair):
    def stage(dp, m):
        _base(dp, m)
        dp.builder.add_route("10.2.3.0/24", IF_POD3, m.Disp.LOCAL)
        dp.builder.add_route("10.2.3.128/25", IF_HOST, m.Disp.HOST)
        dp.builder.del_route("10.2.0.0/16")
        dp.builder.add_route("10.2.0.0/16", IF_UPLINK, m.Disp.REMOTE,
                             next_hop=ip4("192.168.16.3"), node_id=3)

    pair.stage(stage)
    r = pair.step([_pkt(POD1, d, 6, 7, 80, IF_POD1) for d in
                   ("10.2.3.4", "10.2.9.9", "10.2.3.200", "8.8.8.8",
                    "255.255.255.255")], 50)
    assert int(r.tx_if[0]) == IF_POD3 and int(r.tx_if[2]) == IF_HOST


def sc_fib_miss(pair):
    def stage(dp, m):
        dp.builder.set_interface(IF_POD1, 1)
        dp.builder.add_route(f"{POD1}/32", IF_POD1, m.Disp.LOCAL)
        dp.builder.add_route("172.16.0.0/12", IF_POD1, m.Disp.DROP)

    pair.stage(stage)
    r = pair.step([_pkt(POD1, "8.8.8.8", 6, 5, 80, IF_POD1),
                   _pkt(POD1, "172.16.9.9", 6, 5, 80, IF_POD1)], 10)
    assert int(r.stats.drop_no_route) == 1


def sc_acl_enforcement(pair):
    def stage(dp, m):
        _base(dp, m)
        dp.builder.set_local_table(0, _policy(m))
        dp.builder.set_if_local_table(IF_POD1, 0)
        R, A, P = m.rule.ContivRule, m.rule.Action, m.rule.Protocol
        dp.builder.set_global_table([
            R(action=A.PERMIT, protocol=P.TCP,
              dest_network=ipaddress.ip_network("10.1.1.0/24"),
              dest_port=80),
            R(action=A.DENY,
              src_network=ipaddress.ip_network("203.0.113.0/24")),
            R(action=A.PERMIT, protocol=P.UDP)])

    pair.stage(stage)
    pkts = [_pkt(POD1, POD2, 6, 999, 80, IF_POD1),
            _pkt(POD1, POD2, 6, 999, 443, IF_POD1),
            _pkt(POD1, POD2, 17, 999, 53, IF_POD1),
            _pkt(POD1, POD2, 1, 0, 0, IF_POD1),
            _pkt(POD2, POD1, 6, 1, 9999, IF_POD2),
            _pkt("198.51.100.7", POD3, 6, 40000, 80, IF_UPLINK),
            _pkt("203.0.113.9", POD3, 17, 40000, 53, IF_UPLINK),
            _pkt("198.51.100.7", POD3, 6, 40000, 22, IF_UPLINK),
            _pkt("198.51.100.7", POD3, 1, 0, 0, IF_UPLINK)]
    r = pair.step(pkts, 100)
    assert int(r.stats.drop_acl) == 2
    pair.step(pkts, 120)


def sc_reflective_and_expiry(pair):
    def stage(dp, m):
        _base(dp, m)
        dp.builder.set_local_table(0, _policy(m))
        dp.builder.set_local_table(1, _deny_all(m))
        dp.builder.set_if_local_table(IF_POD1, 0)
        dp.builder.set_if_local_table(IF_POD2, 1)

    pair.stage(stage)
    pair.step([_pkt(POD1, POD2, 6, 5555, 80, IF_POD1)], 100)
    rev = [_pkt(POD2, POD1, 6, 80, 5555, IF_POD2),
           _pkt(POD2, POD1, 6, 81, 4444, IF_POD2)]
    r = pair.step(rev, 110)
    assert int(r.stats.sess_hits) == 1
    for dp in (pair.j, pair.t):
        dp.advance_clock(1000.0)
    assert pair.j.expire_sessions(max_age=60) == \
        pair.t.expire_sessions(max_age=60) > 0
    r = pair.step(rev, 120)
    assert int(r.stats.sess_hits) == 0
    # idle past sess_max_age: the lookup's age check rejects the entry
    pair.step([_pkt(POD1, POD2, 6, 5556, 80, IF_POD1)], 200)
    pair.step([_pkt(POD2, POD1, 6, 80, 5556, IF_POD2)], 200 + 3001)


def sc_dnat_reverse(pair):
    def stage(dp, m):
        _base(dp, m)
        dp.builder.set_nat_mapping(
            0, ip4(VIP), 80, 6, [(ip4(POD2), 8080, 1), (ip4(POD3), 8080, 1)],
            boff=0)
        dp.builder.set_nat_mapping(1, ip4("192.168.16.1"), 0, 6,
                                   [(ip4("192.168.16.1"), 0, 1)], boff=4)
        dp.builder.set_nat_mapping(2, ip4("192.168.16.1"), 30080, 6,
                                   [(ip4(POD3), 8080, 1)], boff=8,
                                   self_snat=True)
        dp.builder.set_snat_ip(ip4("192.168.16.1"))
        dp.builder.add_route("192.168.16.1/32", IF_HOST, m.Disp.HOST)

    pair.stage(stage)
    fwd = [_pkt(POD1, VIP, 6, 7777, 80, IF_POD1),
           _pkt(POD1, VIP, 6, 7778, 80, IF_POD1),
           _pkt("10.2.0.5", "192.168.16.1", 6, 5, 30080, IF_UPLINK),
           _pkt("10.2.0.5", "192.168.16.1", 6, 6, 22, IF_UPLINK)]
    r = pair.step(fwd, 100)
    assert int(r.stats.dnat) >= 3
    pair.step(fwd, 101)
    dst = np.asarray(r.pkts.dst_ip)
    dport = np.asarray(r.pkts.dport)
    src = np.asarray(r.pkts.src_ip)
    sport = np.asarray(r.pkts.sport)
    reply = [_pkt(int(dst[i]), int(src[i]), 6, int(dport[i]), int(sport[i]),
                  IF_POD2 if i < 2 else IF_POD3) for i in range(3)]
    r2 = pair.step(reply, 102)
    assert int(r2.stats.nat_reversed) == 3


def sc_nat_balance(pair):
    def stage(dp, m):
        _base(dp, m)
        dp.builder.set_nat_mapping(
            0, ip4(VIP), 80, 6, [(ip4(POD2), 8080, 1), (ip4(POD3), 8080, 3)],
            boff=0)

    pair.stage(stage)
    fwd = [_pkt(POD1, VIP, 6, 1000 + i, 80, IF_POD1)
           for i in range(jvector.VEC)]
    r = pair.step(fwd, 100)
    dst = np.asarray(r.pkts.dst_ip)
    assert (dst == ip4(POD3)).sum() > 1.5 * (dst == ip4(POD2)).sum()
    reply = [_pkt(int(dst[i]), POD1, 6, 8080, 1000 + i,
                  IF_POD2 if dst[i] == ip4(POD2) else IF_POD3)
             for i in range(jvector.VEC)]
    pair.step(reply, 101)


def sc_many_flows(pair):
    pair.stage(_base)
    n = 250
    fwd = [_pkt(POD1, POD2, 6, 10000 + i, 80, IF_POD1) for i in range(n)]
    fwd += [fwd[0], fwd[1]]  # duplicates of one vector
    for step in range(4):
        r = pair.step(fwd[step * 50:] + fwd[:step * 50], 100 + step)
    assert int(r.stats.sess_occupancy) > 0
    rev = [_pkt(POD2, POD1, 6, 80, 10000 + i, IF_POD2) for i in range(n)]
    r = pair.step(rev, 110)
    assert int(r.stats.sess_hits) >= n - 8


def sc_unconfigured_interface(pair):
    pair.stage(_base)
    pair.step([_pkt(POD1, POD2, 6, 1, 80, 13),
               _pkt(POD1, POD2, 6, 1, 80, -3),
               _pkt(POD1, POD2, 6, 1, 80, 99)], 5)


def sc_snat_reverse(pair):
    def stage(dp, m):
        _base(dp, m, snat=True)
        dp.builder.set_snat_ip(ip4("192.168.16.1"))

    pair.stage(stage)
    fwd = [_pkt(POD1, "93.184.216.34", 6, 40000 + i, 443, IF_POD1)
           for i in range(20)]
    fwd += [_pkt(POD1, "93.184.216.34", 1, 7, 0, IF_POD1),
            _pkt(POD1, "93.184.216.34", 47, 0, 0, IF_POD1)]
    r = pair.step(fwd, 100)
    assert int(r.stats.snat) == 21 and int(r.stats.drop_nat) == 1
    src = np.asarray(r.pkts.src_ip)
    sport = np.asarray(r.pkts.sport)
    reply = [_pkt("93.184.216.34", int(src[i]), 6, 443, int(sport[i]),
                  IF_UPLINK) for i in range(20)]
    r2 = pair.step(reply, 101)
    assert int(r2.stats.nat_reversed) == 20


# A scenario with local tables runs first: the reference Dataplane then
# reuses its (always-correct) non-skip step variant for the policy-free
# scenarios instead of compiling a second program per rung set.
SCENARIOS = [sc_acl_enforcement, sc_forwarding_ttl, sc_longest_prefix,
             sc_fib_miss, sc_reflective_and_expiry, sc_dnat_reverse,
             sc_nat_balance, sc_many_flows, sc_unconfigured_interface,
             sc_snat_reverse]


@pytest.mark.parametrize("rungs", sorted(RUNGS))
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_process_matches_reference(scenario, rungs):
    pair = Pair(rungs)
    scenario(pair)
    # the reply steps of these scenarios ride the fast tier when it is on
    # (an all-dropped batch rides it vacuously)
    fast = RUNGS[rungs].get("fastpath", False) and scenario in (
        sc_dnat_reverse, sc_unconfigured_interface, sc_snat_reverse)
    assert (pair.fast_steps > 0) == bool(fast), pair.fast_steps
    assert (tsess.sess_probe_ways.launches, tbv.bv_first_set.launches,
            tlpm.lpm_fused_lookup.launches,
            tmxu.mxu_first_match.launches) == (0, 0, 0, 0)


def test_registry_and_probe_match_reference():
    """Pod add/delete, table slots and ``probe`` (no state moves)."""
    pair = Pair("reference")
    for dp, m in ((pair.j, JAX), (pair.t, TORCH)):
        up = dp.add_uplink()
        host = dp.add_host_interface()
        pods = [dp.add_pod_interface(("ns", f"p{i}")) for i in range(3)]
        assert dp.add_pod_interface(("ns", "p0")) == pods[0]
        slot = dp.alloc_table_slot("t0")
        dp.builder.set_local_table(slot, _policy(m))
        dp.assign_pod_table(("ns", "p1"), "t0")
        dp.del_pod_interface(("ns", "p2"))
        dp.free_table_slot("missing")
        for i, p in enumerate(pods[:2]):
            dp.builder.add_route(f"10.1.1.{i + 1}/32", p, m.Disp.LOCAL)
        dp.builder.add_route("0.0.0.0/0", up, m.Disp.REMOTE)
        dp.swap()
    assert (pair.j.uplink_if, pair.j.host_if, pair.j.pod_if,
            pair.j.table_slots) == (pair.t.uplink_if, pair.t.host_if,
                                    pair.t.pod_if, pair.t.table_slots)
    specs = [_pkt(POD1, POD2, 6, 5, p, pair.j.pod_if[("ns", "p1")])
             for p in (80, 443)]
    jr = pair.j.probe(JAX.make(specs), now=5)
    tr = pair.t.probe(TORCH.make(specs), now=5)
    _assert_results(jr, tr)
    assert int(pair.t.tables.sess_valid.sum()) == 0
    assert int(tr.tables.sess_valid.sum()) == 1


def test_selection_ladders_match_reference():
    for knob in ("dense", "mxu", "bv", "pallas", "auto"):
        for bv_ok in (False, True):
            for mxu_ok in (False, True):
                for n in (4, 600, 2000):
                    for pok in (False, True):
                        args = (knob, bv_ok, mxu_ok, n, 1024, 512)
                        assert tsel.select_impl(*args, pallas_ok=pok) == \
                            jpart.select_impl(*args, pallas_ok=pok)
    for knob in ("dense", "lpm", "pallas", "auto"):
        for lpm_ok in (False, True):
            for n in (10, 300):
                for pok in (False, True):
                    assert tsel.select_fib_impl(knob, lpm_ok, n, 256, pok) \
                        == jpart.select_fib_impl(knob, lpm_ok, n, 256, pok)
    for knob in ("gather", "pallas", "auto"):
        for pok in (False, True):
            assert tsel.select_session_impl(knob, pok) == \
                jpart.select_session_impl(knob, pok)
