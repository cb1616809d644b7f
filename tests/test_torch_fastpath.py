"""The two-tier established-flow dispatcher: vpp_tpu_torch vs vpp_tpu.

The tests/test_fastpath.py ``TestDifferential`` scenarios — mixed fresh
/ denied / DNAT traffic, an all-established reply batch, a partial hit,
an established reply that would DNAT-match, and expired sessions — are
staged identically through both packages' ``Dataplane`` with the fast
path engaged, and the same packet vectors go through ``process`` at the
same clocks. After every step every ``StepResult`` field, every
``StepStats`` counter (``fastpath`` included: both packages must pick
the same tier) and the session / NAT / ECMP state must agree.

Each port step is also held against the port's own forced full chain
run on a copy of the same state: bit-exact except ``stats.fastpath``,
the one designed difference; where the batch is all-established, also
against the standalone ``pipeline_step_fast``, bit-exact throughout. ``fastpath_min_rules`` gates engagement
at every swap in both packages. Every quantity is an integer: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir import rule as jrule
from vpp_tpu.ops import nat44 as jnat
from vpp_tpu.ops import session as jsess
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ops import nat44 as tnat
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import graph as tgraph
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

from test_torch_pipeline import _STATE, _assert_results
from test_torch_tables import assert_same, packet_pair, torch_tables

ip4 = jvector.ip4
VIP = "10.96.0.1"
N = 16
_CFG = dict(max_tables=2, max_rules=16, max_global_rules=32, max_ifaces=8,
            fib_slots=16, sess_slots=256, nat_mappings=2, nat_backends=2)


def _stage(dp, rule, disp):
    """tests/test_fastpath.py ``build_dp``: one pod, an uplink, a
    3-rule global table and a one-backend service VIP."""
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "web"))
    dp.builder.add_route("10.1.1.0/24", pod, disp.LOCAL)
    dp.builder.add_route("0.0.0.0/0", up, disp.REMOTE, node_id=1)
    R, A, P = rule.ContivRule, rule.Action, rule.Protocol
    dp.builder.set_global_table([
        R(action=A.PERMIT, protocol=P.TCP, dest_port=80),
        R(action=A.PERMIT, protocol=P.TCP, dest_port=8080),
        R(action=A.DENY)])
    dp.builder.set_nat_mapping(0, ext_ip=ip4(VIP), ext_port=80, proto=6,
                               backends=[(ip4("10.1.1.2"), 8080, 1)],
                               boff=0)
    dp.swap()
    return up, pod


class Pair:
    """One fast-path Dataplane per package, staged and driven in
    lockstep; each port step is also replayed on the forced full chain."""

    def __init__(self, **over):
        kw = dict(_CFG, **over)
        self.j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
        self.t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
        self.up, self.pod = _stage(self.j, jrule, jvector.Disposition)
        assert (self.up, self.pod) == _stage(self.t, trule,
                                             tvector.Disposition)
        assert self.t._use_fastpath == self.j._use_fastpath
        assert self.t.classifier_impl == self.j.classifier_impl

    def _on_copy(self, fn, specs, now):
        """``fn(tables, pkts, now)`` on a copy of the port's live state."""
        t = self.t.tables
        copy = t._replace(**{f: getattr(t, f).clone() for f in _STATE})
        return fn(copy, tvector.make_packet_vector(specs, n=N), now)

    def step(self, specs, now, expect_fast):
        t = self.t
        full = self._on_copy(tgraph.make_pipeline_step(
            t.classifier_impl, t._skip_local, False, t._sweep_stride,
            fib_impl=t.fib_impl, sess_impl=t.session_impl), specs, now)
        # the fast tier on its own, valid under the dispatch invariant
        fast = self._on_copy(lambda tb, pk, n: tgraph.pipeline_step_fast(
            tb, pk, n, t._sweep_stride, fib_fn=tgraph._fib_fn(t.fib_impl),
            sess_impl=t.session_impl), specs, now) if expect_fast else None
        jr = self.j.process(jvector.make_packet_vector(specs, n=N), now=now)
        tr = t.process(tvector.make_packet_vector(specs, n=N), now=now)
        _assert_results(jr, tr)
        assert int(tr.stats.fastpath) == int(expect_fast)
        # the auto step equals the forced full chain but for the tier
        # flag, and the standalone fast tier where the invariant holds
        assert int(full.stats.fastpath) == 0
        for ref, skip in ((full, "fastpath"), (fast, None)):
            if ref is None:
                continue
            for f in tr.pkts._fields:
                assert_same(getattr(ref.pkts, f).numpy(),
                            getattr(tr.pkts, f), f)
            for f in ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
                      "established", "dnat_applied", "snat_applied"):
                assert_same(getattr(ref, f).numpy(), getattr(tr, f), f)
            for f in tr.stats._fields:
                if f != skip:
                    assert_same(getattr(ref.stats, f).numpy(),
                                getattr(tr.stats, f), f"stats.{f}")
            for f in _STATE:
                assert_same(getattr(ref.tables, f).numpy(),
                            getattr(tr.tables, f), f)
        return tr


def _mixed(up):
    """Fresh permitted + fresh denied + VIP (DNAT'd)."""
    return [dict(src="172.16.0.5", dst="10.1.1.7", proto=6, sport=4001,
                 dport=80, rx_if=up),
            dict(src="172.16.0.6", dst="10.1.1.8", proto=6, sport=4002,
                 dport=80, rx_if=up),
            dict(src="172.16.0.7", dst="10.1.1.9", proto=6, sport=4003,
                 dport=9999, rx_if=up),
            dict(src="172.16.0.8", dst=VIP, proto=6, sport=4004, dport=80,
                 rx_if=up)]


def _replies(res):
    """The reply of every forwarded packet: post-NAT endpoints swapped,
    received on the egress interface."""
    fwd = np.nonzero(res.disp.numpy() != int(tvector.Disposition.DROP))[0]
    pk = {f: getattr(res.pkts, f).numpy() for f in res.pkts._fields}
    tx = res.tx_if.numpy()
    return [dict(src=int(pk["dst_ip"][i]) & 0xFFFFFFFF,
                 dst=int(pk["src_ip"][i]) & 0xFFFFFFFF,
                 proto=int(pk["proto"][i]), sport=int(pk["dport"][i]),
                 dport=int(pk["sport"][i]), rx_if=int(tx[i]))
            for i in fwd]


def test_mixed_traffic_takes_full_chain():
    pair = Pair()
    r = pair.step(_mixed(pair.up), 5, expect_fast=False)
    assert (int(r.stats.tx), int(r.stats.drop_acl), int(r.stats.dnat)) \
        == (3, 1, 1)


def test_all_established_takes_classify_free_tier():
    pair = Pair()
    r1 = pair.step(_mixed(pair.up), 5, expect_fast=False)
    rep = _replies(r1)
    r2 = pair.step(rep, 6, expect_fast=True)
    assert int(r2.stats.tx) == int(r2.stats.sess_hits) == len(rep) == 3
    assert int(r2.stats.nat_reversed) == 1


def test_partial_hit_batch_falls_through():
    pair = Pair()
    r1 = pair.step(_mixed(pair.up), 5, expect_fast=False)
    rep = _replies(r1) + [dict(src="172.16.9.9", dst="10.1.1.30", proto=6,
                               sport=5005, dport=80, rx_if=pair.up)]
    r2 = pair.step(rep, 6, expect_fast=False)
    assert int(r2.stats.sess_hits) == len(rep) - 1
    # the fresh flow's session was installed: its reply now rides fast
    fresh = _replies(r2)[-1:]
    pair.step(fresh, 7, expect_fast=True)


def test_established_but_dnat_matching_reply_falls_through():
    pair = Pair()
    pair.step([dict(src=VIP, dst="10.1.1.7", proto=6, sport=80,
                    dport=8080, rx_if=pair.up)], 5, expect_fast=False)
    r = pair.step([dict(src="10.1.1.7", dst=VIP, proto=6, sport=8080,
                        dport=80, rx_if=pair.pod)], 6, expect_fast=False)
    assert bool(r.established[0]) and bool(r.dnat_applied[0])


def test_expired_sessions_fall_through():
    pair = Pair()
    r1 = pair.step(_mixed(pair.up), 5, expect_fast=False)
    late = 5 + pair.t.config.sess_max_age + 1
    r = pair.step(_replies(r1), late, expect_fast=False)
    assert int(r.stats.sess_hits) == 0


@pytest.mark.parametrize("over,engaged", [
    (dict(), True), (dict(fastpath_min_rules=3), True),
    (dict(fastpath_min_rules=4), False), (dict(fastpath=False), False)])
def test_min_rules_gates_engagement_at_every_swap(over, engaged):
    """The 3-rule table engages at ``fastpath_min_rules <= 3``; growing
    the table past the gate and swapping engages it in both packages."""
    pair = Pair(**over)
    assert pair.t._use_fastpath == pair.j._use_fastpath == engaged
    for dp, rule in ((pair.j, jrule), (pair.t, trule)):
        dp.builder.set_global_table(
            [rule.ContivRule(action=rule.Action.PERMIT)] * 5)
        dp.swap()
    assert pair.t._use_fastpath == pair.j._use_fastpath \
        == over.get("fastpath", True)


def test_predicate_pieces_match_reference():
    """``session_batch_summary`` and ``nat44_dnat_match`` on the same
    tables and headers. The service-VIP planes are the one-row
    placeholders (``svc_bk_n == 0``): a zeroed header — which equals the
    placeholder row's (0.0.0.0, 0, 0) key — must get the reference's
    answer, as must a VIP hit and a miss."""
    pair = Pair()
    pair.j.process(jvector.make_packet_vector(_mixed(pair.up), n=N), now=5)
    jt = pair.j.tables
    tt = torch_tables(jt)
    assert int(tt.svc_bk_n.sum()) == 0 and tt.svc_vip_ip.shape == (1,)
    n = 6
    cols = {f: np.zeros(n, np.uint32 if f in ("src_ip", "dst_ip")
                        else np.int32) for f in jvector.PacketVector._fields}
    cols["flags"][:] = 1
    # 0: zeroed header; 1: the VIP; 2: VIP, wrong port; 3-5: replies
    cols["dst_ip"][1:3] = ip4(VIP)
    cols["dport"][1:3] = (80, 81)
    cols["proto"][1:3] = 6
    rep = _replies(pair.t.process(
        tvector.make_packet_vector(_mixed(pair.up), n=N), now=5))
    for i, r in enumerate(rep[:3], start=3):
        cols["src_ip"][i], cols["dst_ip"][i] = r["src"], r["dst"]
        cols["proto"][i], cols["sport"][i] = r["proto"], r["sport"]
        cols["dport"][i], cols["rx_if"][i] = r["dport"], r["rx_if"]
    jp, tp = packet_pair(cols)
    for elig in (np.ones(n, bool), np.arange(n) % 2 == 0):
        want = jnat.nat44_dnat_match(jt, jp, jnp.asarray(elig))
        got = tnat.nat44_dnat_match(tt, tp, torch.from_numpy(elig))
        assert_same(want, got, "dnat_would")
    assert bool(np.asarray(want)[0]) is False  # the reference's answer
    for alive in (np.ones(n, bool), np.arange(n) >= 3, np.zeros(n, bool)):
        jw = jsess.session_batch_summary(jt, jp, jnp.asarray(alive), 6)
        tw = tsess.session_batch_summary(tt, tp, torch.from_numpy(
            alive), 6)
        for a, b, what in zip(jw, tw, ("hits", "hit_idx", "all_hit")):
            assert_same(a, b, what)


def test_probe_runs_the_full_chain_like_the_reference():
    """``probe`` always runs the forced full chain, as the reference's
    does (``_get_step(fast=False)``): on an all-established batch with
    the fast path engaged, every StepResult field and StepStats counter
    and the probe's own state equal the reference's, ``stats.fastpath``
    0 included, and neither package's live state moves."""
    pair = Pair()
    assert pair.t._use_fastpath and pair.j._use_fastpath
    r1 = pair.step(_mixed(pair.up), 5, expect_fast=False)
    rep = _replies(r1)
    t_live = {f: getattr(pair.t.tables, f).clone() for f in _STATE}
    j_live = {f: np.asarray(getattr(pair.j.tables, f)) for f in _STATE}
    jr = pair.j.probe(jvector.make_packet_vector(rep, n=N), now=6)
    tr = pair.t.probe(tvector.make_packet_vector(rep, n=N), now=6)
    _assert_results(jr, tr)
    assert int(jr.stats.fastpath) == int(tr.stats.fastpath) == 0
    assert int(tr.stats.sess_hits) == len(rep) == 3
    for f in _STATE:
        assert torch.equal(getattr(pair.t.tables, f), t_live[f]), f
        assert np.array_equal(np.asarray(getattr(pair.j.tables, f)),
                              j_live[f]), f


def test_probe_sees_one_whole_epoch(monkeypatch):
    """ROADMAP Queue 3 item 4: ``probe`` must run its step against one
    epoch. A swap that lands while the probe is inside its FIB lookup
    (it stages a deny-all-TCP table and deletes the pod route, then
    swaps, in another thread) must wait for the probe: the epoch does
    not move during the probe, and the result is epoch N's (forwarded to
    the pod), never a mix (the ACL of N and the FIB of N+1 give
    DROP_NO_ROUTE, which is neither). The hook waits for the swap at
    most a second, so a probe that holds the lock does not deadlock."""
    import threading

    cfg = ttables.DataplaneConfig(**dict(
        _CFG, max_ifaces=8, fib_impl="dense", fastpath=False))
    dp = tdp.Dataplane(cfg, device="cpu")
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "web"))
    R, A, P = trule.ContivRule, trule.Action, trule.Protocol
    dp.builder.set_global_table([R(action=A.PERMIT, protocol=P.TCP,
                                   dest_port=80)])
    dp.builder.add_route("10.1.1.0/24", pod, tvector.Disposition.LOCAL)
    dp.swap()
    epoch = dp.epoch
    pkts = tvector.make_packet_vector(
        [dict(src="172.16.0.9", dst="10.1.1.2", sport=40000, dport=80,
              rx_if=up)], n=8)

    def swap_next_epoch():
        with dp.commit_lock:
            dp.builder.set_global_table([R(action=A.DENY,
                                           protocol=P.TCP)])
            dp.builder.del_route("10.1.1.0/24")
            dp.swap()
        swapped.set()

    real = tgraph.fib_lookup_dense
    swapped, seen = threading.Event(), []

    def hooked(tables, p):
        if not seen:
            seen.append(dp.epoch)
            threading.Thread(target=swap_next_epoch, daemon=True).start()
            swapped.wait(timeout=1.0)
            seen.append(dp.epoch)
        return real(tables, p)

    monkeypatch.setattr(tgraph, "fib_lookup_dense", hooked)
    tgraph.make_pipeline_step.cache_clear()
    try:
        res = dp.probe(pkts, now=5)
        assert swapped.wait(timeout=10)
        assert seen == [epoch, epoch]
        assert (int(res.disp[0]), int(res.tx_if[0]),
                int(res.drop_cause[0])) == (
            int(tvector.Disposition.LOCAL), pod, 0)
        # and the next probe sees epoch N + 1 whole: an ACL drop
        assert dp.epoch == epoch + 1
        res = dp.probe(pkts, now=6)
        assert int(res.drop_cause[0]) == tgraph.DROP_ACL
    finally:
        monkeypatch.undo()
        tgraph.make_pipeline_step.cache_clear()


@pytest.mark.parametrize("entry", ["probe", "process_packed"])
def test_side_effect_free_entries_move_no_live_plane(entry):
    """``probe`` and ``process_packed(commit=False)`` run on copies of
    every state plane a step writes: with the ML stage (enforce) and
    telemetry (full) on, the live session, NAT, ECMP and telemetry
    planes keep their values, and a twin that never ran the entry steps
    on to the same results and counters (the ML ones included)."""
    from test_ml_stage import proto_model

    cfg = ttables.DataplaneConfig(**dict(
        _CFG, ml_stage="enforce", telemetry="full", fastpath=True))
    dps = [tdp.Dataplane(cfg, device="cpu") for _ in range(2)]
    for dp in dps:
        up, pod = _stage(dp, trule, tvector.Disposition)
        dp.builder.set_ml_model(proto_model(flag_thresh=10).to_dict())
        dp.swap()
    first = [dp.process(tvector.make_packet_vector(_mixed(up), n=N), now=5)
             for dp in dps]
    live = {f: getattr(dps[0].tables, f).clone()
            for f in tdp._MUTABLE_FIELDS}
    assert int(live["tel_sketched"]) > 0
    probe = _mixed(up) + [dict(src="198.18.0.1", dst="10.1.1.7", proto=17,
                               sport=53, dport=9000, rx_if=up)]
    if entry == "probe":
        res = dps[0].probe(tvector.make_packet_vector(probe, n=N), now=6)
        assert int(res.stats.ml_flagged) == 1
        assert int(res.stats.tel_sketched) == len(probe)
    else:
        flat = tdp.packed_input_zeros(N)
        jp = jvector.make_packet_vector(probe, n=N)
        tdp.pack_packet_columns(flat.view(np.uint32), {
            f: np.asarray(getattr(jp, f)) for f in jvector.PacketVector
            ._fields}, N)
        _, aux = dps[0].process_packed(flat, now=6, commit=False,
                                       with_aux=True, stamp_us=1,
                                       now_us=100)
        schema = tdp.PACKED_AUX_SCHEMA
        assert int(aux[schema.index("tel_observed")]) == len(probe)
        assert int(aux[schema.index("ml_flagged")]) == 1
    for f, t in live.items():
        assert torch.equal(getattr(dps[0].tables, f), t), f
    rep = _replies(first[0])
    after = [dp.process(tvector.make_packet_vector(rep, n=N), now=7)
             for dp in dps]
    for f in ("disp", "drop_cause", "ml_scores", "ml_flagged"):
        assert torch.equal(getattr(after[0], f), getattr(after[1], f)), f
    for a, b, f in zip(after[0].stats, after[1].stats,
                       after[0].stats._fields):
        assert torch.equal(a, b), f
    for f in tdp._MUTABLE_FIELDS:
        assert torch.equal(getattr(dps[0].tables, f),
                           getattr(dps[1].tables, f)), f
