"""The MXU bit-plane classifier: vpp_tpu_torch's ops/acl_mxu.py vs vpp_tpu's.

Each check hands the same NumPy-seeded inputs to both packages:

* the host compile (``compile_bitplanes_full``) and its incremental
  update (``compile_bitplanes_update``) across a churn sequence that
  includes range-port rows (``ok=False``: their column is zeroed and
  ``k`` pinned to 1, so they fail closed);
* ``packet_bit_planes``, compared as float32;
* ``mxu_first_match_plain`` against the reference's Pallas kernel in
  interpret mode and its jnp ``mxu_first_match_reference``, at odd P and
  R', R' above 1,024 and not a multiple of it, with packets drawn from
  the rules so that single and multiple matches and misses all occur;
* ``acl_classify_global_mxu`` against the reference's on staged tables;
* the ``auto`` ladder picking ``mxu`` (BV ineligible, >= 512 rules) as
  the reference's Dataplane does.

Everything compared is an integer, or a bf16 / float32 0, +-1 or small
integer: the tolerance is exact equality.
"""

import ipaddress

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir import rule as jrule
from vpp_tpu.ops import acl_mxu as jmxu
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ops import acl_mxu as tmxu
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables

from test_torch_tables import (
    assert_same,
    packet_pair,
    torch_packets,
    torch_tables,
)


def _rules(mod, rng, n):
    """Exact-port rules over /8../32 prefixes, every ~5th any-port."""
    R, A, P = mod.ContivRule, mod.Action, mod.Protocol
    out = []
    for i in range(n):
        plen = int(rng.integers(8, 33))
        net = ipaddress.ip_network(
            (int(rng.integers(0, 2 ** 32)) & ((0xFFFFFFFF << (32 - plen))
                                              & 0xFFFFFFFF), plen))
        proto = [P.ANY, P.TCP, P.UDP][int(rng.integers(0, 3))]
        out.append(R(
            action=A.DENY if i % 3 == 2 else A.PERMIT,
            src_network=net if rng.random() < 0.6 else None,
            dest_network=None if rng.random() < 0.5 else net,
            protocol=proto,
            src_port=int(rng.choice([0, 0, 0, 1234])),
            dest_port=0 if proto == P.ANY or i % 5 == 0
            else int(rng.integers(1, 65536))))
    return out


def _packed(rng, n, cap, ranges=()):
    """(reference packing, port packing) of the same ``n`` seeded rules
    at capacity ``cap``, rows ``ranges`` turned into port ranges."""
    seed = int(rng.integers(0, 2 ** 31))
    jp = jtables.pack_rules(_rules(jrule, np.random.default_rng(seed), n),
                            cap)
    tp = ttables.pack_rules(_rules(trule, np.random.default_rng(seed), n),
                            cap)
    for row in ranges:
        for p in (jp, tp):
            p["dport_lo"][row], p["dport_hi"][row] = 1000, 2000
    return jp, tp


def _assert_table(jt, tt, what):
    for f in ("coeff", "k", "act"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")
    assert jt.ok == tt.ok, what


def test_capacity_and_empty_table_match_reference():
    for n in (1, 8, 1000, 1024, 1025, 10240):
        assert tmxu.mxu_rule_capacity(n) == jmxu.mxu_rule_capacity(n)
        _assert_table(jmxu.empty_bitplanes(n), tmxu.empty_bitplanes(n), n)
    assert tmxu.ENC_MISS == jmxu.ENC_MISS == 0x7FFFFFF
    assert tmxu.PLANES == jmxu.PLANES


def test_compile_and_update_match_reference_across_churn():
    """Full compiles and incremental updates on both sides, row churn
    that adds, fixes and keeps range-port rows."""
    rng = np.random.default_rng(11)
    cap = 1500
    jp, tp = _packed(rng, 1200, cap, ranges=(5,))
    jt, jbad = jmxu.compile_bitplanes_full(jp, cap)
    tt, tbad = tmxu.compile_bitplanes_full(tp, cap)
    _assert_table(jt, tt, "full")
    np.testing.assert_array_equal(tbad, jbad)
    assert not tt.ok and tbad[5]
    # fail closed: the range row's column can never reach 0
    assert (tt.coeff[:, 5] == 0).all() and tt.k[5] == 1.0
    for step, ranges in enumerate(((), (7, 900), (5,), ())):
        changed = np.sort(rng.choice(cap, 40 + 30 * step, replace=False))
        jn, tn = _packed(rng, 1200 + 50 * step, cap, ranges=ranges)
        for key in jp:
            jp[key][changed] = jn[key][changed]
            tp[key][changed] = tn[key][changed]
        if step == 2:  # repair the first range row through the update
            changed = np.union1d(changed, [5])
            for p in (jp, tp):
                p["dport_lo"][5] = p["dport_hi"][5] = 80
        jt, jbad = jmxu.compile_bitplanes_update(jp, cap, jt, jbad, changed)
        tt, tbad = tmxu.compile_bitplanes_update(tp, cap, tt, tbad, changed)
        _assert_table(jt, tt, f"update {step}")
        np.testing.assert_array_equal(tbad, jbad)
        # and the update equals a from-scratch compile of the same rows
        _assert_table(tmxu.compile_bitplanes(tp, cap), tt, f"scratch {step}")


def _packets(rng, n, packed, n_rules):
    """NumPy packet columns: half drawn from rules (each field inside
    the rule, so it matches), half random."""
    cols = dict(
        src_ip=rng.integers(0, 2 ** 32, n, dtype=np.uint32),
        dst_ip=rng.integers(0, 2 ** 32, n, dtype=np.uint32),
        proto=rng.choice([1, 6, 17, 255], n).astype(np.int32),
        sport=rng.integers(0, 65536, n).astype(np.int32),
        dport=rng.integers(0, 65536, n).astype(np.int32),
        ttl=np.full(n, 64, np.int32), pkt_len=np.full(n, 100, np.int32),
        rx_if=rng.integers(0, 4, n).astype(np.int32),
        flags=np.ones(n, np.int32))
    for i in range(0, n if n_rules else 0, 2):
        r = int(rng.integers(0, n_rules))
        for f, net, mask in (("src_ip", "src_net", "src_mask"),
                             ("dst_ip", "dst_net", "dst_mask")):
            m = int(packed[mask][r])
            cols[f][i] = (int(packed[net][r]) & m) | (int(cols[f][i]) & ~m
                                                      & 0xFFFFFFFF)
        if packed["proto"][r] >= 0:
            cols["proto"][i] = packed["proto"][r]
        for f in ("sport", "dport"):
            lo, hi = packed[f"{f}_lo"][r], packed[f"{f}_hi"][r]
            if lo == hi:
                cols[f][i] = lo
    return cols


def test_packet_bit_planes_match_reference():
    rng = np.random.default_rng(2)
    cols = _packets(rng, 300, jtables.pack_rules([], 4), 0)
    cols["proto"][:5] = [-1, 0, 255, 256, 1 << 20]  # only the low 8 bits
    cols["sport"][:3] = [-1, 65535, 70000]          # only the low 16 bits
    jp, tp = packet_pair(cols)
    jb = jmxu.packet_bit_planes(jp)
    tb = tmxu.packet_bit_planes(tp)
    assert tb.dtype == torch.bfloat16 and tuple(tb.shape) == (300, 128)
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))


@pytest.mark.parametrize("p,n_rules,cap", [
    (1, 1, 1), (7, 8, 8), (70, 100, 100), (129, 1100, 1100),
    (33, 2000, 2500)])
def test_first_match_plain_matches_reference(p, n_rules, cap):
    """R' = 1,100 is above one 1,024-rule chunk and not a multiple of
    it; cap 2,500 pads R' to 3,072 with never-matching columns."""
    rng = np.random.default_rng(p * 7919 + n_rules)
    jp, tp = _packed(rng, n_rules, cap)
    table = tmxu.compile_bitplanes(tp, cap)
    jpk, tpk = packet_pair(_packets(rng, p, tp, n_rules))
    bits = jmxu.packet_bit_planes(jpk)
    coeff, k = jnp.asarray(table.coeff), jnp.asarray(table.k)
    ref = np.asarray(jmxu.mxu_first_match_reference(bits, coeff, k))
    kern = np.asarray(jmxu.mxu_first_match(bits, coeff, k, interpret=True))
    np.testing.assert_array_equal(kern, ref)
    op = tmxu.mxu_operand({"glb_mxu_coeff": torch.from_numpy(table.coeff)})
    got = tmxu.mxu_first_match(tmxu.packet_bit_planes(tpk),
                               op["glb_mxu_coeff_t"],
                               torch.from_numpy(table.k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if p > 1:  # the drawn half matches
        assert (ref != jmxu.ENC_MISS).sum() >= p // 2


def test_first_match_lowest_rule_wins_and_all_miss():
    """Several rules match every packet: the lowest column wins; an
    empty-but-padded table misses everywhere."""
    rng = np.random.default_rng(5)
    R, A, P = trule.ContivRule, trule.Action, trule.Protocol
    rules = [R(action=A.DENY, protocol=P.UDP, dest_port=53)] + [
        R(action=A.PERMIT, protocol=P.ANY,
          dest_network=ipaddress.ip_network(f"10.0.0.0/{8 + i % 24}"))
        for i in range(40)] + [R(action=A.DENY, protocol=P.ANY)]
    tp = ttables.pack_rules(rules, 64)
    jt = jmxu.compile_bitplanes(tp, 64)
    cols = _packets(rng, 50, tp, 1)
    cols["dst_ip"][:] = 0x0A000001          # inside every 10/8.. prefix
    cols["proto"][:25] = 6                  # TCP: rule 0 cannot match
    jpk, tpk = packet_pair(cols)
    ref = np.asarray(jmxu.mxu_first_match_reference(
        jmxu.packet_bit_planes(jpk), jnp.asarray(jt.coeff),
        jnp.asarray(jt.k)))
    op = tmxu.mxu_operand({"glb_mxu_coeff": torch.from_numpy(jt.coeff)})
    got = tmxu.mxu_first_match_plain(tmxu.packet_bit_planes(tpk),
                                     op["glb_mxu_coeff_t"],
                                     torch.from_numpy(jt.k)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:25] == 1).all()            # /8 is rule 1, the first
    assert set(got[25:]) == {0, 1}          # DNS lanes hit rule 0
    empty = tmxu.empty_bitplanes(3000)
    op = tmxu.mxu_operand({"glb_mxu_coeff": torch.from_numpy(empty.coeff)})
    miss = tmxu.mxu_first_match_plain(tmxu.packet_bit_planes(tpk),
                                      op["glb_mxu_coeff_t"],
                                      torch.from_numpy(empty.k))
    assert (miss == int(tmxu.ENC_MISS)).all()


def _stage(b, mod, rng):
    b.set_interface(1, 2, apply_global=True)
    b.set_interface(2, 1)
    b.set_interface(3, 2, apply_global=True)
    b.set_global_table(_rules(mod, rng, 300))


def test_classify_global_mxu_matches_reference():
    """Staged through the reference builder, carried to the port by
    NumPy; the verdicts (permit, rule index) agree."""
    kw = dict(max_tables=2, max_rules=8, max_global_rules=320,
              max_ifaces=8, fib_slots=16, sess_slots=64, classifier="mxu")
    jb = jtables.TableBuilder(jtables.DataplaneConfig(**kw))
    _stage(jb, jrule, np.random.default_rng(9))
    jt = jb.to_device()
    tt = torch_tables(jt)
    rng = np.random.default_rng(10)
    jpk, _ = packet_pair(_packets(rng, 257, jb.glb, 300))
    jv = jmxu.acl_classify_global_mxu(jt, jpk)
    tv = tmxu.acl_classify_global_mxu(tt, torch_packets(jpk))
    assert_same(jv.permit, tv.permit, "permit")
    assert_same(jv.rule_idx, tv.rule_idx, "rule_idx")
    assert 0 < int((tv.rule_idx >= 0).sum()) < 257
    # the port's own builder stages the same operand
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    _stage(tb, trule, np.random.default_rng(9))
    assert torch.equal(tb.to_device().glb_mxu_coeff_t, tt.glb_mxu_coeff_t)


@pytest.mark.parametrize("n_rules,want", [(520, "mxu"), (100, "dense")])
def test_auto_ladder_selects_mxu_like_reference(n_rules, want):
    """``classifier: auto`` with BV ineligible (its memory cap is 0 MB)
    climbs to ``mxu`` at >= 512 rules in both packages."""
    kw = dict(max_tables=2, max_rules=8, max_global_rules=640,
              max_ifaces=8, fib_slots=16, sess_slots=64,
              classifier="auto", classifier_bv_mem_mb=0)
    j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
    t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
    rng = np.random.default_rng(4)
    seed = int(rng.integers(0, 2 ** 31))
    for dp, mod in ((j, jrule), (t, trule)):
        dp.builder.set_global_table(
            _rules(mod, np.random.default_rng(seed), n_rules))
        dp.swap()
    assert not t.builder.bv_ok() and t.builder.glb_mxu.ok
    assert j.classifier_impl == t.classifier_impl == want
