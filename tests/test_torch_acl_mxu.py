"""The MXU bit-plane classifier: vpp_tpu_torch's ops/acl_mxu.py vs vpp_tpu's.

Each check hands the same NumPy-seeded inputs to both packages:

* the host compile (``compile_bitplanes_full``) and its incremental
  update (``compile_bitplanes_update``) across a churn sequence that
  includes range-port rows (``ok=False``: their column is zeroed and
  ``k`` pinned to 1, so they fail closed);
* ``packet_bit_planes``, compared as float32;
* the kernel operand ``mxu_operand``: unpacked (``mxu_operand_rows``)
  it gives back the reference's coefficients and ``k`` exactly, its
  chunk permutation is its own inverse, and a NumPy model of the
  kernel's in-shared-memory explode (four header words, bits spread to
  bytes, the constant plane 104, the same swizzle) times the operand is
  the reference's mismatch count;
* ``mxu_first_match`` on CPU tensors (its plain version: header
  columns -> enc) against the reference's Pallas kernel in interpret
  mode and its jnp ``mxu_first_match_reference``, at odd P and R', R'
  above 1,024 and not a multiple of it, with packets drawn from the
  rules so that single and multiple matches and misses all occur;
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


def _operand(table) -> torch.Tensor:
    """``mxu_operand`` of a compiled table."""
    return tmxu.mxu_operand({"glb_mxu_coeff": torch.from_numpy(table.coeff),
                             "glb_mxu_k": torch.from_numpy(table.k)}
                            )["glb_mxu_op"]


def _headers(pkts):
    return (pkts.src_ip, pkts.dst_ip, pkts.proto, pkts.sport, pkts.dport)


def _unswizzle(rows: np.ndarray) -> np.ndarray:
    """Row r's 16-byte chunk c read back from slot c ^ (r % 8)."""
    r = rows.shape[0]
    slot = np.arange(8)[None, :] ^ (np.arange(r)[:, None] % 8)
    chunks = rows.reshape(r, 8, 16)
    return np.take_along_axis(chunks, slot[:, :, None], axis=1).reshape(
        r, 128)


def _kernel_a_rows(cols) -> np.ndarray:
    """NumPy model of csrc/mxu_first_match.cu's explode: the four
    32-bit words of a packet's planes, each 16-bit half spread to 16
    bytes four bits at a time, stored in the swizzled chunk order."""
    u = lambda a: np.asarray(a).astype(np.int64) & 0xFFFFFFFF  # noqa: E731
    src, dst, proto, sport, dport = (u(c) for c in cols)
    words = [src, dst,
             (proto & 0xFF) | ((sport & 0xFFFF) << 8) | ((dport << 24)
                                                         & 0xFFFFFFFF),
             ((dport >> 8) & 0xFF) | (1 << (104 - 96))]
    p = src.shape[0]
    rows = np.zeros((p, 128), np.int8)
    for c in range(8):
        b16 = (words[c // 2] >> (16 * (c % 2))) & 0xFFFF
        for q in range(4):
            spread = ((b16 >> (4 * q)) & 0xF) * 0x00204081 & 0x01010101
            for byte in range(4):
                rows[:, c * 16 + 4 * q + byte] = (spread >> (8 * byte)) & 1
    slot = np.arange(8)[None, :] ^ (np.arange(p)[:, None] % 8)
    out = np.zeros_like(rows)
    for c in range(8):
        for r in range(p):
            out[r, slot[r, c] * 16:(slot[r, c] + 1) * 16] = \
                rows[r, c * 16:(c + 1) * 16]
    return out


@pytest.mark.parametrize("n_rules,cap,ranges", [
    (1, 1, ()), (100, 100, ()), (1100, 1100, (3, 700)), (200, 2500, ())])
def test_operand_unpacks_to_reference_coefficients(n_rules, cap, ranges):
    """The int8 operand holds the reference's float32 coefficients and
    k exactly (range-port rows fail closed in both), in the swizzled
    chunk order, and the permutation is its own inverse."""
    rng = np.random.default_rng(n_rules + cap)
    jp, _ = _packed(rng, n_rules, cap, ranges)
    jt = jmxu.compile_bitplanes(jp, cap)
    op = _operand(jt)
    r_cap = jmxu.mxu_rule_capacity(cap)
    assert op.dtype == torch.int8 and tuple(op.shape) == (r_cap, 128)
    coeff_t, k = tmxu.mxu_operand_rows(op)
    assert coeff_t.dtype == torch.int8 and k.dtype == torch.int32
    np.testing.assert_array_equal(coeff_t.numpy().astype(np.float32),
                                  jt.coeff.T)
    np.testing.assert_array_equal(k.numpy().astype(np.float32), jt.k)
    rows = _unswizzle(op.numpy())
    np.testing.assert_array_equal(rows[:, :104], jt.coeff.T[:, :104])
    np.testing.assert_array_equal(rows[:, 104], jt.k)
    assert not rows[:, 105:].any()
    assert torch.equal(tmxu._swizzle_rows(tmxu._swizzle_rows(op)), op)


def test_kernel_explode_times_operand_is_the_mismatch_count():
    """The kernel's A rows (modelled in NumPy) unswizzle to the
    reference's ``packet_bit_planes`` plus the constant plane 104, and
    their int32 product with the unswizzled operand equals the
    reference's ``bits @ coeff + k`` for every packet and rule."""
    rng = np.random.default_rng(17)
    jp, tp = _packed(rng, 300, 320)
    jt = jmxu.compile_bitplanes(jp, 320)
    cols = _packets(rng, 129, tp, 300)
    cols["proto"][:3] = [-1, 256, 1 << 20]
    cols["dport"][:2] = [-1, 70000]
    jpk, tpk = packet_pair(cols)
    a = _unswizzle(_kernel_a_rows([c.numpy() for c in _headers(tpk)]))
    bits = np.asarray(jmxu.packet_bit_planes(jpk).astype(jnp.float32))
    np.testing.assert_array_equal(a[:, :104], bits[:, :104])
    assert (a[:, 104] == 1).all() and not a[:, 105:].any()
    b = _unswizzle(_operand(jt).numpy()).astype(np.int32)
    want = bits @ jt.coeff + jt.k
    np.testing.assert_array_equal(a.astype(np.int32) @ b.T, want)


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
    op = _operand(table)
    got = tmxu.mxu_first_match(*_headers(tpk), op)
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
    got = tmxu.mxu_first_match_plain(*_headers(tpk), _operand(jt)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:25] == 1).all()            # /8 is rule 1, the first
    assert set(got[25:]) == {0, 1}          # DNS lanes hit rule 0
    miss = tmxu.mxu_first_match_plain(
        *_headers(tpk), _operand(tmxu.empty_bitplanes(3000)))
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
    assert torch.equal(tb.to_device().glb_mxu_op, tt.glb_mxu_op)


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
