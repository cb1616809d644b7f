"""BV classifier parity: vpp_tpu_torch/ops/acl_bv.py vs vpp_tpu's.

The host compile (``compile_bv``, including its per-dimension reuse),
the plain version of the ``bv_first_set`` kernel against the Pallas
kernel in interpret mode and the independent bit-scan oracle at the
edge shapes (p, w) in {(1, 1), (5, 3), (300, 20)}, and the global and
per-interface local classify on the ``dense``, ``bv`` and ``pallas``
rungs against the JAX rungs over builder-committed tables. The
``pallas`` rung here runs on CPU tensors, so the wrapper takes its
plain version; the launch counter proves it. Every quantity is an
integer: the tolerance is exact equality.
"""

import ipaddress

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir.rule import Action, ContivRule, Protocol
from vpp_tpu.ops import acl as jacl
from vpp_tpu.ops import acl_bv as jbv
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu_torch.ops import acl as tacl
from vpp_tpu_torch.ops import acl_bv as tbv
from vpp_tpu_torch.pipeline import tables as ttables

from test_acl_bv import (
    _cfg,
    _mask,
    _tables,
    random_packets,
    random_rules,
)
from test_pallas_kernels import _np_first_rule
from test_torch_tables import (
    assert_same,
    packet_pair,
    torch_packets,
    torch_tables,
)

_BV_FIELDS = ("bnd_src", "bnd_dst", "bnd_sport", "bnd_dport", "nbnd",
              "bm_src", "bm_dst", "bm_sport", "bm_dport", "bm_proto", "ok")


def _assert_bv_equal(jt, tt):
    for f in _BV_FIELDS:
        j, t = np.asarray(getattr(jt, f)), np.asarray(getattr(tt, f))
        assert j.dtype == t.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 40), (2, 128)])
def test_compile_bv_matches_reference(seed, n):
    rng = np.random.default_rng(seed)
    rules = random_rules(rng, n)
    jp = jtables.pack_rules(rules, 128)
    tp = ttables.pack_rules(rules, 128)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    jt, jcols, jre = jbv.compile_bv(jp, 128)
    tt, tcols, tre = tbv.compile_bv(tp, 128)
    _assert_bv_equal(jt, tt)
    assert jre == tre
    # a port-only churn reuses the address planes in both packages
    tp2 = {k: v.copy() for k, v in tp.items()}
    jp2 = {k: v.copy() for k, v in jp.items()}
    for p in (tp2, jp2):
        p["dport_lo"][: n // 2 + 1] = 7
        p["dport_hi"][: n // 2 + 1] = 9
    jt2, _, jre2 = jbv.compile_bv(jp2, 128, prev=jt, prev_cols=jcols)
    tt2, _, tre2 = tbv.compile_bv(tp2, 128, prev=tt, prev_cols=tcols)
    _assert_bv_equal(jt2, tt2)
    assert jre2 == tre2 and "src" not in tre2


@pytest.mark.parametrize("p,w,seed", [(1, 1, 0), (5, 3, 1), (300, 20, 2)])
def test_bv_first_set_plain_matches_interpret_kernel(p, w, seed):
    """The same five [P, W] row sets: the JAX kernel takes them
    gathered, the port takes planes plus row indices (here the planes
    ARE the rows and packet i reads row i)."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 1 << 32, (p, w), dtype=np.uint32)
            for _ in range(5)]
    for r in rows[1:]:
        r &= rng.integers(0, 1 << 32, (p, w), dtype=np.uint32)
    for i in range(0, p, 3):
        rows[0][i] = 0
    enc_j = np.asarray(jbv.bv_first_set(*(jnp.asarray(r) for r in rows),
                                        interpret=True))
    planes = [torch.from_numpy(r.view(np.int32)) for r in rows]
    idx = torch.arange(p, dtype=torch.int32)
    enc_t = tbv.bv_first_set_plain(*planes, idx, idx, idx, idx, idx)
    assert_same(enc_j, enc_t, "enc")
    combined = rows[0] & rows[1] & rows[2] & rows[3] & rows[4]
    np.testing.assert_array_equal(
        np.where(enc_t.numpy() != tbv.BV_ENC_MISS, enc_t.numpy(), -1),
        _np_first_rule(combined))
    assert tbv.BV_ENC_MISS == int(jbv.BV_ENC_MISS)
    assert tbv.bv_first_set.launches == 0


def test_bv_first_set_local_table_index():
    """[T, I, W] planes with a per-packet table index equal the
    per-table [I, W] calls."""
    rng = np.random.default_rng(4)
    t_, i_, w_, p = 3, 6, 2, 40
    planes = [torch.from_numpy(rng.integers(0, 1 << 32, (t_, i_, w_),
                                            dtype=np.uint32).view(np.int32))
              for _ in range(5)]
    rows = [torch.from_numpy(rng.integers(0, i_, p).astype(np.int32))
            for _ in range(5)]
    table = torch.from_numpy(rng.integers(0, t_, p).astype(np.int32))
    enc = tbv.bv_first_set_plain(*planes, *rows, table=table)
    for t in range(t_):
        sel = table == t
        one = tbv.bv_first_set_plain(*(pl[t] for pl in planes),
                                     *(r[sel] for r in rows))
        assert torch.equal(enc[sel], one)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_first_match_matches_interpret_kernel(seed):
    """Table level: the port's wrapper over committed global planes
    equals the JAX fused first-match in interpret mode."""
    rng = np.random.default_rng(seed)
    rules = random_rules(rng, 60)
    _, jt = _tables(rules)
    tt = torch_tables(jt)
    jp = random_packets(rng, 129, rules, rx_if=1)
    tp = torch_packets(jp)
    m_j, r_j = jbv.bv_first_match_fused(
        jt.glb_bv_bnd_src, jt.glb_bv_bnd_dst, jt.glb_bv_bnd_sport,
        jt.glb_bv_bnd_dport, jt.glb_bv_nbnd, jt.glb_bv_src, jt.glb_bv_dst,
        jt.glb_bv_sport, jt.glb_bv_dport, jt.glb_bv_proto, jp,
        interpret=True)
    enc = tbv.bv_first_set(*tp.five_tuple, *tbv._glb_args(tt))
    matched = enc != tbv.BV_ENC_MISS
    assert_same(m_j, matched, "matched")
    assert_same(r_j, torch.where(matched, enc, -1), "rule")
    m_p, r_p = tbv.bv_first_match(
        tt.glb_bv_bnd_src, tt.glb_bv_bnd_dst, tt.glb_bv_bnd_sport,
        tt.glb_bv_bnd_dport, tt.glb_bv_nbnd, tt.glb_bv_src, tt.glb_bv_dst,
        tt.glb_bv_sport, tt.glb_bv_dport, tt.glb_bv_proto, tp)
    assert torch.equal(m_p, matched) and torch.equal(r_p, torch.where(
        matched, enc, -1))


_GLOBAL = {"dense": (jacl.acl_classify_global, tacl.acl_classify_global),
           "bv": (jbv.acl_classify_global_bv, tbv.acl_classify_global_bv),
           "pallas": (jbv.acl_classify_global_pallas,
                      tbv.acl_classify_global_pallas)}
_LOCAL = {"dense": (jacl.acl_classify_local, tacl.acl_classify_local),
          "bv": (jbv.acl_classify_local_bv, tbv.acl_classify_local_bv),
          "pallas": (jbv.acl_classify_local_pallas,
                     tbv.acl_classify_local_pallas)}


@pytest.mark.parametrize("rung", ["dense", "bv", "pallas"])
@pytest.mark.parametrize("seed", [5, 6])
def test_classify_rungs_match_reference(rung, seed):
    """Global (uplink + pods) and local (policied pods, a tableless pod
    and the uplink) verdicts and rule indices, high addresses and
    port edges included."""
    rng = np.random.default_rng(seed)
    rules = random_rules(rng, 100)
    _, jt = _tables(rules, rng=rng, n_local=3)
    tt = torch_tables(jt)
    jp = random_packets(rng, 256, rules, max_if=6)
    tp = torch_packets(jp)
    for jfn, tfn in (_GLOBAL[rung], _LOCAL[rung]):
        jv, tv = jfn(jt, jp), tfn(tt, tp)
        assert_same(jv.permit, tv.permit, f"{rung} permit")
        assert_same(jv.rule_idx, tv.rule_idx, f"{rung} rule_idx")
    assert tbv.bv_first_set.launches == 0


def test_local_none_matches_policy_free_local_classify():
    rng = np.random.default_rng(8)
    rules = random_rules(rng, 10)
    _, jt = _tables(rules)
    tt = torch_tables(jt)
    tp = torch_packets(random_packets(rng, 64, rules, max_if=4))
    tt = tt._replace(if_local_table=torch.full_like(tt.if_local_table, -1))
    want = tacl.acl_classify_local(tt, tp)
    got = tacl.acl_local_none(tt, tp)
    assert torch.equal(want.permit, got.permit)
    assert torch.equal(want.rule_idx, got.rule_idx)


# --- the fused kernel: its NumPy model and its plain version ---------------

_U = np.uint32
_MISS = tbv.BV_ENC_MISS


def _np_group_search(bnd, n, vals, g, signed):
    """csrc/bv_first_set.cu's segment search, vectorised over packets:
    ``bnd`` [P, I] each packet's boundary row, ``n`` [P] its live count,
    ``g`` lanes a packet. Each round lane k reads the pivot at
    lo + (k + 1) * step - 1, the ballot's count of pivots <= the value
    narrows [lo, hi], and the count is clipped as ``_segment_of`` clips
    it. Returns (row [P], rounds)."""
    flip = _U(0x80000000) if signed else _U(0)
    key = lambda x: np.asarray(x, np.int32).view(_U) ^ flip  # noqa: E731
    v = key(vals)
    size = bnd.shape[1]
    lo = np.zeros(len(v), np.int64)
    hi = np.clip(np.minimum(n, size), 0, None).astype(np.int64)
    rounds = 0
    while (hi > lo).any():
        span = hi - lo
        step = (span + g - 1) // g
        below = np.zeros(len(v), np.int64)
        for lane in range(g):
            q = lo + (lane + 1) * step - 1
            ok = (span > 0) & (q < hi)
            piv = key(bnd[np.arange(len(v)), np.clip(q, 0, size - 1)])
            below += ok & (piv <= v)
        busy = hi > lo
        lo, hi = (np.where(busy, lo + below * step, lo),
                  np.where(busy, np.minimum(hi, lo + (below + 1) * step - 1),
                           hi))
        rounds += 1
    r = np.minimum(np.maximum(lo - 1, 0), n - 1)
    return np.maximum(np.where(r < 0, r + size, r), 0), rounds


def _np_lane_first_set(words, g, chunk):
    """The kernel's row scan, vectorised over packets: ``words`` [P, W]
    the ANDed rows; lane k holds chunks k, k + g, ... of ``chunk``
    words, four chunks a round, keeps its first set bit, and the group's
    minimum is the answer (rounds stop once every packet has a hit)."""
    p, w = words.shape
    chunks = w // chunk
    best = np.full((p, g), _MISS, np.int64)
    for c0 in range(0, chunks, 4 * g):
        for u in range(4):
            for lane in range(g):
                c = c0 + u * g + lane
                if c >= chunks:
                    continue
                for k in range(chunk):
                    x = words[:, c * chunk + k].astype(np.int64)
                    bit = np.log2(np.maximum(x & -x, 1)).astype(np.int64)
                    take = (best[:, lane] == _MISS) & (x != 0)
                    best[:, lane] = np.where(take, (c * chunk + k) * 32 + bit,
                                             best[:, lane])
        if (best != _MISS).any(axis=1).all():
            break
    return best.min(axis=1).astype(np.int32)


def _np_bv_kernel(hdr, args, rx_if=None, if_table=None, vec4=True):
    """A NumPy model of csrc/bv_first_set.cu on one table (``args`` as
    ``_glb_args`` gives them) or on the per-interface tables (with
    ``rx_if`` / ``if_table``). Returns (tid or None, enc, rounds)."""
    src, dst, proto, sport, dport = (np.asarray(c, np.int32) for c in hdr)
    *bnds, nbnd = (np.asarray(a) for a in args[:5])
    planes = [np.asarray(a).view(_U) for a in args[5:]]
    p = len(src)
    tid = None
    if if_table is None:
        bnds = [b[None] for b in bnds]
        planes = [pl[None] for pl in planes]
        nbnd = nbnd[None]
        t = np.zeros(p, np.int64)
    else:
        r = np.asarray(rx_if, np.int64)
        n_if = len(if_table)
        r = np.clip(np.where(r < 0, r + n_if, r), 0, n_if - 1)
        tid = np.asarray(if_table)[r]
        t = np.clip(tid, 0, planes[0].shape[0] - 1)
    words = planes[0].shape[2]
    g = 32 if words > 32 else 8
    rows, rounds = [], 0
    for k, (b, v) in enumerate(zip(bnds, (src, dst, sport, dport))):
        row, nr = _np_group_search(b[t], nbnd[t, k], v, g, signed=k >= 2)
        rows.append(row)
        rounds = max(rounds, nr)
    rows.append(np.clip(proto, 0, planes[4].shape[1] - 1))
    anded = planes[0][t, rows[0]]
    for pl, row in zip(planes[1:], rows[1:]):
        anded = anded & pl[t, row]
    enc = _np_lane_first_set(anded, g, 4 if vec4 and words % 4 == 0 else 1)
    return tid, enc, rounds


def _sorted_bnd(rng, size, n, signed):
    """One dimension's boundary array as ``compile_bv`` lays it out:
    ``n`` sorted distinct live values from 0, pads above them."""
    hi = 1 << 16 if signed else 1 << 32
    vals = np.unique(np.concatenate([[0], rng.integers(1, hi, 3 * n)]))
    vals = np.sort(rng.permutation(vals[1:])[:n - 1])
    out = np.full(size, 0x7FFFFFFF if signed else 0xFFFFFFFF, np.int64)
    out[0] = 0
    out[1:n] = vals
    return out.astype(np.int32 if signed else _U)


@pytest.mark.parametrize("g", [32, 8])
def test_kernel_search_model_matches_searchsorted(g):
    """The kernel's g-ary search with its clip equals ``_segment_of``
    (``torch.searchsorted``, clip to the live count) on live counts
    from 1 to the padded length, at values equal to every boundary, one
    below and one above it, 0 and the dimension's maximum — unsigned
    for addresses, signed for ports; 20,482 entries take 3 rounds at 32
    lanes, 258 at 8."""
    rng = np.random.default_rng(g)
    for size, signed in ((2, False), (33, True), (258, False),
                         (258, True), (20482, False), (20482, True)):
        for n in sorted({1, 2, size // 2, size - 1, size}):
            n = max(n, 1)
            bnd = _sorted_bnd(rng, size, n, signed)
            live = bnd[:n].astype(np.int64)
            top = 65535 if signed else 0xFFFFFFFF
            vals = np.concatenate([live, live - 1, live + 1, [0, top],
                                   rng.integers(0, top + 1, 64)])
            vals = np.clip(vals, 0, top)
            vals = (vals.astype(np.int32) if signed
                    else vals.astype(_U).view(np.int32))
            want = tbv._segment_of(torch.from_numpy(bnd.view(np.int32)),
                                   torch.from_numpy(vals),
                                   torch.tensor(n), not signed).numpy()
            got, rounds = _np_group_search(
                np.broadcast_to(bnd.view(np.int32), (len(vals), size)),
                np.full(len(vals), n), vals, g, signed)
            np.testing.assert_array_equal(got, want, err_msg=f"{size} {n}")
            if (size, g) in ((20482, 32), (258, 8)):
                assert rounds <= 3


def _edge_packets(rng, jt, n, rules, max_if=None):
    """``random_packets`` with a third of the packets at a global
    boundary (the value itself or one off it) and the extremes."""
    jp = random_packets(rng, n, rules, max_if=max_if)
    cols = {f: np.asarray(getattr(jp, f)).copy() for f in jp._fields}
    for f, bf, k, top in (("src_ip", "glb_bv_bnd_src", 0, 0xFFFFFFFF),
                          ("dst_ip", "glb_bv_bnd_dst", 1, 0xFFFFFFFF),
                          ("sport", "glb_bv_bnd_sport", 2, 65535),
                          ("dport", "glb_bv_bnd_dport", 3, 65535)):
        live = np.asarray(getattr(jt, bf))[:int(jt.glb_bv_nbnd[k])]
        live = live.astype(np.int64)
        pick = live[rng.integers(0, len(live), n)] + rng.integers(-1, 2, n)
        vals = np.where(np.arange(n) % 3 == 0, np.clip(pick, 0, top),
                        cols[f].astype(np.int64))
        vals[:2] = (0, top)
        cols[f] = vals.astype(np.uint32 if f.endswith("_ip") else np.int32)
    if max_if is not None:
        cols["rx_if"][2:6] = (-1, -3, 100, 7)  # wraps once, then clamps
    return packet_pair(cols)


def _narrow_rules(rng, n):
    """``n - 1`` narrow rules (prefixes /8 to /32, TCP or UDP, one
    port), so that first matches spread over the table, then deny-all."""
    rules = []
    for _ in range(n - 1):
        nets = [ipaddress.ip_network((int(rng.integers(0, 2**32))
                                      & _mask(int(plen)), int(plen)))
                for plen in rng.integers(8, 33, 2)]
        rules.append(ContivRule(
            action=Action.PERMIT if rng.random() < 0.5 else Action.DENY,
            src_network=nets[0], dest_network=nets[1],
            protocol=[Protocol.TCP, Protocol.UDP][int(rng.integers(0, 2))],
            dest_port=int(rng.choice([0, 80, 443, 8080, 53, 65535]))))
    return rules + [ContivRule(action=Action.DENY)]


@pytest.mark.parametrize("n_rules", [100, 1100])
def test_global_plain_and_kernel_model_match_reference(n_rules):
    """The global form: ``bv_first_set`` on CPU tensors (its plain
    version) and the kernel's NumPy model against the reference's
    ``bv_first_match`` over builder-committed tables whose live counts
    sit below the padded length (W = 4 at 128 rules: 8 lanes a packet;
    W = 36 at 1,152: 32 lanes and 16-byte chunks)."""
    rng = np.random.default_rng(n_rules)
    rules = _narrow_rules(rng, n_rules)
    cap = 128 if n_rules <= 128 else 1152
    b = jtables.TableBuilder(_cfg(max_global_rules=cap))
    b.set_global_table(rules)
    jt = b.to_device()
    tt = torch_tables(jt)
    assert (np.asarray(jt.glb_bv_nbnd) < jt.glb_bv_bnd_src.shape[0]).all()
    jp, tp = _edge_packets(rng, jt, 400, rules)
    m_j, r_j = jbv.bv_first_match(
        jt.glb_bv_bnd_src, jt.glb_bv_bnd_dst, jt.glb_bv_bnd_sport,
        jt.glb_bv_bnd_dport, jt.glb_bv_nbnd, jt.glb_bv_src, jt.glb_bv_dst,
        jt.glb_bv_sport, jt.glb_bv_dport, jt.glb_bv_proto, jp)
    want = np.where(np.asarray(m_j), np.asarray(r_j), _MISS)
    assert len(np.unique(want)) > 5  # distinct first rules, far ones too
    assert (want >= 64).any() and (want < 64).any()
    enc = tbv.bv_first_set(*tp.five_tuple, *tbv._glb_args(tt))
    np.testing.assert_array_equal(enc.numpy(), want)
    for vec4 in (True, False):
        _, menc, _ = _np_bv_kernel(tp.five_tuple, tbv._glb_args(tt),
                                   vec4=vec4)
        np.testing.assert_array_equal(menc, want)
    assert tbv.bv_first_set.launches == 0


def test_local_plain_and_kernel_model_match_reference():
    """The local form: (tid, enc) of ``bv_first_set`` on CPU tensors and
    of the kernel's model — interfaces with a table, the tableless pod
    and the uplink (tid -1), and rx_if values that wrap or clamp — against
    the reference's interface lookup and ``bv_first_match`` over each
    packet's own table; the pallas rung's verdicts against the
    reference's ``acl_classify_local_bv``."""
    rng = np.random.default_rng(31)
    rules = random_rules(rng, 60)
    _, jt = _tables(rules, rng=rng, n_local=3)
    tt = torch_tables(jt)
    jp, tp = _edge_packets(rng, jt, 256, rules, max_if=7)
    args = (*tp.five_tuple, *tbv._acl_args(tt))
    tid, enc = tbv.bv_first_set(*args, tp.rx_if, tt.if_local_table)
    want_tid = np.asarray(jt.if_local_table)[np.clip(
        np.where(np.asarray(jp.rx_if) < 0, np.asarray(jp.rx_if) + 8,
                 np.asarray(jp.rx_if)), 0, 7)]
    np.testing.assert_array_equal(tid.numpy(), want_tid)
    assert (want_tid == -1).any() and (want_tid >= 0).any()
    want = np.empty(256, np.int64)
    for t in range(int(jt.acl_bv_src.shape[0])):
        m_j, r_j = jbv.bv_first_match(
            *(getattr(jt, f)[t] for f in (
                "acl_bv_bnd_src", "acl_bv_bnd_dst", "acl_bv_bnd_sport",
                "acl_bv_bnd_dport", "acl_bv_nbnd", "acl_bv_src",
                "acl_bv_dst", "acl_bv_sport", "acl_bv_dport",
                "acl_bv_proto")), jp)
        sel = np.maximum(want_tid, 0) == t
        want[sel] = np.where(np.asarray(m_j), np.asarray(r_j), _MISS)[sel]
    np.testing.assert_array_equal(enc.numpy(), want)
    mtid, menc, _ = _np_bv_kernel(args[:5], args[5:], tp.rx_if.numpy(),
                                  tt.if_local_table.numpy())
    np.testing.assert_array_equal(mtid, want_tid)
    np.testing.assert_array_equal(menc, want)
    jv = jbv.acl_classify_local_bv(jt, jp)
    tv = tbv.acl_classify_local_pallas(tt, tp)
    assert_same(jv.permit, tv.permit, "permit")
    assert_same(jv.rule_idx, tv.rule_idx, "rule_idx")
    assert tbv.bv_first_set.launches == 0


def test_kernel_model_row_scan_over_rounds():
    """Rows wider than one round of a warp (W = 600: 150 chunks, two
    rounds at 32 lanes x 4 chunks), hits early, late, in the second
    round only and nowhere: the model's lane scan equals the plain
    first set."""
    rng = np.random.default_rng(12)
    p, w = 64, 600
    words = np.zeros((p, w), _U)
    for i in range(p):
        for j in rng.integers(0, w, int(rng.integers(0, 4))):
            words[i, j] |= _U(1) << _U(rng.integers(0, 32))
    words[0] = 0
    words[0, 599] = 1 << 31     # the last bit only
    words[1, 520:] = 0
    words[1, 530] = 5           # second round only
    words[2] = 0                # a miss
    ones = [torch.from_numpy(np.full((1, w), -1, np.int32))] * 4
    z = torch.zeros(p, dtype=torch.int32)
    want = tbv.bv_first_set_plain(*ones, torch.from_numpy(words.view(
        np.int32)), z, z, z, z, torch.arange(p, dtype=torch.int32)).numpy()
    for chunk in (4, 1):
        np.testing.assert_array_equal(_np_lane_first_set(words, 32, chunk),
                                      want)
    assert want[2] == _MISS and want[0] == 599 * 32 + 31
