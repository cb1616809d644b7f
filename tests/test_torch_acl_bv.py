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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ops import acl as jacl
from vpp_tpu.ops import acl_bv as jbv
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu_torch.ops import acl as tacl
from vpp_tpu_torch.ops import acl_bv as tbv
from vpp_tpu_torch.pipeline import tables as ttables

from test_acl_bv import _tables, random_packets, random_rules
from test_pallas_kernels import _np_first_rule
from test_torch_tables import assert_same, torch_packets, torch_tables

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
    enc_t = tbv.bv_first_set(*planes, idx, idx, idx, idx, idx)
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
    enc = tbv.bv_first_set(*planes, *rows, table=table)
    for t in range(t_):
        sel = table == t
        one = tbv.bv_first_set(*(pl[t] for pl in planes),
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
    enc = tbv.bv_first_set(*tbv._glb_planes(tt), *tbv._global_rows(tt, tp))
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
