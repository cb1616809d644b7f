"""vpptcp session rules: vpp_tpu_torch vs vpp_tpu.

* The reference's ``tests/test_vpptcp.py`` runs as written on the port
  (``port_case`` of ``tests/test_torch_agent.py``), its engines on the
  CPU.
* The connection filter: the port's plain PyTorch ``_filter_kernel``
  against the reference's jitted one on the same packed tables, built
  from a seed with priority ties between rules of opposite actions, so
  the verdict depends on which tied rule ``argmin`` picks (both pick the
  first); GLOBAL and LOCAL scopes, ``/0`` and ``/32`` prefixes,
  wildcard ports and dead rows past ``n``.
* Whole engines: seeded random rule sets applied to both packages'
  ``SessionRuleEngine`` (in two batches, with deletes), then the same
  connect and accept batches checked on each; the dumps are equal too.

Every quantity compared is a bool or an integer: the tolerance is exact
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_vpptcp as jvpptcp_tests
from test_torch_agent import case_names, run_reference_case
from vpp_tpu.hoststack import session_rules as jsr
from vpp_tpu_torch.hoststack import session_rules as tsr

VPPTCP_CASES = case_names(jvpptcp_tests)


def test_case_list():
    assert len(VPPTCP_CASES) == 6


@pytest.mark.parametrize("case", VPPTCP_CASES)
def test_reference_vpptcp_cases(case, tmp_path):
    run_reference_case(jvpptcp_tests, case, tmp_path, {})


NETS = (0x0A010100, 0x0A010200, 0x0A020000, 0xC0A80000, 0xFFFFFFFF, 0)
PLENS = (0, 8, 16, 24, 32)
PORTS = (0, 80, 443, 5432)


def _mask(plen):
    return 0 if plen == 0 else (0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF


def _random_pack(rng, cap=48):
    """Packed table columns as NumPy (uint32 addresses), with ~n live
    rows and priorities from a small range (many ties)."""
    n = int(rng.integers(cap // 2, cap + 1))
    # mostly wide prefixes and wildcard ports, so rules overlap
    lp = rng.choice(PLENS, cap, p=[.5, .1, .1, .1, .2])
    rp = rng.choice(PLENS, cap, p=[.5, .1, .1, .1, .2])
    lcl_mask = np.array([_mask(p) for p in lp], np.uint32)
    rmt_mask = np.array([_mask(p) for p in rp], np.uint32)
    return dict(
        ns=rng.choice([jsr.GLOBAL_NS, 1, 2, 3], cap).astype(np.int32),
        proto=rng.choice([6, 17], cap).astype(np.int32),
        lcl_net=rng.choice(NETS, cap).astype(np.uint32) & lcl_mask,
        lcl_mask=lcl_mask,
        rmt_net=rng.choice(NETS, cap).astype(np.uint32) & rmt_mask,
        rmt_mask=rmt_mask,
        lcl_port=rng.choice(PORTS, cap, p=[.7, .1, .1, .1]).astype(np.int32),
        rmt_port=rng.choice(PORTS, cap, p=[.7, .1, .1, .1]).astype(np.int32),
        action=rng.integers(0, 2, cap).astype(np.int32),
        prio=rng.integers(0, 4, cap).astype(np.int32),
    ), n


def _random_conns(rng, c=256):
    """Connection columns: (direction, ns, proto, lcl_ip, lcl_port,
    rmt_ip, rmt_port), addresses near the rule nets."""
    return np.stack([
        rng.integers(0, 2, c),
        rng.choice([1, 2, 3, 4], c),
        rng.choice([6, 17], c),
        rng.choice(NETS, c) + rng.integers(0, 3, c) * (rng.random(c) < .5),
        rng.choice(PORTS[1:] + (9999,), c),
        rng.choice(NETS, c) + rng.integers(0, 3, c) * (rng.random(c) < .5),
        rng.choice(PORTS[1:] + (9999,), c),
    ], axis=1).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_filter_matches_the_reference_with_priority_ties(seed):
    rng = np.random.default_rng(seed)
    cols, n = _random_pack(rng)
    conns = _random_conns(rng)
    conns[:, [3, 5]] &= 0xFFFFFFFF
    jpacked = jsr._Packed(**{k: jnp.asarray(v) for k, v in cols.items()},
                          n=jnp.int32(n))
    want = np.asarray(jsr._filter_kernel(
        jpacked, *(jnp.asarray(conns[:, i], jnp.int32) for i in (0, 1, 2)),
        jnp.asarray(conns[:, 3].astype(np.uint32)),
        jnp.asarray(conns[:, 4], jnp.int32),
        jnp.asarray(conns[:, 5].astype(np.uint32)),
        jnp.asarray(conns[:, 6], jnp.int32)))
    tpacked = tsr._Packed(**{k: torch.from_numpy(v.astype(
        np.int64) if v.dtype == np.uint32 else v) for k, v in cols.items()},
        n=n)
    c = torch.from_numpy(conns)
    got = tsr._filter_kernel(
        tpacked, *(c[:, i].to(torch.int32) for i in (0, 1, 2)), c[:, 3],
        c[:, 4].to(torch.int32), c[:, 5], c[:, 6].to(torch.int32))
    assert got.numpy().tolist() == want.tolist()
    # the seed produced verdicts of both kinds, and connections whose
    # best-priority matches hold both actions (the case the first-index
    # rule decides)
    assert 0 < int(want.sum()) < len(want)
    assert _opposite_ties(cols, n, conns) > 0


def _opposite_ties(cols, n, conns) -> int:
    """Connections whose lowest-priority matching rules disagree on the
    action (NumPy, the reference's match definition)."""
    d, ns, proto, lip, lport, rip, rport = (conns[:, i, None]
                                            for i in range(7))
    glob = cols["ns"][None] == jsr.GLOBAL_NS
    m = ((np.arange(len(cols["ns"]))[None] < n)
         & np.where(d == 1, glob, ~glob & (cols["ns"][None] == ns))
         & (cols["proto"][None] == proto)
         & ((lip & cols["lcl_mask"][None]) == cols["lcl_net"][None])
         & ((rip & cols["rmt_mask"][None]) == cols["rmt_net"][None])
         & ((cols["lcl_port"][None] == 0) | (cols["lcl_port"][None] == lport))
         & ((cols["rmt_port"][None] == 0) | (cols["rmt_port"][None] == rport)))
    prio = np.where(m, cols["prio"][None], 1 << 30)
    best = prio.min(axis=1, keepdims=True)
    tied = m & (prio == best)
    acts = [set(cols["action"][row].tolist()) for row in tied]
    return sum(len(a) == 2 for a in acts)


def _random_rules(rng, k):
    rules = []
    for i in range(k):
        scope = int(rng.choice([jsr.RuleScope.LOCAL, jsr.RuleScope.GLOBAL]))
        lp, rp = (int(x) for x in rng.choice(PLENS, 2))
        rules.append(dict(
            scope=scope,
            appns_index=(int(rng.choice([1, 2, 3]))
                         if scope == jsr.RuleScope.LOCAL else -1),
            transport_proto=int(rng.choice([6, 17])),
            lcl_net=int(rng.choice(NETS)) & _mask(lp), lcl_plen=lp,
            rmt_net=int(rng.choice(NETS)) & _mask(rp), rmt_plen=rp,
            lcl_port=int(rng.choice(PORTS)), rmt_port=int(rng.choice(PORTS)),
            action=int(rng.integers(0, 2)), tag=f"t{i % 5}"))
    return rules


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engines_agree_on_random_rule_sets(seed):
    rng = np.random.default_rng(seed)
    rules = _random_rules(rng, 60)
    engines = (jsr.SessionRuleEngine(capacity=64),
               tsr.SessionRuleEngine(capacity=64, device="cpu"))
    kinds = ((jsr.SessionRule, engines[0]), (tsr.SessionRule, engines[1]))
    for rule_cls, eng in kinds:
        eng.apply(add=[rule_cls(**r) for r in rules[:40]])
        eng.apply(add=[rule_cls(**r) for r in rules[40:]],
                  delete=[rule_cls(**r) for r in rules[:10]])
    conns = _random_conns(rng, 300) & 0xFFFFFFFF
    connect = [tuple(int(x) for x in row[1:]) for row in conns]
    accept = [tuple(int(x) for x in row[2:]) for row in conns]
    got = [(e.check_connect(connect).tolist(), e.check_accept(accept).tolist(),
            [tuple(r) for r in e.dump()], e.num_rules) for e in engines]
    assert got[1] == got[0]
    assert 0 < sum(got[0][0]) < len(connect)
    assert 0 < sum(got[0][1]) < len(accept)
