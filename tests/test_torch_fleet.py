"""The gateway fleet: vpp_tpu_torch/fleet + io/fleet.py vs vpp_tpu's.

* The reference's own suites run as written on the port
  (``test_torch_hoststack.run_case``): ``tests/test_fleet.py`` (the
  hash twin, rendezvous, membership epochs, steering, live migration,
  its chaos schedule, the pump, the collector and ``show fleet``, NAT
  cold starts; its parametrised case once per parameter) and
  ``tests/test_backoff.py`` (jittered backoff, and membership watchers
  across a store server restart). The instances are the port's
  ``Dataplane`` on the CPU; the suite's ``jnp`` reads the port's
  tensors through NumPy and hands its hash twin test the port's int32
  bit patterns.
* ``canon_mix_np`` is held bit-exact against the port's
  ``ops.session.canon_mix`` and the reference's on 10^5 seeded
  5-tuples, with the uint32 edges (0, 1, 2^31 - 1, 2^31, 2^32 - 1,
  hairpins) forced in.
* A whole small fleet per package, fed the same frames through its
  ``FleetPump``, with a live migration between rounds: the steering,
  the ownership map, every instance's session and NAT state, the aux
  riders and the conservation terms are equal.

Every quantity compared is an integer or a bit pattern: the tolerance
is exact equality.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

# the reference suites and every reference module they reach, imported
# here, outside any ``port_imports`` block (which drops the reference
# modules first imported inside it): a second copy of ``faults`` would
# install a plan in one copy and fire the other
import test_backoff as jbackoff_tests
import test_fleet as jfleet_tests
import vpp_tpu.cli  # noqa: F401
import vpp_tpu.fleet.steering  # noqa: F401
import vpp_tpu.io.fleet  # noqa: F401
import vpp_tpu.ops.session  # noqa: F401
import vpp_tpu.stats.collector  # noqa: F401
import vpp_tpu.testing.faults  # noqa: F401
from test_torch_agent import case_names
from test_torch_hoststack import run_case
from vpp_tpu.fleet import hashring as jhash
from vpp_tpu.fleet import steering as jsteer
from vpp_tpu.io import fleet as jiofleet
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.testing import faults as jfaults
from vpp_tpu_torch.fleet import hashring as thash
from vpp_tpu_torch.fleet import steering as tsteer
from vpp_tpu_torch.io import fleet as tiofleet
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.testing import faults as tfaults


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    tfaults.uninstall()
    jfaults.uninstall()


def _as_bits(a) -> torch.Tensor:
    """A host array as the port holds it: uint32 values as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


# the suite's ``jnp``: sums read the port's CPU tensors through NumPy,
# and ``asarray`` gives the port's hash the int32 bit patterns it takes
FLEET_JNP = types.SimpleNamespace(
    sum=lambda a, *k, **kw: np.asarray(a).sum(*k, **kw),
    asarray=_as_bits)


def _cases(module) -> list:
    """Every case of ``module``, a parametrised one once per value."""
    out = []
    for name in case_names(module):
        obj = vars(module)[name.split(".")[0]]
        if "." in name:
            obj = vars(obj)[name.split(".")[1]]
        marks = [m for m in getattr(obj, "pytestmark", ())
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, {}))
            continue
        (mark,) = marks
        argname = mark.args[0]
        out += [(name, {argname: v}) for v in mark.args[1]]
    return out


FLEET_CASES = _cases(jfleet_tests)
BACKOFF_CASES = _cases(jbackoff_tests)


def test_case_lists():
    """Every case of the two reference suites runs here: 33 test
    functions of test_fleet.py (34 cases) and 7 of test_backoff.py."""
    assert len({n for n, _ in FLEET_CASES}) == 33
    assert (len(FLEET_CASES), len(BACKOFF_CASES)) == (34, 7)


def _ids(cases):
    return [n + "".join(f"[{k}={v}]" for k, v in kw.items())
            for n, kw in cases]


@pytest.mark.parametrize("case", FLEET_CASES, ids=_ids(FLEET_CASES))
def test_reference_fleet_cases(case, request):
    name, params = case
    run_case(jfleet_tests, name, request, names={"jnp": FLEET_JNP},
             params=params)


@pytest.mark.parametrize("case", BACKOFF_CASES, ids=_ids(BACKOFF_CASES))
def test_reference_backoff_cases(case, request):
    name, params = case
    run_case(jbackoff_tests, name, request, params=params)


# --- the hash pact, across both packages ---------------------------------

U32_EDGES = np.array([0, 1, 2, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000,
                      0x80000001, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _seeded_tuples(n: int, seed: int):
    """``n`` 5-tuples (uint32 columns): random, then the uint32 and
    port edges in every pairing, an eighth of them hairpins (src ==
    dst, tie-broken by port)."""
    rs = np.random.default_rng(seed)
    src = rs.integers(0, 1 << 32, n, dtype=np.uint32)
    dst = rs.integers(0, 1 << 32, n, dtype=np.uint32)
    sp = rs.integers(0, 1 << 16, n, dtype=np.uint32)
    dp = rs.integers(0, 1 << 16, n, dtype=np.uint32)
    pr = rs.integers(0, 256, n, dtype=np.uint32)
    e = len(U32_EDGES)
    src[:e * e] = np.repeat(U32_EDGES, e)
    dst[:e * e] = np.tile(U32_EDGES, e)
    port_edges = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF], np.uint32)
    sp[:e * e] = port_edges[np.arange(e * e) % 5]
    dp[:e * e] = port_edges[(np.arange(e * e) // 5) % 5]
    pr[:e * e] = np.array([0, 1, 6, 17, 255], np.uint32)[
        np.arange(e * e) % 5]
    h = slice(e * e, e * e + n // 8)
    dst[h] = src[h]
    return src, dst, sp, dp, pr


def test_canon_mix_np_is_bit_exact_against_both_device_hashes():
    """``canon_mix_np`` (the port's copy), the port's ``canon_mix`` on
    int32 bit patterns and the reference's on uint32 give the same bits
    on 10^5 seeded tuples, the uint32 edges included; the reference's
    ``canon_mix_np`` too."""
    import jax.numpy as jnp

    from vpp_tpu.ops.session import canon_mix as jcanon

    cols = _seeded_tuples(100_000, 16)
    host = thash.canon_mix_np(*cols)
    assert host.dtype == np.uint32
    assert np.array_equal(host, jhash.canon_mix_np(*cols))
    port = tsess.canon_mix(*(_as_bits(c) for c in cols)).numpy()
    assert np.array_equal(host, port.astype(np.uint32))
    assert port.min() >= 0 and port.max() < (1 << 32)
    ref = np.asarray(jcanon(*(jnp.asarray(c) for c in cols)))
    assert np.array_equal(host, ref.astype(np.uint32))
    # direction invariance on the same sample
    src, dst, sp, dp, pr = cols
    assert np.array_equal(host, thash.canon_mix_np(dst, src, dp, sp, pr))


# --- a whole fleet per package, the same frames ---------------------------

_SMALL_DP = dict(
    max_tables=2, max_rules=16, max_global_rules=16, max_ifaces=8,
    fib_slots=16, sess_slots=1024, sess_ways=4, nat_mappings=2,
    nat_backends=2, sess_sweep_stride=0, sess_hash="sym")
VIP = "10.96.0.10"


def _fleet_dp(dp_mod, tables_mod, vector_mod, rule_mod, **kw):
    """One instance of the reference suite's ``build_dp`` shape, plus a
    service mapping so that NAT sessions exist, on one package."""
    ip4 = vector_mod.ip4
    dp = dp_mod.Dataplane(tables_mod.DataplaneConfig(**_SMALL_DP), **kw)
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "web"))
    dp.builder.add_route("10.1.1.0/24", pod, vector_mod.Disposition.LOCAL)
    dp.builder.add_route("0.0.0.0/0", up, vector_mod.Disposition.REMOTE,
                         node_id=1)
    dp.builder.set_global_table([
        rule_mod.ContivRule(action=rule_mod.Action.PERMIT,
                            protocol=rule_mod.Protocol.TCP),
        rule_mod.ContivRule(action=rule_mod.Action.DENY)])
    dp.builder.set_nat_mapping(0, ip4(VIP), 80, 6,
                               [(ip4("10.1.1.2"), 80, 1)], boff=0)
    dp.swap()
    return dp


def _frames(seed: int, n: int) -> np.ndarray:
    """``n`` packed packets: forward flows to the pod and to the VIP,
    and the pod's replies to half of them (the reference's packer)."""
    from vpp_tpu.pipeline.vector import make_packet_vector

    rs = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        host = f"10.9.{int(rs.integers(0, 40))}.{int(rs.integers(1, 200))}"
        sport = int(rs.integers(1024, 60000))
        kind = int(rs.integers(0, 3))
        if kind == 2:
            rows.append({"src": "10.1.1.2", "dst": host, "proto": 6,
                         "sport": 80, "dport": sport, "rx_if": 2,
                         "ttl": 64})
        else:
            rows.append({"src": host, "dst": "10.1.1.2" if kind == 0
                         else VIP, "proto": 6, "sport": sport,
                         "dport": 80, "rx_if": 1, "ttl": 64})
    return jfleet_tests.pack_pv(make_packet_vector(rows, n=n))


def _state(dp) -> dict:
    """Every session column of one instance as uint32/int32 bits."""
    out = {}
    for f, dt in ttables.SESSION_FIELDS.items():
        a = np.asarray(getattr(dp.tables, f))
        out[f] = a.astype(np.int64).astype(dt).view(np.int32) \
            if a.dtype != np.int32 else a
    return out


def test_fleet_with_a_migration_equals_the_reference_fleet():
    """Three rounds of the same frames through a reference fleet and a
    port fleet (two instances, then a third joining with a live
    rebalance between rounds, the clocks pinned): every round's
    steering, ownership, aux riders, conservation terms and every
    instance's session and NAT columns are equal."""
    from vpp_tpu.ir import rule as jrule
    from vpp_tpu.pipeline import vector as jvector
    from vpp_tpu_torch.ir import rule as trule
    from vpp_tpu_torch.pipeline import vector as tvector

    cell = [100]
    pkgs = {
        "ref": (jdp, jtables, jvector, jrule, {}, jsteer, jiofleet),
        "port": (tdp, ttables, tvector, trule, {"device": "cpu"}, tsteer,
                 tiofleet),
    }
    fleets = {}
    for name, (dpm, tm, vm, rm, kw, sm, pm) in pkgs.items():
        dps = {}
        for inst in ("gw0", "gw1", "gw2"):
            dp = _fleet_dp(dpm, tm, vm, rm, **kw)
            dp.clock_ticks = lambda: cell[0]
            dps[inst] = dp
        two = {k: dps[k] for k in ("gw0", "gw1")}
        fleets[name] = (dps, sm.FleetSteering(two, n_ranges=16), sm, pm)

    def drive(frame: np.ndarray) -> dict:
        out = {}
        for name, (dps, st, _sm, pm) in fleets.items():
            pump = pm.FleetPump(st, frame_width=64, queue_slots=64)
            pump.start()
            pump.submit(frame)
            pump.stop()
            snap = pump.stats_snapshot()
            out[name] = (snap, pump.conservation(), st.stats_snapshot(),
                         {k: _state(d) for k, d in dps.items()})
        return out

    def same(got):
        (rs, rc, rst, rstate), (ps, pc, pst, pstate) = \
            got["ref"], got["port"]
        assert rs == ps and rc == pc and rst == pst
        assert rc["offered"] == (rc["delivered"] + rc["fenced_drops"]
                                 + rc["no_owner_drops"] + rc["queue_drops"]
                                 + rc["pending"])
        for inst in rstate:
            for f in rstate[inst]:
                assert np.array_equal(rstate[inst][f], pstate[inst][f]), \
                    (inst, f)

    same(drive(_frames(0, 512)))
    cell[0] = 140
    same(drive(_frames(1, 512)))
    # a third instance joins: the rendezvous target over three members,
    # each moved range drained, adopted, committed and released
    for name, (dps, st, sm, pm) in list(fleets.items()):
        st3 = sm.FleetSteering(dps, membership=st.membership, n_ranges=16)
        fleets[name] = (dps, st3, sm, pm)
    moved = {n: f[1].rebalance() for n, f in fleets.items()}
    assert moved["ref"] == moved["port"] > 0
    assert fleets["ref"][1].owners() == fleets["port"][1].owners()
    cell[0] = 180
    got = drive(_frames(1, 512))  # the same flows, now on three owners
    same(got)
    assert got["port"][2]["migrated_sessions"] > 0
    assert got["port"][2]["nat_coldstarts"] > 0
