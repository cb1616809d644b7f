"""Incremental table uploads: vpp_tpu_torch's TableBuilder vs vpp_tpu's.

The same staging and the same churn go through both packages' builders:
(a) one global rule's port changed mid-table, (b) the same rule objects
committed again, (c) a pod add (interface, local table, /32 route),
(d) a route flap, (e) a backend roll on one service VIP, (f) a tenant's
rate, (g) an ML model swap, (h) a rule inserted at index 0 (every row
shifts: the whole upload) and (i) a bulk ``add_routes_np`` load. After
each swap every table field of the port equals the reference's
``to_device`` and the port's own full build (the derived LPM stack and
MXU operand included), the block paths run exactly where the
reference's do (spies on ``_glb_incremental``, ``_fib_incremental``,
``_svc_incremental``), a clean group moves 0 bytes and keeps its
tensors, and a ``Dataplane``'s step programs keep holding its tables.

Also: ``pack_rules_incremental`` against the reference's, the bulk
loader's staging and errors, a rolled-back transaction, the
``fib_snapshot`` upload record, and the upload-group tables themselves.
Every quantity is an integer (or an exactly copied float): the
tolerance is exact equality.
"""

import ipaddress

import numpy as np
import pytest
import torch

from vpp_tpu.ir.rule import Action as JAction
from vpp_tpu.ir.rule import ContivRule as JRule
from vpp_tpu.ir.rule import Protocol as JProto
from vpp_tpu.ml import model as jmodel
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline.transfer import (
    device_transfer_totals,
    transfer_budget,
)

from test_torch_tables import CPU, assert_same

_CFG = dict(
    max_tables=4, max_rules=16, max_global_rules=1024, max_ifaces=16,
    fib_slots=1024, sess_slots=256, nat_mappings=4, nat_backends=16,
    classifier="bv", fib_impl="lpm", fastpath=False, svc_vips=64,
    svc_backend_ways=4, fib_ecmp_groups=4, fib_ecmp_ways=4,
    tenancy="on", ml_stage="enforce", ml_hidden=8, ml_trees=2,
    ml_depth=2)
N_RULES = 1000
F = 8  # ML features the models read


def _cfg(mod, **over):
    return mod.DataplaneConfig(**dict(_CFG, **over))


def _ml_models():
    rng = np.random.default_rng(5)
    mlp = jmodel.MlModel(
        kind="mlp", n_features=F,
        w1=rng.integers(-50, 50, (F, 4)).astype(np.int8),
        b1=rng.integers(-999, 999, 4).astype(np.int32), s1=3,
        w2=rng.integers(-50, 50, 4).astype(np.int8), b2=5,
        flag_thresh=100).to_dict()
    forest = jmodel.MlModel(
        kind="forest", version=2, n_features=F,
        f_feat=rng.integers(0, F, (2, 2)).astype(np.int32),
        f_thresh=rng.integers(0, 256, (2, 2)).astype(np.int32),
        f_leaf=rng.integers(-500, 500, (2, 4)).astype(np.int32),
        b2=-1, flag_thresh=0).to_dict()
    return mlp, forest


MLP, FOREST = _ml_models()


def _rule(kinds, i, port=None):
    """Rule ``i`` of the global table in one package's classes: /24
    source blocks x ports, every 6th a deny (chip_smoke's shape)."""
    action, rule_cls, proto = kinds
    net = ipaddress.ip_network(f"172.{16 + (i % 1000) // 256}."
                               f"{i % 256}.0/24")
    return rule_cls(
        action=action.DENY if i % 6 == 5 else action.PERMIT,
        src_network=net, protocol=proto.TCP,
        dest_port=8000 + i % 20 if port is None else port)


def _local(kinds, k):
    action, rule_cls, proto = kinds
    return [rule_cls(action=action.PERMIT, protocol=proto.UDP,
                     dest_port=53 + k),
            rule_cls(action=action.DENY)]


J = (JAction, JRule, JProto)
T = (Action, ContivRule, Protocol)


class Side:
    """One package's builder, its rule list (the churn keeps unchanged
    rules as the same objects) and its last tables."""

    def __init__(self, mod, kinds, **kw):
        self.mod = mod
        self.kinds = kinds
        self.b = mod.TableBuilder(_cfg(mod), **kw)
        self.rules = [_rule(kinds, i) for i in range(N_RULES)]
        self.tables = None
        self.took = {}
        for name in ("_glb_incremental", "_fib_incremental",
                     "_svc_incremental"):
            self._spy(name)

    def _spy(self, name):
        orig = getattr(type(self.b), name)

        def spy(b, host_np, _orig=orig, _name=name):
            r = _orig(b, host_np)
            self.took[_name] = r
            return r
        setattr(self.b, name, spy.__get__(self.b))

    def last_upload_of(self, group):
        return self.b.last_upload[group]

    def swap(self):
        self.took = {}
        kw = {} if self.mod is jtables else {"into": self.tables}
        self.tables = self.b.to_device(sessions=self.tables, **kw)
        return self.tables


def _stage(s: Side):
    b = s.b
    b.set_interface(1, 2, apply_global=True)
    for i in range(2, 6):
        b.set_interface(i, 1, local_table=i - 2)
        b.set_local_table(i - 2, _local(s.kinds, i))
    b.set_global_table(s.rules)
    for h in range(300):
        b.add_route(f"10.1.{h // 200}.{h % 200}/32", 2 + h % 4,
                    int(jtables.Disposition.LOCAL))
    for n in range(40):
        b.add_route(f"10.{2 + n}.0.0/24", 1,
                    int(jtables.Disposition.REMOTE),
                    next_hop=0xC0A80000 + n, node_id=n)
    b.set_nh_group(1, [(0xC0A81001 + k, 1, 2 + k) for k in range(3)])
    b.add_route("10.99.0.0/16", 1, int(jtables.Disposition.REMOTE), group=1)
    b.add_route("0.0.0.0/0", 1, int(jtables.Disposition.REMOTE),
                next_hop=0xC0A8FFFE, snat=True)
    for v in range(20):
        b.set_service(0x0A600100 + v, 80, 6,
                      [(0x0AC80000 + 16 * v + j, 80, 1 + j % 2)
                       for j in range(3)])
    b.set_nat_mapping(0, 0x0A60000A, 80, 6, [(0x0A010102, 80, 1)], 0)
    b.set_snat_ip(0xC0A81001)
    b.set_vtep_ip(0xC0A81001)
    for t in (1, 2, 3, 4):
        b.set_tenant(t, prefixes=[f"172.{15 + t}.0.0/16"], vni=100 * t,
                     rate=64 * t, burst=256)
    b.set_ml_model(MLP)


def _churns():
    """name -> (mutation on a Side, glb / fib / svc spy results the
    reference must show: True/False, a byte count or None, or absent)."""
    def a(s):  # one rule's port at index 500
        s.rules = list(s.rules)
        s.rules[500] = _rule(s.kinds, 500, port=9999)
        s.b.set_global_table(s.rules)

    def b_(s):  # the same objects again
        s.b.set_global_table(list(s.rules))

    def c(s):  # a pod add
        s.b.set_interface(7, 1, local_table=3)
        s.b.set_local_table(3, _local(s.kinds, 7))
        s.b.add_route("10.1.2.7/32", 7, int(jtables.Disposition.LOCAL))

    def d(s):  # a route flap
        assert s.b.del_route("10.7.0.0/24")
        s.b.add_route("10.7.0.0/24", 1, int(jtables.Disposition.REMOTE),
                      next_hop=0xC0A80007, node_id=5)

    def e(s):  # a backend roll on one VIP
        s.b.set_service(0x0A600100 + 9, 80, 6,
                        [(0x0AC80000 + 16 * 9 + j, 80, 1)
                         for j in (1, 2, 5)])

    def f(s):
        s.b.set_tenant(4, prefixes=["172.19.0.0/16"], vni=400, rate=9,
                       burst=256)

    def g(s):
        s.b.set_ml_model(FOREST)

    def h(s):  # insert at 0, keep the count
        s.rules = [_rule(s.kinds, 5000)] + list(s.rules[:-1])
        s.b.set_global_table(s.rules)

    def i(s):  # bulk /32s
        n = 100
        nets = (0x0B000000 + np.arange(n, dtype=np.uint64) * 7).astype(
            np.uint32)
        s.b.add_routes_np(nets, np.full(n, 32, np.int32), tx_if=3,
                          disp=int(jtables.Disposition.LOCAL),
                          base_slot=800)

    return [("a", a), ("b", b_), ("c", c), ("d", d), ("e", e), ("f", f),
            ("g", g), ("h", h), ("i", i)]


CHURNS = _churns()
# the upload groups each churn dirties
DIRTY = {"a": {"glb", "glb_bv"}, "b": {"glb"}, "c": {"if", "acl", "fib"},
         "d": {"fib"}, "e": {"svc"}, "f": {"tenant"}, "g": {"ml"},
         "h": {"glb", "glb_bv"}, "i": {"fib"}}


@pytest.fixture(scope="module")
def sides():
    j = Side(jtables, J)
    t = Side(ttables, T, device="cpu")
    for s in (j, t):
        _stage(s)
        s.swap()
    return j, t


def _full_build(tb) -> dict:
    """The port's own full build of the staged state: every host field
    uploaded and every derived field derived from scratch."""
    host = {f: ttables.tensor_of(a, CPU)
            for f, a in tb.host_arrays().items()}
    return {**host, **ttables.derive(host)}


@pytest.mark.parametrize("name", [n for n, _ in CHURNS])
def test_churn_equals_reference_and_full_build(sides, name):
    """Run in order: each case applies its churn to the module's pair
    of builders, swaps, and holds the port against the reference."""
    j, t = sides
    fn = dict(CHURNS)[name]
    before = {f: getattr(t.tables, f) for f in ttables.TABLE_FIELDS}
    h2d = device_transfer_totals("h2d")
    for s in (j, t):
        fn(s)
    jt = j.swap()
    tt = t.swap()
    # every host field equals the reference's to_device
    for f in ttables.HOST_FIELDS:
        assert_same(getattr(jt, f), getattr(tt, f), f"{name}: {f}")
    # ... and the port's own full build, derived fields included
    full = _full_build(t.b)
    for f, want in full.items():
        assert torch.equal(getattr(tt, f), want), f"{name}: {f} (full)"
    # the block paths ran exactly where the reference's did
    assert t.took == j.took, (name, t.took, j.took)
    # in place: every tensor is the one the live tables held
    for f in ttables.TABLE_FIELDS:
        assert getattr(tt, f) is before[f], f"{name}: {f} replaced"
    # only the churn's groups moved bytes
    after = device_transfer_totals("h2d")
    moved = {g for g in ttables._UPLOAD_GROUPS
             if after.get(g, 0) != h2d.get(g, 0)}
    rec = t.b.last_upload
    assert moved <= DIRTY[name], (name, moved)
    for g in set(ttables._UPLOAD_GROUPS) - DIRTY[name]:
        assert rec[g] == {"path": "clean", "fields": [], "bytes": 0}, g


def test_churn_paths_are_the_references(sides):
    """Which path each churn took (after the parametrised cases ran in
    order on the module's builders): the last one, (i), loaded 100 /32s
    past the rows the diff base holds, a block of 256 slots."""
    j, t = sides
    assert j.took == t.took
    assert isinstance(t.took["_fib_incremental"], int)
    assert t.b.last_upload["fib"]["path"] == "block"
    assert t.b.last_upload["fib"]["blob_bytes"] == 9 * 256 * 4


@pytest.mark.parametrize("name,want", [
    ("a", {"_glb_incremental": True}), ("b", {"_glb_incremental": True}),
    ("c", {"_fib_incremental": 9 * 256 * 4}),
    ("d", {"_fib_incremental": 9 * 256 * 4}),
    ("e", {"_svc_incremental": (5 * 8 + 2 * 8 * 4) * 4}),
    ("h", {"_glb_incremental": False})])
def test_block_paths_where_the_reference_takes_them(name, want):
    """Fresh builders, one churn: the spies read the reference's path
    and byte count on both sides."""
    j = Side(jtables, J)
    t = Side(ttables, T, device="cpu")
    for s in (j, t):
        _stage(s)
        s.swap()
        dict(CHURNS)[name](s)
        s.swap()
    assert j.took == want
    assert t.took == want
    for f in ttables.HOST_FIELDS:
        assert_same(getattr(j.tables, f), getattr(t.tables, f), f)


def test_clean_swap_moves_nothing_and_programs_hold():
    """A Dataplane: after its first step, a swap with nothing staged
    moves 0 bytes and replaces no tensor, a route flap moves only fib
    bytes, and every step program still holds the live tables (nothing
    is rebuilt)."""
    dp = tdp.Dataplane(_cfg(ttables), device="cpu")
    s = Side.__new__(Side)
    s.b, s.kinds, s.rules = dp.builder, T, [_rule(T, i)
                                            for i in range(N_RULES)]
    _stage(s)
    dp.swap()
    pkts = tdp.PacketVector(*[torch.zeros(8, dtype=torch.int32)
                              for _ in range(9)])
    dp.process(pkts, now=5)
    progs = dict(dp._programs)
    assert progs
    held = {f: getattr(dp.tables, f) for f in ttables.TABLE_FIELDS}
    with transfer_budget(0, "h2d") as tb:
        dp.swap()
    assert tb.spent == 0
    with transfer_budget(1 << 20, "h2d") as tb:
        assert dp.builder.del_route("10.7.0.0/24")
        dp.swap()
    assert set(tb.moved()) == {"fib"}
    assert dp._programs == progs
    assert all(p.holds(dp.tables) for p in dp._programs.values())
    for f, t in held.items():
        assert getattr(dp.tables, f) is t, f


def test_without_into_earlier_tables_keep_their_values():
    """No ``into``: a dirty field gets a new tensor (the block path
    writes a copy), a clean one is shared."""
    t = Side(ttables, T, device="cpu")
    _stage(t)
    t1 = t.b.to_device()
    keep = {f: getattr(t1, f).clone() for f in ttables.TABLE_FIELDS}
    dict(CHURNS)["a"](t)
    t.took = {}
    t2 = t.b.to_device(sessions=t1)
    assert t.took == {"_glb_incremental": True}
    for f in ttables.TABLE_FIELDS:
        assert torch.equal(getattr(t1, f), keep[f]), f
    assert t2.glb_dport_lo is not t1.glb_dport_lo
    assert t2.glb_mxu_op is not t1.glb_mxu_op
    assert t2.fib_prefix is t1.fib_prefix


@pytest.mark.parametrize("seed", range(4))
def test_pack_rules_incremental_matches_reference(seed):
    """Random edits of a rule list (replace, keep, shrink, grow): the
    same packed arrays, cached rows and changed indices, rows past a
    shrunk end included."""
    rng = np.random.default_rng(seed)
    n = 60
    jr = [_rule(J, i) for i in range(n)]
    tr = [_rule(T, i) for i in range(n)]
    jprev = jrows = tprev = trows = None
    for _ in range(4):
        jp, jrows2, jch = jtables.pack_rules_incremental(jr, 64, jprev,
                                                         jrows)
        tp, trows2, tch = ttables.pack_rules_incremental(tr, 64, tprev,
                                                         trows)
        for k in jp:
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        np.testing.assert_array_equal(trows2, jrows2)
        if jch is None:
            assert tch is None
        else:
            np.testing.assert_array_equal(tch, jch)
        jprev, jrows, tprev, trows = list(jr), jrows2, list(tr), trows2
        m = int(rng.integers(30, 64))
        jr, tr = jr[:m], tr[:m]
        for i in rng.choice(len(jr), 5, replace=False):
            port = int(rng.integers(1, 60000))
            jr[i] = _rule(J, int(i), port)
            tr[i] = _rule(T, int(i), port)
        while len(jr) < m:
            jr.append(_rule(J, len(jr)))
            tr.append(_rule(T, len(tr)))


def _bulk_cfg(mod, **over):
    return mod.DataplaneConfig(**dict(dict(
        max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
        fib_slots=256, sess_slots=64, nat_mappings=2, nat_backends=4,
        fib_impl="lpm"), **over))


def test_add_routes_np_stages_the_references_arrays():
    rng = np.random.default_rng(3)
    n = 120
    plens = rng.choice([8, 16, 24, 32], n).astype(np.int32)
    nets = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    kw = dict(tx_if=rng.integers(1, 8, n).astype(np.int32),
              disp=rng.integers(0, 4, n).astype(np.int32),
              next_hop=rng.integers(0, 2 ** 32, n, dtype=np.uint64
                                    ).astype(np.uint32),
              node_id=3, snat=1, group=rng.integers(-1, 4, n),
              base_slot=20)
    out = []
    for mod, extra in ((jtables, {}), (ttables, {"device": "cpu"})):
        b = mod.TableBuilder(_bulk_cfg(mod, fib_ecmp_groups=4), **extra)
        b.add_route("10.0.0.0/8", 1, 1)
        assert b.add_routes_np(nets, plens, **kw) == n
        b.add_routes_np(nets[:10], np.full(10, 24, np.int32), 2, 1,
                        base_slot=40)  # overwrite slots of other lengths
        out.append(b.host_arrays())
    ja, ta = out
    for f in ja:
        np.testing.assert_array_equal(np.asarray(ta[f]), np.asarray(ja[f]),
                                      err_msg=f)


@pytest.mark.parametrize("case", ["range", "no_groups", "base"])
def test_add_routes_np_refuses_like_reference(case):
    """tests/test_lpm.py ``test_bulk_loader_validates_group_range``'s
    cases and the slot range, with the reference's messages."""
    nets = np.array([0x0A000000], np.uint32)
    plens = np.array([8], np.int32)
    msgs = []
    for mod, extra in ((jtables, {}), (ttables, {"device": "cpu"})):
        over = {} if case == "no_groups" else {"fib_ecmp_groups": 4}
        b = mod.TableBuilder(_bulk_cfg(mod, **over), **extra)
        with pytest.raises(ValueError) as err:
            if case == "base":
                b.add_routes_np(nets, plens, tx_if=1, disp=1,
                                base_slot=256)
            else:
                b.add_routes_np(nets, plens, tx_if=1, disp=1,
                                group=7 if case == "range" else 0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert {"range": "0..3", "no_groups": "fib_ecmp_groups",
            "base": "exceed fib_slots"}[case] in msgs[1]


def test_rolled_back_transaction_gives_the_references_tables():
    """A transaction that stages rule, route, service and tenant churn
    and then fails: ``state_restore`` rolls the staging back, and the
    next swap (whole uploads: the diff bases reset) equals the
    reference's."""
    sides = []
    for mod, kinds, extra in ((jtables, J, {}),
                              (ttables, T, {"device": "cpu"})):
        s = Side(mod, kinds, **extra)
        _stage(s)
        s.swap()
        snap = s.b.state_snapshot()
        try:
            dict(CHURNS)["a"](s)
            dict(CHURNS)["d"](s)
            dict(CHURNS)["e"](s)
            s.b.set_tenant(2, prefixes=["172.17.0.0/16"], vni=200,
                           rate=1, burst=2)
            raise RuntimeError("the transaction fails mid-way")
        except RuntimeError:
            s.b.state_restore(snap)
        s.swap()
        sides.append(s)
    j, t = sides
    for f in ttables.HOST_FIELDS:
        assert_same(getattr(j.tables, f), getattr(t.tables, f), f)
    full = _full_build(t.b)
    for f, want in full.items():
        assert torch.equal(getattr(t.tables, f), want), f
    # the fib and svc diff bases were reset (they ship whole); the glb
    # one is not, and the restored rows equal it (a content-identical
    # commit)
    assert j.took == t.took
    assert t.took["_glb_incremental"] is True
    assert t.last_upload_of("glb") == {"path": "clean", "fields": [],
                                       "bytes": 0}
    assert t.took["_fib_incremental"] is None
    assert t.took["_svc_incremental"] is None
    # and the next churn takes the block path again
    for s in sides:
        dict(CHURNS)["d"](s)
        s.swap()
    assert j.took == t.took == {"_fib_incremental": 9 * 256 * 4}


def test_fib_snapshot_reports_the_upload_record():
    """``fib_snapshot()["upload"]`` has the reference's keys and values
    (but the host ms), and ``lpm_build_ms`` is the restage's."""
    snaps = []
    for mod, extra in ((jdp, {}), (tdp, {"device": "cpu"})):
        dp = mod.Dataplane(_bulk_cfg(
            jtables if mod is jdp else ttables, fib_slots=1024), **extra)
        up = dp.add_uplink()
        for k in range(20):
            dp.builder.add_route(f"10.0.{k}.0/24", up, 2)
        dp.swap()
        dp.builder.del_route("10.0.3.0/24")
        dp.builder.add_route("10.0.3.0/24", up, 2, next_hop=7)
        dp.swap()
        snaps.append(dp.fib_snapshot())
    js, ts = snaps
    assert set(ts["upload"]) == set(js["upload"]) == {
        "fields", "blob_bytes", "bytes", "ms"}
    assert tuple(ts["upload"]["fields"]) == tuple(js["upload"]["fields"])
    for k in ("blob_bytes", "bytes"):
        assert ts["upload"][k] == js["upload"][k], k
    assert ts["upload"]["blob_bytes"] == 9 * 256 * 4
    assert ts["lpm_build_ms"] > 0.0


def test_upload_groups_are_the_references():
    assert ttables._UPLOAD_GROUPS == jtables._UPLOAD_GROUPS
    assert ttables._FIB_SLOT_FIELDS == jtables._FIB_SLOT_FIELDS
    assert ttables._GLB_ROW_FIELDS == jtables._GLB_ROW_FIELDS
    assert ttables._GLB_BV_DIM_FIELDS == jtables._GLB_BV_DIM_FIELDS
    assert (ttables._SVC_1D_FIELDS, ttables._SVC_2D_FIELDS) == (
        jtables._SVC_1D_FIELDS, jtables._SVC_2D_FIELDS)
    rng = np.random.default_rng(0)
    for total in (300, 1024, 5000):
        for _ in range(20):
            changed = rng.random(total) < rng.choice([0.0, 0.001, 0.01])
            assert ttables._block_of(changed, total) == \
                jtables._block_of(changed, total)


def test_add_routes_np_restages_the_lengths_it_overwrites():
    """Slots overwritten by the bulk loader drop out of their old
    length's LPM plane: the planes equal a builder that staged the final
    routes one by one. (The reference reads the old lengths through a
    view of ``fib_plen`` taken before the write, so after the write it
    sees the new ones: its /24 plane keeps 10.0.0.0 -> slot 0 although
    slot 0 now holds a /32. ROADMAP.md records the difference.)"""
    out = {}
    for mod, extra in ((jtables, {}), (ttables, {"device": "cpu"})):
        b = mod.TableBuilder(_bulk_cfg(mod), **extra)
        b.add_route("10.0.0.0/24", 1, 2)
        assert b.lpm_ok()  # the /24 plane is staged
        b.add_routes_np(np.array([0x0A010001], np.uint32),
                        np.array([32], np.int32), tx_if=1, disp=2)
        out[mod] = b.host_arrays()
    fresh = ttables.TableBuilder(_bulk_cfg(ttables), device="cpu")
    fresh.add_route("10.1.0.1/32", 1, 2, slot=0)
    want = fresh.host_arrays()
    for f in ttables._UPLOAD_GROUPS["fib"]:
        np.testing.assert_array_equal(out[ttables][f], want[f], err_msg=f)
    assert int(out[jtables]["fib_lpm_cnt"][24]) == 1
    assert int(out[ttables]["fib_lpm_cnt"][24]) == 0
