"""The cluster data plane: vpp_tpu_torch/parallel vs vpp_tpu/parallel.

* The reference's ``tests/test_cluster.py`` runs on the port: every case
  that is not slow-marked, through ``test_torch_hoststack.run_case``
  (the module's names and imports bound to the port, meshes on the
  CPU). ``NOT_RUN`` names the rest.
* A differential: the same seeded cluster staged in both packages (pods
  on every node, fabric routes to every peer, a rule-sharded global
  table, a ClusterIP service whose backends sit on other nodes) steps
  the same seeded traffic — forward vectors a quarter of which cross
  the fabric, then the replies, then both mixed — and after every step
  each ``ClusterStepResult`` field (``interop.cluster_result_to_numpy``)
  and every session plane are equal. The geometries are 2 x 2 and
  4 x 2; the classifiers ``dense``, ``bv`` and ``mxu``; the fast path on
  and off; the fabric budget 0 and one that overflows; ``step_wire``
  with payload bytes; ``expire_sessions``; a swap that carries the
  sessions. ``tests/test_torch_cluster_rungs.py`` holds the rest of its
  cases (``mxu`` at 4 x 2, ``dense`` at 2 x 2, the ``lpm`` FIB rung) and
  the cluster against standalone Dataplanes,
  ``tests/test_torch_cluster_ml.py`` the ML stage's.
* The port's cluster captured (``graphs=True``) against the same
  cluster eager (``graphs=False``).

The reference's cluster step runs under ``shard_map``, whose varying-
manual-axes check rejects its ``lax.cond`` dispatch on the installed
JAX ("cond branches must have equal output types"; that is why the
reference's own mesh cases fail here). The module-scoped fixture
``ref_mesh`` wraps the reference module's ``shard_map`` to pass
``check_vma=False`` (when the installed ``shard_map`` takes it) for the
length of this module, clearing the reference's step cache on entry and
exit, so no other test sees the patch. Nothing under ``vpp_tpu/``
changes.

Every quantity compared is an integer: the tolerance is exact equality.
"""

from __future__ import annotations

import inspect
import ipaddress

import numpy as np
import pytest

import test_cluster as jcluster_tests
import vpp_tpu.parallel.cluster as jcluster
from test_torch_agent import case_names
from test_torch_hoststack import run_case
from vpp_tpu.ipam import IPAM as JIPAM
from vpp_tpu.ir import rule as jrule
from vpp_tpu.parallel import mesh as jmesh
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch import interop
from vpp_tpu_torch.ipam import IPAM as TIPAM
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.parallel import cluster as tcluster
from vpp_tpu_torch.parallel import mesh as tmesh
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.pipeline.tables import SESSION_FIELDS


@pytest.fixture(scope="module")
def ref_mesh():
    """The reference's cluster step with ``check_vma=False`` (module
    doc), for this module only."""
    orig = jcluster.shard_map
    takes = "check_vma" in inspect.signature(
        getattr(__import__("jax"), "shard_map", orig)).parameters

    def shard_map(*args, **kwargs):
        if takes:
            kwargs.setdefault("check_vma", False)
        return orig(*args, **kwargs)

    jcluster.make_cluster_step.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcluster, "shard_map", shard_map)
        yield
        jcluster.make_cluster_step.cache_clear()


# --- the reference's suite on the port ----------------------------------

SLOW = "slow-marked in the reference suite; "
NOT_RUN = {
    "test_renderer_drives_cluster_nodes": SLOW + "node bring-up is held by "
    "test_cross_node_forwarding here and the mesh agent's renderers by "
    "tests/test_torch_mesh_agent.py",
    "test_mxu_sharded_equals_dense_sharded_at_scale": SLOW + "the mxu rung "
    "is held against the reference's at 4 x 2 in "
    "tests/test_torch_cluster_rungs.py, and at 10,240 rules against the "
    "port's CPU twin by chip_smoke.py's phase 4m",
    "test_fib_lpm_sharded_equals_dense_sharded": SLOW + "the lpm rung is "
    "held against the reference's, nested prefixes included, in "
    "tests/test_torch_cluster_rungs.py",
    "test_wire_step_carries_payload_across_fabric": SLOW + "step_wire's "
    "payload rows are held against the reference's in the differential "
    "(the wire cases)",
}
CLUSTER_CASES = [c for c in case_names(jcluster_tests) if c not in NOT_RUN]


def test_case_list():
    """The four non-slow cases run; NOT_RUN names the four slow ones."""
    slow = {name for name in case_names(jcluster_tests)
            if any(m.name == "slow" for m in getattr(
                getattr(jcluster_tests, name), "pytestmark", ()))}
    assert slow == set(NOT_RUN) and len(CLUSTER_CASES) == 4


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_reference_cluster_cases(case, request):
    run_case(jcluster_tests, case, request)


# --- the differential ----------------------------------------------------

class Pkg:
    """One package's names for building a cluster."""

    def __init__(self, port: bool):
        self.port = port
        self.IPAM = TIPAM if port else JIPAM
        self.rule = trule if port else jrule
        self.tables = ttables if port else jtables
        self.vector = tvector if port else jvector
        self.cluster = tcluster if port else jcluster

    def mesh(self, n, s):
        if self.port:
            return tmesh.cluster_mesh(n, s, devices=["cpu"] * (n * s))
        return jmesh.cluster_mesh(n, s)


PORT, REF = Pkg(True), Pkg(False)

BASE = dict(max_tables=4, max_rules=16, max_global_rules=256, max_ifaces=16,
            fib_slots=64, sess_slots=512, nat_mappings=4, nat_backends=16,
            sess_sweep_stride=16, sess_max_age=40)
PODS = 3
VIP, VIP_PORT = "10.96.0.10", 80


def _rules(pkg, seed: int):
    r = pkg.rule
    rng = np.random.default_rng(seed)
    out = [r.ContivRule(action=r.Action.DENY, protocol=r.Protocol.TCP,
                        src_network=ipaddress.ip_network(
                            f"10.{int(rng.integers(1, 5))}.{i % 4}.0/24"),
                        dest_port=int(rng.integers(7000, 7016)))
           for i in range(90)]
    out.insert(70, r.ContivRule(action=r.Action.DENY,
                                protocol=r.Protocol.UDP, dest_port=5353))
    return out + [r.ContivRule(action=r.Action.PERMIT)]


def stage_node(pkg, node, nid, n_nodes, seed=0, model=None, nested=False):
    """Stage node ``nid`` of ``n_nodes`` (a cluster's node handle or a
    standalone Dataplane, the same surface): PODS pods, fabric routes to
    every peer's pod network, the seeded global table and, where given,
    the ML model. With ``nested`` a /16 across the fabric to the next
    node and /24s inside it back to a local pod: the longest-match
    decisions where the FIB rungs could part. Returns ({pod: ip},
    {pod: if})."""
    pod_ip, pod_if = {}, {}
    uplink = node.add_uplink()
    ipam = pkg.IPAM(nid + 1)
    for p in range(PODS):
        pod = f"ns/pod{nid}-{p}"
        ip = ipam.next_pod_ip(pod)
        idx = node.add_pod_interface(pod)
        pod_ip[pod], pod_if[pod] = str(ip), idx
        node.builder.add_route(f"{ip}/32", idx,
                               pkg.vector.Disposition.LOCAL)
    for other in range(n_nodes):
        if other != nid:
            node.builder.add_route(
                str(ipam.other_node_pod_network(other + 1)), uplink,
                pkg.vector.Disposition.REMOTE, node_id=other)
    if nested:
        node.builder.add_route(
            "10.2.0.0/16", uplink, pkg.vector.Disposition.REMOTE,
            node_id=(nid + 1) % n_nodes)
        for i in range(6):
            node.builder.add_route(f"10.2.{2 * i}.0/24", idx,
                                   pkg.vector.Disposition.LOCAL)
    node.builder.set_global_table(_rules(pkg, seed))
    if model is not None:
        node.builder.set_ml_model(model)
    return pod_ip, pod_if


def stage_service(pkg, node, nid, n_nodes, pod_ip):
    """The ClusterIP service of node ``nid``: its backends are the next
    node's pods."""
    peer = (nid + 1) % n_nodes
    backends = [(pkg.vector.ip4(pod_ip[f"ns/pod{peer}-{p}"]), 8080, 1)
                for p in range(2)]
    node.builder.set_nat_mapping(0, pkg.vector.ip4(VIP), VIP_PORT, 6,
                                 backends, 0)


def build(pkg, n_nodes, shards, seed=0, model=None, nested=False, **kw):
    """A cluster of ``n_nodes`` x ``shards``: every node staged by
    ``stage_node`` and ``stage_service``. Returns (cluster, {pod: ip},
    {pod: if})."""
    cfg = pkg.tables.DataplaneConfig(**{**BASE, **kw})
    clus = pkg.cluster.ClusterDataplane(pkg.mesh(n_nodes, shards), cfg)
    pod_ip, pod_if = {}, {}
    for nid in range(n_nodes):
        ips, ifs = stage_node(pkg, clus.node(nid), nid, n_nodes, seed,
                              model, nested)
        pod_ip.update(ips)
        pod_if.update(ifs)
    for nid in range(n_nodes):
        stage_service(pkg, clus.node(nid), nid, n_nodes, pod_ip)
    clus.swap()
    return clus, pod_ip, pod_if


def forward(n_nodes, pod_ip, pod_if, seed, n=24, nested=False):
    """Per node ``n`` fresh flows from its pods: a quarter to pods on
    other nodes, some to the VIP, some to its own pods, a few to
    ports and protocols the global table denies. With ``nested`` an
    eighth go into ``stage_node``'s nested prefixes."""
    rng = np.random.default_rng(seed)
    out = []
    for nid in range(n_nodes):
        pk = []
        for i in range(n):
            src = f"ns/pod{nid}-{int(rng.integers(0, PODS))}"
            kind = i % 8
            if kind < 2:
                dst_node = int((nid + 1 + rng.integers(0, n_nodes - 1))
                               % n_nodes)
            else:
                dst_node = nid
            dst = pod_ip[f"ns/pod{dst_node}-{int(rng.integers(0, PODS))}"]
            proto, dport = 6, int(rng.integers(1000, 9000))
            if kind == 2:
                dst, dport = VIP, VIP_PORT
            elif kind == 3:
                dport = int(rng.integers(7000, 7016))
            elif kind == 4:
                proto, dport = 17, 5353
            elif kind == 5 and nested:
                dst = f"10.2.{int(rng.integers(0, 14))}.7"
            pk.append(dict(src=pod_ip[src], dst=dst, proto=proto,
                           sport=int(20000 + 97 * i + nid), dport=dport,
                           rx_if=pod_if[src]))
        out.append(pk)
    return out


def replies(res, n_nodes, width):
    """The replies to every packet a step delivered to a pod (pass 1
    locally, pass 2 across the fabric), entering at that pod."""
    out = [[] for _ in range(n_nodes)]
    for side in ("local", "delivered"):
        r = interop.cluster_result_to_numpy(res)
        disp = r[f"{side}.disp"]
        for nid in range(n_nodes):
            for j in np.nonzero(disp[nid] == 0)[0]:   # LOCAL
                if len(out[nid]) >= width:
                    break
                g = (lambda f: int(r[f"{side}.pkts.{f}"][nid, j]))
                out[nid].append(dict(
                    src=g("dst_ip") & 0xFFFFFFFF,
                    dst=g("src_ip") & 0xFFFFFFFF, proto=g("proto"),
                    sport=g("dport"), dport=g("sport"),
                    rx_if=int(r[f"{side}.tx_if"][nid, j])))
    return out


def _ref_step(clus, pkts, now, budget, payload):
    """The reference's ClusterDataplane.step / step_wire with a fabric
    budget (its handle always builds budget 0)."""
    import jax.numpy as jnp

    step = jcluster.make_cluster_step(
        clus.mesh, budget=budget, with_payload=payload is not None,
        sweep_stride=clus._sweep_stride, impl=clus._impl,
        fast=clus._use_fast, ml_mode=clus._ml_mode, ml_kind=clus._ml_kind,
        bv_sharded=clus._bv_sharded, ml_sharded=clus._ml_sharded,
        fib=clus._fib_impl)
    if payload is None:
        res, pay = step(clus.tables, pkts, jnp.int32(now),
                        clus._uplinks), None
    else:
        res, pay = step(clus.tables, pkts, jnp.asarray(payload),
                        jnp.int32(now), clus._uplinks)
    clus.tables = res.tables
    clus._steps_since_expire += 1
    return res, pay


def pair_step(ref, port, frames, now, width, budget=0, payload=None):
    """One step of both clusters on the same frames; asserts every
    result field, the delivered payload rows and the session planes
    equal. Returns the port's result."""
    rp = ref.make_frames(frames, n=width)
    tp = port.make_frames(frames, n=width)
    r_res, r_pay = _ref_step(ref, rp, now, budget, payload)
    if payload is None:
        t_res, t_pay = port.step(tp, now=now, budget=budget), None
    else:
        t_res, t_pay = port.step_wire(tp, payload, now=now, budget=budget)
    assert_equal_results(r_res, t_res)
    assert_equal_sessions(ref, port)
    if payload is not None:
        np.testing.assert_array_equal(np.asarray(r_pay), t_pay.numpy())
    return t_res


def assert_equal_results(r_res, t_res):
    a = interop.cluster_result_to_numpy(r_res)
    b = interop.cluster_result_to_numpy(t_res)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_equal_sessions(ref, port):
    a = interop.cluster_tables_to_numpy(ref.tables, SESSION_FIELDS)
    b = interop.cluster_tables_to_numpy(port.tables, SESSION_FIELDS)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _counts(res, key):
    return int(interop.cluster_result_to_numpy(res)[key].sum())


CASES = [
    # (nodes, shards, classifier, fast path, fabric budget, wire)
    pytest.param(4, 2, "dense", True, 0, False, id="4x2-dense-fast"),
    pytest.param(4, 2, "bv", False, 2, False, id="4x2-bv-budget2"),
    pytest.param(2, 2, "mxu", True, 0, True, id="2x2-mxu-fast-wire"),
    pytest.param(2, 2, "bv", True, 3, False, id="2x2-bv-fast-budget3"),
]


def differential(nodes, shards, classifier, fast, budget, wire, rounds=2,
                 model=None, nested=False, **kw):
    """Both packages' clusters built alike (``build``) step the same
    traffic for ``rounds`` rounds: forward vectors, their replies, then
    the two mixed; every step is held bit for bit (``pair_step``).
    Returns (reference cluster, port cluster)."""
    kw.update(classifier=classifier, fastpath=fast)
    ref, pod_ip, pod_if = build(REF, nodes, shards, model=model,
                                nested=nested, **kw)
    port, pod_ip_t, pod_if_t = build(PORT, nodes, shards, model=model,
                                     nested=nested, **kw)
    assert (pod_ip, pod_if) == (pod_ip_t, pod_if_t)
    assert port.classifier_impl == ref.classifier_impl == classifier
    assert port.fastpath_selected == ref.fastpath_selected == fast
    assert port.fib_impl == ref.fib_impl
    assert port.ml_selected == ref.ml_selected
    width = 32
    rng = np.random.default_rng(5)
    for rnd in range(rounds):
        fwd = forward(nodes, pod_ip, pod_if, seed=rnd, nested=nested)
        payload = None
        if wire:
            payload = rng.integers(0, 256, (nodes, width, 48),
                                   dtype=np.uint8)
        res = pair_step(ref, port, fwd, now=10 + rnd, width=width,
                        budget=budget, payload=payload)
        assert _counts(res, "fabric_sent") > 0
        if budget:
            assert _counts(res, "fabric_overflow") > 0
        back = replies(res, nodes, width)
        res = pair_step(ref, port, back, now=11 + rnd, width=width,
                        budget=budget, payload=payload)
        if fast:
            assert _counts(res, "fastpath_pass1") == nodes
        # forward and replies in one vector: the full chain
        mixed = [f[:width // 2] + b[:width // 2] for f, b in zip(fwd, back)]
        pair_step(ref, port, mixed, now=12 + rnd, width=width,
                  budget=budget, payload=payload)
    assert int(port.tables.sess_valid.sum()) > 0
    assert int(port.tables.natsess_valid.sum()) > 0
    return ref, port


@pytest.mark.parametrize("nodes,shards,classifier,fast,budget,wire", CASES)
def test_cluster_equals_reference(ref_mesh, nodes, shards, classifier, fast,
                                  budget, wire):
    differential(nodes, shards, classifier, fast, budget, wire)


def test_expiry_and_a_swap_carrying_sessions_equal_the_reference(ref_mesh):
    """Sessions outlive a re-publish of the configuration, then idle past
    ``sess_max_age`` and expire in bulk, alike in both packages."""
    kw = dict(classifier="dense", fastpath=True)
    ref, pod_ip, pod_if = build(REF, 4, 2, **kw)
    port, _, _ = build(PORT, 4, 2, **kw)
    res = pair_step(ref, port, forward(4, pod_ip, pod_if, seed=7), now=5,
                    width=32)
    live = int(port.tables.sess_valid.sum())
    assert live > 0
    for clus in (ref, port):
        clus.node(1).builder.set_global_table(_rules(
            PORT if clus is port else REF, 3))
        clus.swap()
    assert_equal_sessions(ref, port)
    assert int(port.tables.sess_valid.sum()) == live
    pair_step(ref, port, replies(res, 4, 32), now=6, width=32)
    for clus in (ref, port):
        clus._now = 100
        clus.clock_ticks = lambda: 100
    assert ref.expire_sessions() == port.expire_sessions() > 0
    assert_equal_sessions(ref, port)


def test_captured_equals_eager():
    """The same cluster stepped through its captured programs and
    eagerly: results and state bit for bit, on both the auto path and
    the forced full chain."""
    for fast in (True, False):
        kw = dict(classifier="bv", fastpath=fast)
        a, pod_ip, pod_if = build(PORT, 2, 2, **kw)
        b, _, _ = build(PORT, 2, 2, **kw)
        b.graphs = False
        for rnd in range(2):
            fwd = forward(2, pod_ip, pod_if, seed=20 + rnd)
            for frames in (fwd, None):
                if frames is None:
                    frames = replies(ra, 2, 32)
                ra = a.step(a.make_frames(frames, n=32), now=3 + rnd)
                rb = b.step(b.make_frames(frames, n=32), now=3 + rnd)
                assert_equal_results(ra, rb)
                assert_equal_sessions(a, b)
        assert a.programs() and not b.programs()


@pytest.mark.parametrize("kw,match", [
    (dict(tenancy="on"), "tenancy"),
    (dict(classifier="bv", max_global_rules=96), "32·shards"),
    (dict(classifier="pallas"), "PARTITION_RULES"),
    (dict(session_impl="pallas"), "PARTITION_RULES"),
    (dict(max_global_rules=255), "not divisible by rule shards"),
    (dict(sess_slots=4), "buckets"),
])
def test_cluster_refuses_what_the_reference_refuses(kw, match):
    """The same configurations raise the same ValueError in both
    packages' ClusterDataplane, before any staging."""
    for pkg in (REF, PORT):
        cfg = pkg.tables.DataplaneConfig(**{**BASE, **kw})
        with pytest.raises(ValueError, match=match):
            pkg.cluster.ClusterDataplane(pkg.mesh(2, 2), cfg)
