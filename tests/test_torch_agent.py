"""The node agent: vpp_tpu_torch's ContivAgent vs vpp_tpu's.

* The reference's own agent tests (``tests/test_agent.py``, the agent
  cases of ``tests/test_snapshot.py`` and ``tests/test_txn.py``) run as
  written on the port: ``port_case`` rebinds the test module's names to
  the port's objects and, for the imports the tests make inside their
  functions, maps each ``vpp_tpu.*`` module that has a port twin to it
  for the length of the case. ``ContivAgent``, ``Dataplane`` and
  ``SessionRuleEngine`` are bound to subclasses that run on the CPU
  (the port's entry points default to the card). A case that reaches a
  module the port refuses asserts the refusal and its ROADMAP item.
* A differential: one agent per package, each on its own in-memory
  store, fed the same seeded Kubernetes events through KSR and the CNI
  transport socket. After every event the stores, the CNI replies, the
  verdicts of a seeded packet vector and the staged-table digest are
  equal; after ``maintenance_tick`` so is the exposition, but for the
  families named in ``UNCOMPARED``.
* The state an agent leaves behind (its persisted store file and its
  session snapshot directory) boots the other package's agent, both
  ways, with the same pods, addresses, interfaces, node id and sessions.

Every quantity compared is an integer, a string or a text line: the
tolerance is exact equality.
"""

from __future__ import annotations

import contextlib
import importlib
import ipaddress
import pkgutil
import random
import sys
import types

import numpy as np
import pytest
import torch

import test_agent as jagent_tests
import test_snapshot as jsnap_tests
import test_txn as jtxn_tests
import vpp_tpu_torch
from test_torch_policy import staged_digest
from vpp_tpu.cmd import agent as jagent
from vpp_tpu.cmd import config as jconfig
from vpp_tpu.cmd import ksr_main as jksr
from vpp_tpu.cni import model as jcni
from vpp_tpu.cni import transport as jtransport
from vpp_tpu.ksr import model as jm
from vpp_tpu.kvstore import store as jstore
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.cmd import agent as tagent
from vpp_tpu_torch.cmd import config as tconfig
from vpp_tpu_torch.cmd import ksr_main as tksr
from vpp_tpu_torch.cni import model as tcni
from vpp_tpu_torch.cni import transport as ttransport
from vpp_tpu_torch.hoststack import session_rules as tsr
from vpp_tpu_torch.ksr import model as tm
from vpp_tpu_torch.kvstore import store as tstore
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector


# --- the port, bound into the reference's tests ----------------------

class CpuDataplane(tdp.Dataplane):
    """The port's Dataplane on the CPU unless told otherwise."""

    def __init__(self, config=None, device="cpu", **kw):
        super().__init__(config, device=device, **kw)

    def encap_remote(self, result):
        """The outer vector with its address columns read unsigned, as
        the reference's uint32 columns read (the port holds the same
        bits in int32)."""
        outer = super().encap_remote(result)
        return outer._replace(**{
            f: getattr(outer, f).to(torch.int64) & 0xFFFFFFFF
            for f in ("src_ip", "dst_ip")})


class CpuAgent(tagent.ContivAgent):
    """The port's ContivAgent on the CPU unless told otherwise."""

    def __init__(self, config=None, store=None, dataplane=None,
                 device="cpu", mesh_node_resolver=None):
        super().__init__(config, store, dataplane, device,
                         mesh_node_resolver)
        # the agent builds the port's own Dataplane; read its encap
        # columns unsigned as CpuDataplane does
        self.dataplane.__class__ = CpuDataplane


class CpuSessionRuleEngine(tsr.SessionRuleEngine):
    """The port's SessionRuleEngine on the CPU unless told otherwise."""

    def __init__(self, capacity: int = 4096, device="cpu"):
        super().__init__(capacity, device=device)


def cpu_cluster_mesh(n_nodes, rule_shards=1, devices=None):
    """The port's ``cluster_mesh`` with every position on the CPU unless
    told otherwise (the reference's tests mesh its virtual CPU
    devices)."""
    from vpp_tpu_torch.parallel.mesh import cluster_mesh

    return cluster_mesh(n_nodes, rule_shards,
                        devices or ["cpu"] * (n_nodes * rule_shards))


def _cpu_mesh_runtime():
    from vpp_tpu_torch.parallel.runtime import MeshRuntime

    class CpuMeshRuntime(MeshRuntime):
        """The port's MeshRuntime on a CPU mesh unless told otherwise."""

        def __init__(self, n_nodes, base_config, rule_shards=1, store=None,
                     devices=None):
            super().__init__(n_nodes, base_config, rule_shards, store,
                             devices or ["cpu"] * (n_nodes * rule_shards))

    return CpuMeshRuntime


CPU_OVERRIDES = {"Dataplane": CpuDataplane, "ContivAgent": CpuAgent,
                 "SessionRuleEngine": CpuSessionRuleEngine,
                 "cluster_mesh": cpu_cluster_mesh}


def _port_modules():
    """{reference module name: port module} for every port module."""
    out = {}
    for info in pkgutil.walk_packages(vpp_tpu_torch.__path__,
                                      "vpp_tpu_torch."):
        name = info.name
        if name.endswith("__main__"):
            continue
        out["vpp_tpu" + name[len("vpp_tpu_torch"):]] = \
            importlib.import_module(name)
    out["vpp_tpu"] = vpp_tpu_torch
    return out


_ALIASES = {}


def port_alias(ref_name: str):
    """A module standing in for ``ref_name``: the port module's names,
    with the CPU subclasses in place of the card-defaulting entries
    (None when the port has no such module)."""
    if not _ALIASES:
        for ref, port in _port_modules().items():
            alias = types.ModuleType(ref)
            alias.__dict__.update(vars(port))
            # a package's lazy exports (vpp_tpu_torch/_lazy.py), resolved
            # so the CPU overrides below find them
            alias.__dict__.update({n: getattr(port, n)
                                   for n in getattr(port, "__all__", ())})
            alias.__name__ = ref
            if hasattr(port, "__path__"):
                # a submodule the port lacks loads from the reference
                alias.__path__ = list(importlib.import_module(ref).__path__)
            for k, v in CPU_OVERRIDES.items():
                if k in alias.__dict__:
                    alias.__dict__[k] = v
            if "MeshRuntime" in alias.__dict__:
                alias.__dict__["MeshRuntime"] = _cpu_mesh_runtime()
            _ALIASES[ref] = alias
    return _ALIASES.get(ref_name)


# a reference test module's ``jnp`` reads the port's CPU tensors through
# NumPy (the tests only reduce and convert with it)
NUMPY_AS_JNP = types.SimpleNamespace(
    sum=lambda a, *k, **kw: np.asarray(a).sum(*k, **kw),
    asarray=np.asarray)


def port_value(v):
    """The port's counterpart of one of a reference test module's
    names (unchanged when it is not the reference's)."""
    if isinstance(v, types.ModuleType):
        if v.__name__.startswith("vpp_tpu.") and port_alias(v.__name__):
            return port_alias(v.__name__)
        return v
    mod = getattr(v, "__module__", None)
    if isinstance(mod, str) and mod.startswith("vpp_tpu.") and \
            isinstance(v, (type, types.FunctionType)):
        alias = port_alias(mod)
        if alias is not None and hasattr(alias, v.__name__):
            return getattr(alias, v.__name__)
    return v


@contextlib.contextmanager
def port_imports():
    """Inside the block, ``import vpp_tpu.X`` finds the port's X (the
    CPU-bound alias) wherever the port has one; reference modules first
    imported inside the block are dropped again at its end."""
    port_alias("vpp_tpu")
    saved = {k: sys.modules.get(k) for k in _ALIASES if k != "vpp_tpu"}
    before = set(sys.modules)
    try:
        for k in saved:
            sys.modules[k] = _ALIASES[k]
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        for k in set(sys.modules) - before:
            if k.startswith("vpp_tpu.") and k not in saved:
                del sys.modules[k]


def port_globals(module, wrap=None) -> dict:
    """The globals of a reference test module rebound to the port: its
    names from ``vpp_tpu`` replaced by the port's (``port_value``), and
    every function and class it defines rebuilt over them
    (test_torch_policy ``run_case``). ``wrap`` maps a helper's name to
    a function of the rebuilt helper that adapts it."""
    g = dict(vars(module))
    subs = {k: port_value(v) for k, v in g.items() if not k.startswith("__")}
    if "jnp" in g:
        subs["jnp"] = NUMPY_AS_JNP
    g.update({k: v for k, v in subs.items() if v is not g[k]})

    def rebind(f):
        out = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                                 f.__closure__)
        out.__kwdefaults__ = f.__kwdefaults__
        return out

    for k, v in vars(module).items():
        if g[k] is not v:
            continue
        if isinstance(v, types.FunctionType) and \
                v.__module__ == module.__name__:
            g[k] = rebind(v)
        elif isinstance(v, type) and v.__module__ == module.__name__:
            ns = {a: rebind(f) if isinstance(f, types.FunctionType) else f
                  for a, f in vars(v).items()
                  if a not in ("__dict__", "__weakref__")}
            g[k] = type(v.__name__, v.__bases__, ns)
    for k, f in (wrap or {}).items():
        g[k] = f(g[k])
    return g


def port_case(module, name: str, *args, wrap=None):
    """Run the reference test ``name`` (a function, or ``Class.method``)
    of ``module`` on the port."""
    g = port_globals(module, wrap)
    with port_imports():
        if "." in name:
            cls, meth = name.split(".")
            obj = g[cls]()
            return getattr(obj, meth)(*args)
        return g[name](*args)


def case_names(module):
    """Every test of the module: functions, and ``Class.method``."""
    out = []
    for n, v in sorted(vars(module).items()):
        if n.startswith("test_") and isinstance(v, types.FunctionType):
            out.append(n)
        elif n.startswith("Test") and isinstance(v, type):
            out += [f"{n}.{m}" for m in sorted(vars(v))
                    if m.startswith("test_")]
    return out


def case_args(module, name: str, tmp_path) -> tuple:
    """The fixtures a reference case takes (``tmp_path`` only)."""
    obj = vars(module)[name.split(".")[0]]
    if "." in name:
        obj = vars(obj)[name.split(".")[1]]
    code = obj.__code__
    return tuple(tmp_path for a in code.co_varnames[:code.co_argcount]
                 if a == "tmp_path")


def run_reference_case(module, name: str, tmp_path, refused: dict,
                       wrap=None):
    """Run one reference case on the port; a refused one must raise the
    refusal naming its ROADMAP item."""
    args = case_args(module, name, tmp_path)
    if name in refused:
        with pytest.raises(NotImplementedError, match=refused[name]):
            port_case(module, name, *args, wrap=wrap)
    else:
        port_case(module, name, *args, wrap=wrap)


# the cases of the reference's agent tests that need a module the port
# refuses: the message must name it and its ROADMAP item (none since
# the debug CLI is ported)
AGENT_REFUSED: dict = {}

AGENT_CASES = case_names(jagent_tests)


def test_agent_case_list():
    """Every case of tests/test_agent.py runs here."""
    assert len(AGENT_CASES) == 13
    assert set(AGENT_REFUSED) <= set(AGENT_CASES)


@pytest.mark.parametrize("case", AGENT_CASES)
def test_reference_agent_cases(case, tmp_path):
    run_reference_case(jagent_tests, case, tmp_path, AGENT_REFUSED)


@pytest.mark.parametrize("module,case", [
    (jsnap_tests,
     "TestAgentWiring.test_agent_snapshots_and_restores_across_restart"),
    (jtxn_tests, "test_live_agent_journal_replays_to_identical_tables"),
], ids=["snapshot", "txn"])
def test_reference_agent_state_cases(module, case, tmp_path):
    """The agent's warm restart from its session snapshots and its
    journal's replay, as the reference tests them."""
    run_reference_case(module, case, tmp_path, {})


# --- the differential: one agent per package, the same events ---------

from test_torch_policy import _log_line  # noqa: E402
from vpp_tpu.agent import node_id as jnode  # noqa: E402
from vpp_tpu_torch.agent import node_id as tnode  # noqa: E402

# exposition families left out of the comparison, and why
UNCOMPARED = {
    "vpp_tpu_build_info":
        "labels torch/device where the reference's has jax/backend",
    "vpp_tpu_jit_compiles_total":
        "process-wide: the port's captured programs, the reference's "
        "XLA compiles",
    "vpp_tpu_device_transfer_bytes_total":
        "process-wide transfer counters of each package",
    "vpp_tpu_partition_info":
        "the port's manifest adds its five derived table fields",
}
# wall-clock histograms: their _bucket and _sum lines are timings; their
# _count lines (observations) are compared
WALL_CLOCK_HISTOGRAMS = (
    "vpp_tpu_config_propagation_seconds", "vpp_tpu_txn_commit_seconds",
    "vpp_tpu_cni_request_seconds", "vpp_tpu_fib_churn_commit_seconds",
)


def compared_exposition(text: str) -> list:
    """The exposition lines the differential holds equal."""
    out = []
    for line in text.splitlines():
        name = (line.split(" ")[2] if line.startswith("# ")
                else line.split("{")[0].split(" ")[0])
        if name in UNCOMPARED:
            continue
        if any(name == h or (name.startswith(h + "_")
                             and not name.endswith("_count"))
               for h in WALL_CLOCK_HISTOGRAMS) and not line.startswith("#"):
            continue
        out.append(line)
    return out


def _package(port: bool) -> types.SimpleNamespace:
    if port:
        return types.SimpleNamespace(
            KVStore=tstore.KVStore, KsrAgent=tksr.KsrAgent,
            AgentConfig=tconfig.AgentConfig, ContivAgent=CpuAgent,
            DataplaneConfig=ttables.DataplaneConfig, m=tm,
            CNIRequest=tcni.CNIRequest,
            CNITransportServer=ttransport.CNITransportServer,
            cni_call=ttransport.cni_call,
            make_packet_vector=tvector.make_packet_vector,
            NodeIDAllocator=tnode.NodeIDAllocator)
    return types.SimpleNamespace(
        KVStore=jstore.KVStore, KsrAgent=jksr.KsrAgent,
        AgentConfig=jconfig.AgentConfig, ContivAgent=jagent.ContivAgent,
        DataplaneConfig=jtables.DataplaneConfig, m=jm,
        CNIRequest=jcni.CNIRequest,
        CNITransportServer=jtransport.CNITransportServer,
        cni_call=jtransport.cni_call,
        make_packet_vector=jvector.make_packet_vector,
        NodeIDAllocator=jnode.NodeIDAllocator)


PODS = (("default", "web1"), ("default", "web2"), ("default", "db"),
        ("prod", "api"), ("prod", "cache"), ("prod", "client"))
LABELS = {"web1": {"app": "web"}, "web2": {"app": "web"},
          "db": {"app": "db"}, "api": {"app": "api", "tier": "front"},
          "cache": {"app": "cache"}, "client": {"app": "client"}}
VIPS = (("10.96.0.10", 80), ("10.96.0.20", 5432))


class Node:
    """One package's node: a KSR and an agent on the package's own
    in-memory store, the agent's CNI server behind a transport socket,
    and a step clock the test moves (both packages read the same)."""

    def __init__(self, port: bool, tmp_path, clock: list, store=None):
        self.port = port
        self.p = _package(port)
        self.clock = clock
        self.store = store if store is not None else self.p.KVStore()
        self.ksr = self.p.KsrAgent(store=self.store, serve_http=False)
        self.ksr.start()
        self.cfg = self.p.AgentConfig(
            node_name="node-a", serve_http=False,
            node_liveness_ttl_s=3600.0,
            dataplane=self.p.DataplaneConfig(sess_slots=1024))
        self.agent = self.p.ContivAgent(self.cfg, store=self.store)
        self.agent.dataplane.clock_ticks = lambda: self.clock[0]
        self.agent.start()
        self.sock = str(tmp_path / f"cni-{int(port)}.sock")
        self.cni = self.p.CNITransportServer(
            self.sock, self.agent.cni_server.dispatch)
        self.cni.start()

    def close(self):
        self.cni.close()
        self.agent.close()
        self.ksr.close()

    def cni_add(self, ns, name):
        req = self.p.CNIRequest(
            container_id=f"c-{ns}-{name}", netns=f"/var/run/netns/{name}",
            extra_args={"K8S_POD_NAME": name, "K8S_POD_NAMESPACE": ns})
        return self.p.cni_call(self.sock, "Add", req.to_dict())

    def cni_del(self, ns, name):
        req = self.p.CNIRequest(container_id=f"c-{ns}-{name}")
        return self.p.cni_call(self.sock, "Delete", req.to_dict())

    def reflect(self, kind: str, key: str, obj) -> None:
        self.ksr.sources[getattr(self.p.m, kind).TYPE].add(key, obj)

    def state(self) -> dict:
        """What the differential holds equal after every event."""
        a = self.agent
        return {"store": self.store.dump(), "node_id": a.node_id,
                "pod_if": sorted((tuple(k), v)
                                 for k, v in a.dataplane.pod_if.items()),
                "digest": staged_digest(a.dataplane.builder),
                "session_rules": a.session_engine.num_rules}


def _objects(m, ips: dict) -> list:
    """The seeded cluster's Kubernetes objects of one package, in the
    order the test reflects them: (kind, key, object)."""
    sel = m.LabelSelector
    out = [("Namespace", ns, m.Namespace(name=ns, labels={"env": ns}))
           for ns in ("default", "prod")]
    out += [("Pod", f"{ns}/{n}", m.Pod(name=n, namespace=ns,
                                       labels=LABELS[n], ip_address=ips[n]))
            for ns, n in PODS if n in ips]
    out += [
        ("Policy", "default/db-policy", m.Policy(
            name="db-policy", namespace="default",
            pods=sel(match_labels={"app": "db"}),
            policy_type=m.POLICY_INGRESS,
            ingress_rules=[m.PolicyRule(
                ports=[m.PolicyPort(protocol="TCP", port=5432)],
                peers=[m.PolicyPeer(pods=sel(match_labels={"app": "web"}))],
            )])),
        ("Policy", "prod/api-policy", m.Policy(
            name="api-policy", namespace="prod",
            pods=sel(match_labels={"app": "api"}),
            policy_type=m.POLICY_INGRESS,
            ingress_rules=[m.PolicyRule(
                ports=[m.PolicyPort(protocol="TCP", port=80)],
                peers=[m.PolicyPeer(namespaces=sel(
                    match_labels={"env": "prod"}))],
            )])),
        ("Policy", "prod/cache-policy", m.Policy(
            name="cache-policy", namespace="prod",
            pods=sel(match_labels={"app": "cache"}),
            policy_type=m.POLICY_INGRESS,
            ingress_rules=[m.PolicyRule(
                ports=[m.PolicyPort(protocol="TCP", port=6379)],
                peers=[m.PolicyPeer(pods=sel(
                    match_labels={"tier": "front"}))],
            )])),
    ]
    for (vip, port), (svc, backends, tport) in zip(VIPS, (
            ("web", ("web1", "web2"), 8080), ("db", ("db",), 5432))):
        out.append(("Service", f"default/{svc}", m.Service(
            name=svc, namespace="default", cluster_ip=vip,
            ports=[m.ServicePort(name="p", protocol="TCP", port=port,
                                 target_port="p")])))
        out.append(("Endpoints", f"default/{svc}", m.Endpoints(
            name=svc, namespace="default",
            subsets=[m.EndpointSubset(
                addresses=[m.EndpointAddress(ip=ips[b], node_name="node-a")
                           for b in backends if b in ips],
                ports=[m.EndpointPort(name="p", port=tport,
                                      protocol="TCP")])])))
    return out


def _traffic(node: Node, rng: random.Random, ips: dict, peers) -> list:
    """A seeded vector: pod to pod, pod to service VIP, pod to a peer
    node's pod network, pod to the outside and uplink to pod."""
    dp = node.agent.dataplane
    live = [(ns, n) for ns, n in PODS if (ns, n) in dp.pod_if]
    rows = []
    for i in range(48):
        if not live:
            rows.append(dict(src=f"198.51.100.{i + 1}", dst="10.1.1.9",
                             proto=6, sport=40000 + i, dport=80,
                             rx_if=node.agent.uplink_if))
            continue
        kind = rng.choice(("pod", "pod", "vip", "peer", "out", "uplink"))
        src = rng.choice(live)
        row = dict(proto=rng.choice((6, 6, 17)), sport=40000 + i,
                   dport=rng.choice((80, 5432, 6379, 8080, 9999)),
                   src=ips[src[1]], rx_if=dp.pod_if[src])
        if kind == "pod":
            row["dst"] = ips[rng.choice(live)[1]]
        elif kind == "vip":
            row["dst"], row["dport"] = rng.choice(VIPS)
            row["proto"] = 6
        elif kind == "peer" and peers:
            row["dst"] = peers[rng.randrange(len(peers))]
        elif kind == "uplink":
            row.update(src=f"198.51.100.{i + 1}", rx_if=node.agent.uplink_if,
                       dst=ips[rng.choice(live)[1]])
        else:
            row["dst"] = "8.8.8.8"
        rows.append(row)
    return rows


def _verdicts(node: Node, rows, ips: dict) -> list:
    """Every processed lane, then the session-rule filter's verdicts."""
    dp = node.agent.dataplane
    res = dp.process(node.p.make_packet_vector(rows), now=node.clock[0])
    node.agent.stats.update(res.stats)
    extra = [[int(x) & 0xFFFFFFFF for x in np.asarray(
        getattr(res, f).cpu() if hasattr(getattr(res, f), "cpu")
        else getattr(res, f))[:len(rows)]] for f in ("node_id", "next_hop")]
    live = [(pod, _u32(ips[pod[1]])) for pod in PODS if pod in dp.pod_if]
    eng = node.agent.session_engine
    connect = [(dp.pod_if[src], 6, sip, 40000, dip, port)
               for src, sip in live for _, dip in live
               for port in (80, 5432, 6379)]
    accept = [(6, dip, port, _u32("198.51.100.1"), 40000)
              for _, dip in live for port in (80, 5432, 6379)]
    return [_log_line(res), extra, eng.check_connect(connect).tolist(),
            eng.check_accept(accept).tolist()]


def _u32(ip: str) -> int:
    return int(ipaddress.ip_address(ip))


def test_agents_of_both_packages_agree_event_by_event(tmp_path):
    """The seeded cluster's events through both packages' agents: after
    every event the stores, CNI replies, interface maps, staged tables,
    session rules and verdicts are equal, and after ``maintenance_tick``
    the expositions (``compared_exposition``)."""
    clock = [100]
    nodes = [Node(False, tmp_path, clock), Node(True, tmp_path, clock)]
    rng_seed = 20261017
    ips: dict = {}
    peers: list = []
    allocs = {}

    def check(event: str):
        clock[0] += 7
        states = [n.state() for n in nodes]
        assert states[1] == states[0], event
        outs = [_verdicts(n, _traffic(n, random.Random(
            f"{rng_seed}-{event}"), ips, peers), ips) for n in nodes]
        assert outs[1] == outs[0], event
        for n in nodes:
            n.agent.maintenance_tick()
        expo = [compared_exposition(n.agent.stats.registry.render("/stats"))
                for n in nodes]
        assert expo[1] == expo[0], event
        return outs[0]

    try:
        check("boot")
        for ns, name in PODS:
            replies = [n.cni_add(ns, name) for n in nodes]
            assert replies[1] == replies[0]
            assert replies[0]["result"] == 0
            ips[name] = replies[0]["interfaces"][0]["ip_addresses"][0][
                "address"].split("/")[0]
            check(f"cni add {name}")
        objs = [_objects(n.p.m, ips) for n in nodes]
        for i, (kind, key, _) in enumerate(objs[0]):
            for n, o in zip(nodes, objs):
                n.reflect(kind, key, o[i][2])
            check(f"{kind} {key}")
        for peer, ttl in (("peer-1", 3600.0), ("peer-2", 60.0)):
            for n in nodes:
                a = n.p.NodeIDAllocator(n.store, peer, liveness_ttl_s=ttl)
                pid = a.get_or_allocate()
                ip = str(n.agent.ipam.node_ip_address(pid))
                a.publish_ips(ip)
                a.publish_liveness(ip)
                allocs.setdefault(peer, []).append(a)
            peers.append(str(nodes[0].agent.ipam.other_node_pod_network(
                pid).network_address + 9))
            check(f"node {peer}")
        # peer-2 leaves by lease expiry (no delete issued)
        import time
        for n in nodes:
            assert n.store.sweep_leases(now=time.monotonic() + 600) == 1
        check("peer-2 lease expiry")
        replies = [n.cni_del("prod", "cache") for n in nodes]
        assert replies[1] == replies[0]
        check("cni del cache")
        stores = [n.store for n in nodes]
        for n in nodes:
            n.close()
        nodes[:] = [Node(False, tmp_path, clock, stores[0]),
                    Node(True, tmp_path, clock, stores[1])]
        check("restart")
    finally:
        for n in nodes:
            n.close()


# --- the state an agent leaves behind boots the other package ---------

def _state_config(p, root):
    return p.AgentConfig(
        node_name="n1", serve_http=False,
        persist_path=str(root / "store.json"),
        snapshot_path=str(root / "snaps"), snapshot_chunk_buckets=16,
        dataplane=p.DataplaneConfig(sess_slots=256, sess_sweep_stride=0))


def _node_view(agent, reqs) -> dict:
    """Pods, addresses, interfaces, node id and the live session planes
    of a booted agent (a re-Add of a known container answers from the
    persisted index, as kubelet's retry does)."""
    from vpp_tpu_torch.pipeline.tables import SESSION_FIELDS

    dp = agent.dataplane
    replies = [agent.cni_server.add(r).to_dict() for r in reqs]
    planes = {}
    for f in SESSION_FIELDS:
        x = getattr(dp.tables, f)
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        planes[f] = (x.view(np.int32) if x.dtype == np.uint32 else x).copy()
    return {"node_id": agent.node_id, "replies": replies,
            "pod_if": sorted((tuple(k), v) for k, v in dp.pod_if.items()),
            "index": sorted(c.container_id for c in
                            agent.container_index.load_persisted()),
            "planes": planes}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_agent_state_boots_the_other_package(writer, tmp_path):
    """An agent of one package runs CNI adds and pod-to-pod traffic,
    then closes (the parting snapshot, the store file saved). Copies of
    its directory boot an agent of each package: both give back the
    same pods on the same addresses and interfaces, the same node id and
    the same session planes, and the replies to its forwarded flows hit
    their sessions on the other package's agent."""
    import shutil

    pk = {"reference": _package(False), "port": _package(True)}
    other = "port" if writer == "reference" else "reference"
    root = tmp_path / "node"
    root.mkdir()
    p = pk[writer]
    agent = p.ContivAgent(_state_config(p, root))
    agent.start()
    reqs = {}
    ips = {}
    for ns, name in PODS[:4]:
        for q in pk.values():
            reqs.setdefault(id(q), []).append(q.CNIRequest(
                container_id=f"c-{name}", extra_args={
                    "K8S_POD_NAME": name, "K8S_POD_NAMESPACE": ns}))
        reply = agent.cni_server.add(reqs[id(p)][-1])
        ips[(ns, name)] = reply.interfaces[0].ip_addresses[0].address \
            .split("/")[0]
    dp = agent.dataplane
    pods = list(ips)
    flows = [dict(src=ips[a], dst=ips[b], proto=6, sport=30000 + i,
                  dport=80, rx_if=dp.pod_if[a])
             for i, (a, b) in enumerate((a, b) for a in pods for b in pods
                                        if a != b)]
    res = dp.process(p.make_packet_vector(flows, n=16), now=5)
    assert int(res.stats.tx) == len(flows)
    agent.close()

    views = {}
    for pkg in (writer, other):
        copy = tmp_path / f"boot-{pkg}"
        shutil.copytree(root, copy)
        q = pk[pkg]
        booted = q.ContivAgent(_state_config(q, copy))
        booted.start()
        try:
            views[pkg] = _node_view(booted, reqs[id(q)])
            if pkg == other:
                bdp = booted.dataplane
                replies = [dict(src=f["dst"], dst=f["src"], proto=6,
                                sport=80, dport=f["sport"],
                                rx_if=bdp.pod_if[pods[[ips[x] for x in pods]
                                                      .index(f["dst"])]])
                           for f in flows]
                hit = bdp.process(q.make_packet_vector(replies, n=16),
                                  now=6)
                assert int(hit.stats.sess_hits) == len(flows)
        finally:
            booted.close()
    want, got = views[writer], views[other]
    planes = (want.pop("planes"), got.pop("planes"))
    assert got == want
    assert int(planes[0]["sess_valid"].sum()) == len(flows)
    for f in planes[0]:
        np.testing.assert_array_equal(planes[1][f], planes[0][f], err_msg=f)
