"""The policy pipeline down to the device tables: vpp_tpu_torch vs vpp_tpu.

Kubernetes objects go through each package's own PolicyCache →
PolicyProcessor → PolicyConfigurator → TpuRenderer → Dataplane, and the
packet verdicts that follow are compared lane for lane:

* the scenarios of ``tests/test_policy_e2e.py``, run as written through
  both packages (``run_case`` rebinds a reference test's module-level
  names to one package), with every ``process`` result logged and the
  two logs held equal; the parallel-commit case runs in its reference
  form (the device renderer beside the vpptcp renderer, both
  committing from worker threads) and with two device renderers;
* the random differential of ``tests/test_policy_differential.py``
  (seeds 1, 7, 23) against its ``k8s_allowed`` oracle and against the
  reference;
* the ``tests/test_renderer_cache.py`` cases over both RendererCaches,
  with every change list and every final table compared through
  ``rule_to_dict``.

Both packages run ``DataplaneConfig(sess_slots=256, max_tables=32)``; the
port on the CPU. Every quantity compared is an integer or a string: the
tolerance is exact equality.
"""

import hashlib
import random
import types

import numpy as np
import pytest

import test_policy_differential as jdiff
import test_policy_e2e as je2e
import test_renderer_cache as jrc
from vpp_tpu.ir.rule import PodID as JPodID
from vpp_tpu.ksr import model as jm
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import txn as jtxn
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu.policy import cache as jpcache
from vpp_tpu.policy import configurator as jpconf
from vpp_tpu.policy import processor as jpproc
from vpp_tpu.renderer import api as japi
from vpp_tpu.renderer import cache as jrcache
from vpp_tpu.renderer import tpu as jtpu
from vpp_tpu_torch import ir as tir
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ir import table as ttable
from vpp_tpu_torch.ksr import model as tm
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import txn as ttxn
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.policy import cache as tpcache
from vpp_tpu_torch.policy import configurator as tpconf
from vpp_tpu_torch.policy import processor as tpproc
from vpp_tpu_torch.renderer import api as tapi
from vpp_tpu_torch.renderer import cache as trcache
from vpp_tpu_torch.renderer import tpu as ttpu

SMALL = dict(sess_slots=256, max_tables=32)

# the process() columns each log line holds, per valid lane
_LOGGED = ("disp", "tx_if", "drop_cause", "src_ip", "dst_ip", "sport",
           "dport")


def _log_line(result) -> list:
    """The valid lanes of one step result as plain ints."""
    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    valid = host(result.pkts.valid).astype(bool)
    cols = {"disp": result.disp, "tx_if": result.tx_if,
            "drop_cause": result.drop_cause}
    cols.update({f: getattr(result.pkts, f) for f in _LOGGED[3:]})
    return [[int(v) & 0xFFFFFFFF for v in host(cols[f])[valid]]
            for f in _LOGGED]


def staged_digest(builder) -> str:
    """One digest of every staged table array of a builder (uint32 as
    int32 bits), equal across the packages when their staging is."""
    h = hashlib.sha256()
    for f, a in sorted(builder.host_arrays().items()):
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f.encode())
        h.update((a.view(np.int32) if a.dtype == np.uint32 else a)
                 .tobytes())
    return h.hexdigest()


def logging_dataplanes(log: list):
    """(reference, port) Dataplane classes that take an optional config
    (default ``SMALL``), run the port on the CPU and append every
    ``process`` result's valid lanes, and every swap's epoch and staged
    tables, to ``log``."""

    class JDataplane(jdp.Dataplane):
        def __init__(self, config=None):
            super().__init__(config or jtables.DataplaneConfig(**SMALL))

        def process(self, *a, **kw):
            r = super().process(*a, **kw)
            log.append(_log_line(r))
            return r

        def swap(self):
            log.append(("swap", staged_digest(self.builder)))
            return super().swap()

    class TDataplane(tdp.Dataplane):
        def __init__(self, config=None):
            super().__init__(config or ttables.DataplaneConfig(**SMALL),
                             device="cpu")

        def process(self, *a, **kw):
            r = super().process(*a, **kw)
            log.append(_log_line(r))
            return r

        def swap(self):
            log.append(("swap", staged_digest(self.builder)))
            return super().swap()

    return JDataplane, TDataplane


def run_case(module, name: str, subs: dict, *args):
    """Run the test function ``name`` of the reference test ``module``
    with its module-level names overridden by ``subs``: every function
    and class the module defines is rebuilt over the new names, so its
    helpers build the substituted objects too. Returns the call's
    result."""
    g = dict(vars(module))
    g.update(subs)

    def rebind(f):
        return types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                                  f.__closure__)

    for k, v in vars(module).items():
        if k in subs:
            continue
        if isinstance(v, types.FunctionType) and \
                v.__module__ == module.__name__:
            g[k] = rebind(v)
        elif isinstance(v, type) and v.__module__ == module.__name__:
            ns = {a: rebind(f) if isinstance(f, types.FunctionType) else f
                  for a, f in vars(v).items()
                  if a not in ("__dict__", "__weakref__")}
            g[k] = type(v.__name__, v.__bases__, ns)
    return g[name](*args)


def policy_names(port: bool, log: list) -> dict:
    """The names the policy tests import, from one package."""
    jd, td = logging_dataplanes(log)
    if port:
        return dict(PodID=trule.PodID, m=tm, Dataplane=td,
                    DataplaneConfig=ttables.DataplaneConfig,
                    Disposition=tvector.Disposition,
                    make_packet_vector=tvector.make_packet_vector,
                    PolicyCache=tpcache.PolicyCache,
                    PolicyConfigurator=tpconf.PolicyConfigurator,
                    PolicyProcessor=tpproc.PolicyProcessor,
                    TpuRenderer=ttpu.TpuRenderer)
    return dict(PodID=JPodID, m=jm, Dataplane=jd,
                DataplaneConfig=jtables.DataplaneConfig,
                Disposition=jvector.Disposition,
                make_packet_vector=jvector.make_packet_vector,
                PolicyCache=jpcache.PolicyCache,
                PolicyConfigurator=jpconf.PolicyConfigurator,
                PolicyProcessor=jpproc.PolicyProcessor,
                TpuRenderer=jtpu.TpuRenderer)


# --- the e2e scenarios -------------------------------------------------

E2E_CASES = sorted(n for n in vars(je2e) if n.startswith("test_")
                   and n != "test_parallel_renderer_commits")


def test_e2e_case_list():
    """Every scenario of the reference file is run here (the parallel
    commit one by ``test_parallel_renderer_commits``)."""
    assert len(E2E_CASES) == 10
    assert "test_ipblock_with_except" in E2E_CASES


@pytest.mark.parametrize("case", E2E_CASES)
def test_policy_e2e_scenarios(case):
    """Each reference scenario's own assertions hold on the port, every
    swap publishes the same staged tables, and every packet both
    packages process gets the same verdict, header and drop cause."""
    logs = {}
    for port in (False, True):
        logs[port] = []
        run_case(je2e, case, policy_names(port, logs[port]))
    assert logs[True] == logs[False]
    assert sum(e[0] == "swap" for e in logs[True]) >= 2


def test_parallel_renderer_commits():
    """The reference's parallel-commit case as written, on the port: the
    device renderer and the vpptcp renderer commit from worker threads;
    the device tables deny port 9999 and the session rules exist."""
    from test_torch_agent import port_case

    port_case(je2e, "test_parallel_renderer_commits")


def test_parallel_commits_two_device_renderers():
    """``parallel_commits``: two device renderers (two dataplanes) commit
    from worker threads and land the same tables as the serial path;
    the verdict is the reference's (DROP: port 9999 is not admitted)."""
    web1, db = trule.PodID("default", "web1"), trule.PodID("default", "db")
    ips = {web1: "10.1.1.2", db: "10.1.1.4"}
    labels = {web1: {"app": "web"}, db: {"app": "db"}}

    def build(parallel):
        dps = [tdp.Dataplane(ttables.DataplaneConfig(**SMALL), device="cpu")
               for _ in range(2)]
        cache = tpcache.PolicyCache()
        conf = tpconf.PolicyConfigurator(cache, parallel_commits=parallel)
        for dp in dps:
            dp.add_uplink()
            conf.register_renderer(ttpu.TpuRenderer(dp))
        tpproc.PolicyProcessor(cache, conf)
        cache.update_namespace(tm.Namespace(name="default", labels={}))
        for pid in (web1, db):
            for dp in dps:
                idx = dp.add_pod_interface(pid)
                dp.builder.add_route(f"{ips[pid]}/32", idx,
                                     tvector.Disposition.LOCAL)
            cache.update_pod(tm.Pod(name=pid.name, namespace=pid.namespace,
                                    labels=labels[pid], ip_address=ips[pid]))
        for dp in dps:
            dp.swap()
        cache.update_policy(run_case(je2e, "db_policy",
                                     policy_names(True, [])))
        return dps

    verdicts = []
    for parallel in (True, False):
        for dp in build(parallel):
            pkts = tvector.make_packet_vector([
                {"src": ips[web1], "dst": ips[db], "proto": 6, "sport": 1,
                 "dport": 9999, "rx_if": dp.pod_if[web1]}])
            verdicts.append(int(dp.process(pkts).disp[0]))
            assert dp.table_slots, "the renderer staged no local table"
    assert verdicts == [int(tvector.Disposition.DROP)] * 4


# --- the random differential -------------------------------------------

def _differential(port: bool, seed: int):
    """The reference differential's scenario on one package; returns
    (verdicts, oracle verdicts) over every (src, dst, port) triple."""
    log = []
    n = policy_names(port, log)
    m, disp = n["m"], n["Disposition"]
    rng = random.Random(seed)
    pods = [n["PodID"]("default", f"p{i}") for i in range(5)]
    labels = {p: {k: rng.choice(jdiff.LABEL_VALS) for k in jdiff.LABEL_KEYS
                  if rng.random() < 0.8} for p in pods}
    ips = {p: f"10.1.1.{i + 2}" for i, p in enumerate(pods)}
    dp = n["Dataplane"]()
    dp.add_uplink()
    cache = n["PolicyCache"]()
    conf = n["PolicyConfigurator"](cache)
    conf.register_renderer(n["TpuRenderer"](dp))
    n["PolicyProcessor"](cache, conf)
    cache.update_namespace(m.Namespace(name="default", labels={}))
    for p in pods:
        idx = dp.add_pod_interface(p)
        dp.builder.add_route(f"{ips[p]}/32", idx, disp.LOCAL)
        cache.update_pod(m.Pod(name=p.name, namespace=p.namespace,
                               labels=labels[p], ip_address=ips[p]))
    dp.swap()
    policies = []
    for i in range(rng.randint(1, 4)):
        sel_key = rng.choice(jdiff.LABEL_KEYS)
        pol = m.Policy(
            name=f"pol{i}", namespace="default",
            pods=m.LabelSelector(
                match_labels={sel_key: rng.choice(jdiff.LABEL_VALS)}),
            policy_type=m.POLICY_INGRESS,
            ingress_rules=[
                m.PolicyRule(
                    ports=[m.PolicyPort(protocol="TCP",
                                        port=rng.choice(jdiff.PORTS))]
                    if rng.random() < 0.8 else [],
                    peers=[m.PolicyPeer(pods=m.LabelSelector(match_labels={
                        rng.choice(jdiff.LABEL_KEYS):
                            rng.choice(jdiff.LABEL_VALS)}))]
                    if rng.random() < 0.8 else [],
                )
                for _ in range(rng.randint(0, 2))
            ],
        )
        policies.append(pol)
        cache.update_policy(pol)
    got, want = [], []
    for src in pods:
        for dst in pods:
            if src == dst:
                continue
            for dport in jdiff.PORTS:
                pkts = n["make_packet_vector"]([dict(
                    src=ips[src], dst=ips[dst], proto=6, sport=40000,
                    dport=dport, rx_if=dp.pod_if[src])])
                got.append(int(dp.process(pkts).disp[0])
                           == int(disp.LOCAL))
                want.append(jdiff.k8s_allowed(policies, pods, labels, src,
                                              dst, dport))
    return got, want, log


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_random_policies_match_oracle_and_reference(seed):
    got, want, log = _differential(True, seed)
    ref_got, ref_want, ref_log = _differential(False, seed)
    assert got == want, [i for i, (g, w) in enumerate(zip(got, want))
                         if g != w][:10]
    assert ref_want == want and ref_got == got
    assert log == ref_log


# --- the renderer cache cases ------------------------------------------

RC_CASES = sorted(n for n in vars(jrc) if n.startswith("test_"))


def _table_record(table, to_dict):
    return (table.id, int(table.type), sorted(table.pods),
            [to_dict(r) for r in table.rules])


def recording_caches(port: bool, record: list):
    """A RendererCache subclass of one package that appends every change
    list and, at each commit, every table it holds, to ``record``."""
    base = trcache.RendererCache if port else jrcache.RendererCache
    to_dict = ttxn.rule_to_dict if port else jtxn.rule_to_dict

    class Recording(base):
        def new_txn(self):
            txn = super().new_txn()
            get_changes, commit = txn.get_changes, txn.commit

            def changes():
                out = get_changes()
                record.append(("changes", [
                    _table_record(c.table, to_dict)
                    + (sorted(c.previous_pods),) for c in out]))
                return out

            def committed():
                commit()
                record.append(("tables", sorted(
                    [_table_record(t, to_dict) for t in self.local_tables]
                    + [_table_record(self.get_global_table(), to_dict)])))

            txn.get_changes, txn.commit = changes, committed
            return txn

    return Recording


def cache_names(port: bool, record: list) -> dict:
    if port:
        return dict(Action=tir.Action, ContivRule=tir.ContivRule,
                    PodID=tir.PodID, Protocol=tir.Protocol,
                    TableType=ttable.TableType, PodConfig=tapi.PodConfig,
                    Orientation=trcache.Orientation,
                    RendererCache=recording_caches(True, record))
    return dict(RendererCache=recording_caches(False, record),
                PodConfig=japi.PodConfig)


@pytest.mark.parametrize("case", RC_CASES)
def test_renderer_cache_cases(case):
    """Each reference case's own assertions hold on the port's cache,
    and both caches produce the same change lists and tables."""
    records = {}
    for port in (False, True):
        records[port] = []
        run_case(jrc, case, cache_names(port, records[port]))
    assert records[True] == records[False]
    assert len(RC_CASES) == 11
