"""The service pipeline down to the NAT tables: vpp_tpu_torch vs vpp_tpu.

* The scenarios of ``tests/test_service_e2e.py`` (ClusterIP, the local
  backend's double weight, NodePort, ``externalTrafficPolicy: Local``,
  a service or its ports withdrawn, an endpoints update) run as written
  through both packages' ServiceProcessor → ServiceConfigurator →
  Dataplane (``test_torch_policy.run_case``), with every swap's staged
  tables and every ``process`` result logged and the two logs equal.
* The ``service.churn`` fault seam of the svc-plane path: a fault
  mid-churn (a backend roll, a service delete) raises, publishes no
  epoch and leaves the builder at its pre-churn host arrays, on the
  port as on the reference; the pre-churn set keeps serving and the
  re-driven churn converges to the same tables and picks in both.

The port runs on the CPU. Every quantity compared is an integer: the
tolerance is exact equality.
"""

import numpy as np
import pytest

import test_service_e2e as jsvc
from test_torch_policy import logging_dataplanes, run_case, staged_digest
from vpp_tpu.ir.rule import PodID as JPodID
from vpp_tpu.ksr import model as jm
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu.service import ServiceConfigurator as JServiceConfigurator
from vpp_tpu.service import ServiceProcessor as JServiceProcessor
from vpp_tpu.testing import faults as jfaults
from vpp_tpu_torch.ir.rule import PodID
from vpp_tpu_torch.ksr import model as tm
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.service import ServiceConfigurator, ServiceProcessor
from vpp_tpu_torch.testing import faults as tfaults

VIP = "10.96.0.10"


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    jfaults.uninstall()
    tfaults.uninstall()


def service_names(port: bool, log: list) -> dict:
    """The names the service tests import, from one package."""
    jd, td = logging_dataplanes(log)
    if port:
        return dict(PodID=PodID, m=tm, Dataplane=td, VEC=tvector.VEC,
                    Disposition=tvector.Disposition, ip4=tvector.ip4,
                    ip4_str=tvector.ip4_str,
                    make_packet_vector=tvector.make_packet_vector,
                    ServiceConfigurator=ServiceConfigurator,
                    ServiceProcessor=ServiceProcessor)
    return dict(PodID=JPodID, m=jm, Dataplane=jd, VEC=jvector.VEC,
                Disposition=jvector.Disposition, ip4=jvector.ip4,
                ip4_str=jvector.ip4_str,
                make_packet_vector=jvector.make_packet_vector,
                ServiceConfigurator=JServiceConfigurator,
                ServiceProcessor=JServiceProcessor)


SVC_CASES = sorted(n for n in vars(jsvc) if n.startswith("test_"))


@pytest.mark.parametrize("case", SVC_CASES)
def test_service_e2e_scenarios(case):
    """Each reference scenario's own assertions hold on the port, every
    swap publishes the same staged tables, and every packet gets the
    same verdict and rewritten header in both packages."""
    logs = {}
    for port in (False, True):
        logs[port] = []
        run_case(jsvc, case, service_names(port, logs[port]))
    assert logs[True] == logs[False]
    assert any(e[0] != "swap" for e in logs[True])
    assert len(SVC_CASES) == 8


# --- the service.churn seam ---------------------------------------------

_CHURN_CFG = dict(max_tables=2, max_rules=8, max_global_rules=8,
                  max_ifaces=8, fib_slots=32, sess_slots=512,
                  nat_mappings=2, nat_backends=4, svc_vips=16,
                  svc_backend_ways=8)


class _Pkg:
    """One package's service stack on the churn test's small node."""

    def __init__(self, port: bool):
        self.port = port
        self.m = tm if port else jm
        self.v = tvector if port else jvector
        self.faults = tfaults if port else jfaults
        if port:
            self.dp = tdp.Dataplane(ttables.DataplaneConfig(**_CHURN_CFG),
                                    device="cpu")
        else:
            self.dp = jdp.Dataplane(jtables.DataplaneConfig(**_CHURN_CFG))
        dp, D = self.dp, self.v.Disposition
        self.up = dp.add_uplink()
        pod = dp.add_pod_interface(("default", "web"))
        dp.builder.add_route("10.1.1.0/24", pod, D.LOCAL)
        dp.builder.add_route("10.200.0.0/16", pod, D.LOCAL)
        dp.builder.add_route("0.0.0.0/0", self.up, D.REMOTE)
        dp.swap()
        cfg = (ServiceConfigurator if port else JServiceConfigurator)(
            dp, node_ips=[])
        self.cfg = cfg
        self.proc = (ServiceProcessor if port else JServiceProcessor)(
            cfg, node_name="node-a")

    def service(self):
        m = self.m
        return m.Service(
            name="web", namespace="default", cluster_ip=VIP,
            external_traffic_policy="Cluster",
            ports=[m.ServicePort(name="http", protocol="TCP", port=80,
                                 target_port="http", node_port=0)])

    def endpoints(self, ips):
        m = self.m
        return m.Endpoints(
            name="web", namespace="default",
            subsets=[m.EndpointSubset(
                addresses=[m.EndpointAddress(ip=i, node_name="node-b")
                           for i in ips],
                ports=[m.EndpointPort(name="http", port=8080,
                                      protocol="TCP")])])

    def picks(self, n, now, seed=500):
        """The DNAT picks (and dispositions) of ``n`` VIP flows probed
        at ``now``: nothing is installed."""
        pkts = self.v.make_packet_vector(
            [{"src": f"10.9.{(seed + i) // 200}.{(seed + i) % 200 + 1}",
              "dst": VIP, "proto": 6,
              "sport": 1024 + (37 * (seed + i)) % 50000, "dport": 80,
              "rx_if": self.up, "ttl": 64} for i in range(n)], n=n)
        r = self.dp.probe(pkts, now=now)
        return (np.asarray(r.pkts.dst_ip).view(np.uint32).tolist(),
                np.asarray(r.disp).tolist())

    def host(self):
        return {k: np.array(v) for k, v in
                self.dp.builder.host_arrays().items()}


def _arm(pkg, seed):
    plan = pkg.faults.install(pkg.faults.FaultPlan(seed=seed))
    plan.inject("service.churn", after=0, times=1)


def _same_host(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_churn_fault_rolls_back_the_backend_roll():
    """A fault at the first staged mutation of a backend roll: the
    update raises, no epoch is published, the builder's host arrays are
    the pre-churn ones and the old set serves every flow; the same roll
    re-driven converges. Each step equal across the packages."""
    seen = {}
    for port in (False, True):
        pkg = _Pkg(port)
        pkg.proc.update_service(pkg.service())
        pkg.proc.update_endpoints(pkg.endpoints(["10.200.0.10",
                                                 "10.200.0.11"]))
        before, disp = pkg.picks(64, now=1)
        ip4 = pkg.v.ip4
        assert set(before) <= {ip4("10.200.0.10"), ip4("10.200.0.11")}
        epoch, host0 = pkg.dp.epoch, pkg.host()
        _arm(pkg, 19)
        with pytest.raises(pkg.faults.FaultInjected):
            pkg.proc.update_endpoints(pkg.endpoints(["10.200.0.10",
                                                     "10.200.0.77"]))
        assert pkg.dp.epoch == epoch
        _same_host(pkg.host(), host0)
        during, ddisp = pkg.picks(64, now=2)
        assert during == before
        assert ddisp == [int(pkg.v.Disposition.LOCAL)] * 64
        pkg.faults.uninstall()
        pkg.proc.update_endpoints(pkg.endpoints(["10.200.0.10",
                                                 "10.200.0.77"]))
        assert pkg.dp.epoch == epoch + 1
        after, _ = pkg.picks(64, now=3)
        assert set(after) <= {ip4("10.200.0.10"), ip4("10.200.0.77")}
        kept = [a for a, b in zip(after, before) if b == ip4("10.200.0.10")]
        assert kept == [b for b in before if b == ip4("10.200.0.10")]
        seen[port] = (before, during, after, staged_digest(pkg.dp.builder))
    assert seen[True] == seen[False]


def test_churn_fault_rolls_back_a_service_delete():
    """A fault mid-delete leaves the VIP registered and serving; the
    resync with the fault cleared removes it, in both packages."""
    seen = {}
    for port in (False, True):
        pkg = _Pkg(port)
        pkg.proc.update_service(pkg.service())
        pkg.proc.update_endpoints(pkg.endpoints(["10.200.0.10"]))
        key = (pkg.v.ip4(VIP), 80, 6)
        epoch, host0 = pkg.dp.epoch, pkg.host()
        _arm(pkg, 20)
        with pytest.raises(pkg.faults.FaultInjected):
            pkg.proc.delete_service("default", "web")
        assert pkg.dp.epoch == epoch and key in pkg.dp.builder.services
        _same_host(pkg.host(), host0)
        picks, _ = pkg.picks(8, now=1)
        assert picks == [pkg.v.ip4("10.200.0.10")] * 8
        pkg.faults.uninstall()
        pkg.cfg.resync(list(pkg.cfg.services.values()))
        assert key not in pkg.dp.builder.services
        seen[port] = (picks, staged_digest(pkg.dp.builder))
    assert seen[True] == seen[False]


def test_service_configurator_fires_the_seam_once_per_mutation():
    """The port's configurator fires ``service.churn`` after every staged
    svc-plane mutation, as the reference's does: one VIP staged, then
    one deleted, are one firing each."""
    counts = {}
    for port in (False, True):
        pkg = _Pkg(port)
        pkg.proc.update_service(pkg.service())
        plan = pkg.faults.install(pkg.faults.FaultPlan(seed=1))
        plan.inject("service.churn", after=10**6, times=1)
        pkg.proc.update_endpoints(pkg.endpoints(["10.200.0.10"]))
        staged = plan.calls("service.churn")
        pkg.proc.delete_service("default", "web")
        counts[port] = (staged, plan.calls("service.churn"))
        pkg.faults.uninstall()
    assert counts[True] == counts[False] == (1, 2)
