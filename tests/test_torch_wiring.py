"""Kernel interfaces: the port's pod wiring, host interconnect and STN
backend on real veths and named netns.

The scenarios of tests/test_pod_wiring.py on the port's stack: the
port's ``Dataplane`` (on the CPU), ``RemoteCNIServer`` with a
``VethPodWirer``, ``IODaemon`` with a real ``IOControlServer`` socket and
``DataplanePump``; two named netns stand in for pods. A CNI Add wires a
veth into each netns and attaches its host end to the daemon; UDP
between the pods crosses the daemon, the rings and the pipeline; a deny
cuts one port; a CNI Delete removes the veth; a failed wire rolls back;
a TTL-1 probe gets its time-exceeded from the gateway; pings cross
without loss; a TCP handshake returns through the reflective session
that a deny would otherwise drop; the host pings a pod through the
``HostInterconnectWirer``'s veth. Then the reference's
``test_health.py::test_stn_real_kernel_steal_crash_autorevert`` on the
port's ``LinuxNetlink``. Every name (netns, veths, addresses) is this
file's own, so the reference's tests can run beside these.

The cases need ``ip netns add`` (CAP_NET_ADMIN); without it each skips
with that reason. Every wait is on an event with a deadline of at most
30 s (the pod processes print when they are bound), never a fixed
settle. Every quantity compared is an integer or a string: the
tolerance is exact equality.
"""

from __future__ import annotations

import ipaddress
import os
import subprocess
import sys
import time

import pytest

from test_pod_wiring import _ping, _traceroute_hop

from vpp_tpu_torch.cni.model import CNIRequest, ResultCode
from vpp_tpu_torch.cni.server import RemoteCNIServer
from vpp_tpu_torch.cni.wiring import (
    GATEWAY_MAC,
    HostInterconnectWirer,
    VethPodWirer,
    host_ifname,
)
from vpp_tpu_torch.health.stn import STNDaemon, Watchdog
from vpp_tpu_torch.health.stn_netlink import LinuxNetlink
from vpp_tpu_torch.io.control import IOControlClient, IOControlServer
from vpp_tpu_torch.io.daemon import IODaemon
from vpp_tpu_torch.io.pump import DataplanePump
from vpp_tpu_torch.io.rings import IORingPair
from vpp_tpu_torch.ipam.ipam import IPAM, IpamConfig
from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.tables import DataplaneConfig
from vpp_tpu_torch.pipeline.vector import Disposition

NS_A, NS_B = "vpptt-poda", "vpptt-podb"
CID_A = "a7a71111b7b72222"
CID_B = "d7d73333e7e74444"
HOST_END, VSW_END = "vpptt-host", "vpptt-vsw"
# subnets of this file's own: the host interconnect routes them in the
# host's namespace, beside whatever the reference's tests route there
IPAM_CFG = IpamConfig(pod_subnet_cidr="10.71.0.0/16",
                      vpp_host_subnet_cidr="172.29.0.0/16",
                      service_cidr="10.112.0.0/12")
DEADLINE = 30.0


def _ip(*args, check=False):
    return subprocess.run(["ip", *args], capture_output=True, text=True,
                          timeout=DEADLINE, check=check)


def _cleanup():
    for ns in (NS_A, NS_B):
        _ip("netns", "del", ns)
    for cid in (CID_A, CID_B):
        _ip("link", "del", host_ifname(cid))
    _ip("link", "del", HOST_END)


@pytest.fixture(scope="module")
def netns_ok():
    name = f"vpptt-probe{os.getpid()}"
    try:
        r = _ip("netns", "add", name)
    except (OSError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"needs CAP_NET_ADMIN (netns/veth): {e}")
    if r.returncode != 0:
        pytest.skip(f"needs CAP_NET_ADMIN (netns/veth): {r.stderr.strip()}")
    _ip("netns", "del", name)


@pytest.fixture()
def stack(netns_ok, tmp_path):
    """The port's dataplane + CNI server with a wirer + IO daemon with a
    real control socket + pump, and two empty named netns."""
    _cleanup()
    for ns in (NS_A, NS_B):
        _ip("netns", "add", ns, check=True)
    dp = Dataplane(DataplaneConfig(), device="cpu")
    uplink = dp.add_uplink()
    host_if = dp.add_host_interface()
    dp.builder.set_global_table(
        [ContivRule(action=Action.PERMIT, protocol=Protocol.ANY)])
    dp.swap()
    rings = IORingPair(n_slots=32)
    daemon = IODaemon(rings, {}, uplink_if=uplink, host_if=host_if).start()
    ctl_sock = str(tmp_path / "io-ctl.sock")
    control = IOControlServer(daemon, ctl_sock).start()
    ipam = IPAM(node_id=1, config=IPAM_CFG)
    pump = DataplanePump(dp, rings, icmp_src_ip=int(ipam.pod_gateway_ip()))
    pump.warm()
    pump.start()
    wirer = VethPodWirer(IOControlClient(ctl_sock),
                         gateway_ip=str(ipam.pod_gateway_ip()))
    server = RemoteCNIServer(dp, ipam, wirer=wirer)
    server.set_ready()
    try:
        yield {"dp": dp, "server": server, "daemon": daemon, "ipam": ipam,
               "ctl_sock": ctl_sock, "host_if": host_if}
    finally:
        assert pump.stop(join_timeout=DEADLINE)
        control.close()
        assert daemon.stop(join_timeout=DEADLINE)
        for t in daemon.transports.values():
            t.close()
        rings.close()
        _cleanup()


def _add_pod(server, cid: str, ns: str, name: str) -> str:
    reply = server.add(CNIRequest(
        container_id=cid, netns=f"/var/run/netns/{ns}", if_name="eth0",
        extra_args={"K8S_POD_NAME": name, "K8S_POD_NAMESPACE": "default"}))
    assert reply.result == ResultCode.OK, reply.error
    return reply.interfaces[0].ip_addresses[0].address.split("/")[0]


def _in_ns(ns: str, code: str) -> subprocess.Popen:
    return subprocess.Popen(
        ["ip", "netns", "exec", ns, sys.executable, "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _bound(proc: subprocess.Popen) -> None:
    """Wait for the pod process's 'bound' line."""
    line = proc.stdout.readline()
    assert line.strip() == "bound", (line, proc.stderr.read())


def _udp_receiver(ns: str, port: int) -> subprocess.Popen:
    proc = _in_ns(ns, (
        "import socket\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
        f"s.bind(('0.0.0.0', {port}))\n"
        "print('bound', flush=True)\n"
        f"s.settimeout({DEADLINE})\n"
        "data, peer = s.recvfrom(4096)\n"
        "print(data.decode() + '|' + peer[0], flush=True)\n"))
    _bound(proc)
    return proc


def _udp_send(ns: str, dst: str, port: int, msg: str, times: int) -> None:
    subprocess.run(
        ["ip", "netns", "exec", ns, sys.executable, "-c",
         "import socket, time\n"
         "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
         f"for _ in range({times}):\n"
         f"    s.sendto({msg!r}.encode(), ('{dst}', {port}))\n"
         "    time.sleep(0.05)\n"],
        check=True, timeout=DEADLINE, capture_output=True)


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + DEADLINE
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _deny(dp, name: str, src_pod: str, rules) -> None:
    slot = dp.alloc_table_slot(name)
    with dp.commit_lock:
        dp.builder.set_local_table(slot, rules)
        dp.assign_pod_table(("default", src_pod), name)
        dp.swap()


def test_host_ifname_is_the_references():
    from vpp_tpu.cni.wiring import host_ifname as ref_host_ifname

    for cid in ("aaaa1111bbbb2222cccc", "0-1-2-3", "x", CID_A,
                "f" * 64, "abc-def-0123456789"):
        assert host_ifname(cid) == ref_host_ifname(cid)
        assert len(host_ifname(cid)) <= 15


def test_add_wires_real_interfaces_and_udp_flows(stack):
    server, dp, daemon = stack["server"], stack["dp"], stack["daemon"]
    ip_a = _add_pod(server, CID_A, NS_A, "pod-a")
    ip_b = _add_pod(server, CID_B, NS_B, "pod-b")
    assert _ip("link", "show", host_ifname(CID_A)).returncode == 0
    assert ip_b in _ip("-n", NS_B, "-o", "addr", "show", "eth0").stdout
    assert set(daemon.transports) >= {dp.pod_if[("default", "pod-a")],
                                      dp.pod_if[("default", "pod-b")]}
    # the static ARP for the gateway and the pods' pinned MACs
    neigh = _ip("-n", NS_A, "neigh", "show", "dev", "eth0").stdout
    assert ":".join(f"{b:02x}" for b in GATEWAY_MAC) in neigh
    pinned = {ip for ip, _, pin in daemon.mac.entries() if pin}
    assert {int(ipaddress.ip_address(ip_a)),
            int(ipaddress.ip_address(ip_b))} <= pinned

    recv = _udp_receiver(NS_B, 5354)
    _udp_send(NS_A, ip_b, 5354, "hello-through-the-card", times=20)
    out, err = recv.communicate(timeout=DEADLINE)
    assert "hello-through-the-card" in out and ip_a in out, (out, err)

    # deny UDP:5355 toward pod B from pod A: the classifier drops it
    _deny(dp, "deny-b", "pod-a", [
        ContivRule(action=Action.DENY,
                   dest_network=ipaddress.ip_network(f"{ip_b}/32"),
                   protocol=Protocol.UDP, dest_port=5355),
        ContivRule(action=Action.PERMIT)])
    recv2 = _udp_receiver(NS_B, 5355)
    drops = daemon.stats["tx_drops"]
    _udp_send(NS_A, ip_b, 5355, "must-not-arrive", times=5)
    _wait(lambda: daemon.stats["tx_drops"] >= drops + 5, "5 drops")
    recv2.kill()
    out2, _ = recv2.communicate(timeout=DEADLINE)
    assert "must-not-arrive" not in (out2 or "")

    # CNI Delete tears the kernel path down
    assert server.delete(CNIRequest(container_id=CID_A)).result == \
        ResultCode.OK
    assert _ip("link", "show", host_ifname(CID_A)).returncode != 0
    assert dp.pod_if.get(("default", "pod-a")) is None
    pinned = {ip for ip, _, pin in daemon.mac.entries() if pin}
    assert int(ipaddress.ip_address(ip_a)) not in pinned


def test_failed_wire_rolls_back(stack):
    server, ipam = stack["server"], stack["ipam"]
    before = ipam.assigned_count()
    reply = server.add(CNIRequest(
        container_id="feedfacefeedf00d", netns="/var/run/netns/vpptt-nope",
        if_name="eth0", extra_args={"K8S_POD_NAME": "ghost"}))
    assert reply.result == ResultCode.ERROR
    assert ipam.assigned_count() == before
    assert stack["dp"].pod_if.get(("default", "ghost")) is None
    assert server.index.lookup("feedfacefeedf00d") is None
    assert _ip("link", "show", host_ifname("feedfacefeedf00d")).returncode


def test_ttl1_probe_reports_the_gateway_hop(stack):
    server, ipam = stack["server"], stack["ipam"]
    _add_pod(server, CID_A, NS_A, "pod-a")
    ip_b = _add_pod(server, CID_B, NS_B, "pod-b")
    res = _traceroute_hop(NS_A, ip_b, ttl=1)
    assert res.returncode == 0 and res.stdout.strip(), res.stderr
    hop_ip, icmp_type = res.stdout.strip().split("|")
    assert (hop_ip, int(icmp_type)) == (str(ipam.pod_gateway_ip()), 11)


def test_ping_pod_to_pod_zero_loss(stack):
    server = stack["server"]
    _add_pod(server, CID_A, NS_A, "pod-a")
    ip_b = _add_pod(server, CID_B, NS_B, "pod-b")
    _ping(NS_A, ip_b, count=2)  # the pods' first ARP and attach
    res = _ping(NS_A, ip_b, count=5)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().split("|") == ["5", "5"], res.stderr


def test_tcp_handshake_reflective_return(stack):
    """Pod B's table denies traffic it originates toward pod A; pod A's
    TCP connection to pod B still completes, its return segments
    admitted by the reflective session the SYN created."""
    server, dp, daemon = stack["server"], stack["dp"], stack["daemon"]
    ip_a = _add_pod(server, CID_A, NS_A, "pod-a")
    ip_b = _add_pod(server, CID_B, NS_B, "pod-b")
    _deny(dp, "b-sends", "pod-b", [
        ContivRule(action=Action.DENY,
                   dest_network=ipaddress.ip_network(f"{ip_a}/32")),
        ContivRule(action=Action.PERMIT)])
    drops = daemon.stats["tx_drops"]
    _udp_send(NS_B, ip_a, 9999, "unsolicited", times=3)
    _wait(lambda: daemon.stats["tx_drops"] >= drops + 3, "3 drops")
    srv = _in_ns(NS_B, (
        "import socket\n"
        "ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
        "ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)\n"
        "ls.bind(('0.0.0.0', 8080))\n"
        "ls.listen(4)\n"
        "print('bound', flush=True)\n"
        f"ls.settimeout({DEADLINE})\n"
        "while True:\n"
        "    c, peer = ls.accept()\n"
        "    c.settimeout(10)\n"
        "    data = c.recv(4096)\n"
        "    if data:\n"
        "        c.sendall(b'pong:' + data)\n"
        "        print('served ' + peer[0], flush=True)\n"
        "        break\n"))
    try:
        _bound(srv)
        cli = subprocess.run(
            ["ip", "netns", "exec", NS_A, sys.executable, "-c",
             "import socket\n"
             "s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
             "s.settimeout(20)\n"
             f"s.connect(('{ip_b}', 8080))\n"
             "s.sendall(b'ping-tcp')\n"
             "print(s.recv(4096).decode(), flush=True)\n"],
            capture_output=True, text=True, timeout=DEADLINE)
        assert cli.returncode == 0, (cli.stdout, cli.stderr)
        assert "pong:ping-tcp" in cli.stdout
        out, err = srv.communicate(timeout=DEADLINE)
        assert f"served {ip_a}" in out, (out, err)
    finally:
        srv.kill()
        srv.wait(timeout=DEADLINE)


def test_host_pings_pod_through_the_interconnect(stack):
    server, dp, ipam = stack["server"], stack["dp"], stack["ipam"]
    ip_b = _add_pod(server, CID_B, NS_B, "pod-b")
    # the agent stages this route (routesToHost); this stack stages it
    with dp.commit_lock:
        dp.builder.add_route(str(ipam.vpp_host_network), stack["host_if"],
                             Disposition.HOST)
        dp.swap()
    wirer = HostInterconnectWirer(IOControlClient(stack["ctl_sock"]), ipam,
                                  host_end=HOST_END, vsw_end=VSW_END)
    wirer.wire(stack["host_if"])
    try:
        assert str(ipam.veth_host_end_ip()) in _ip(
            "-o", "addr", "show", HOST_END).stdout
        routes = _ip("route", "show").stdout
        assert str(ipam.pod_subnet) in routes
        assert str(ipam.service_network) in routes
        _ping(None, ip_b, count=2)  # the first ARP and attach
        res = _ping(None, ip_b, count=5)
        assert res.stdout.strip().split("|") == ["5", "5"], res.stderr
        res2 = _ping(NS_B, str(ipam.veth_host_end_ip()), count=3)
        assert res2.stdout.strip().split("|") == ["3", "3"], res2.stderr
    finally:
        wirer.unwire(stack["host_if"])
    assert _ip("link", "show", HOST_END).returncode != 0


def test_stn_real_kernel_steal_crash_autorevert(netns_ok, tmp_path):
    """test_health.py's case on the port's ``LinuxNetlink``: steal a
    veth's addressing, the watchdog sees the agent die and restores the
    exact addresses and routes, a second steal and a release."""
    dev, peer = "vppttstn0", "vppttstn1"
    _ip("link", "del", dev)
    assert _ip("link", "add", dev, "type", "veth", "peer", "name",
               peer).returncode == 0
    try:
        _ip("link", "set", dev, "up")
        _ip("link", "set", peer, "up")
        _ip("addr", "add", "10.87.0.2/24", "dev", dev)
        _ip("route", "add", "10.88.0.0/24", "via", "10.87.0.1", "dev", dev,
            "onlink")
        daemon = STNDaemon(LinuxNetlink(),
                           persist_path=str(tmp_path / "stn.json"))
        info = daemon.steal(dev)
        assert "10.87.0.2/24" in info.ip_addresses
        assert {"dst": "10.88.0.0/24", "gw": "10.87.0.1"} in info.routes
        assert "10.87.0.2" not in _ip("-o", "addr", "show", "dev",
                                      dev).stdout
        dog = Watchdog(daemon, probe=lambda: False, grace_failures=2)
        dog.tick()
        dog.tick()
        assert "10.87.0.2/24" in _ip("-o", "addr", "show", "dev",
                                     dev).stdout
        routes = _ip("route", "show", "10.88.0.0/24").stdout
        assert "10.87.0.1" in routes and dev in routes
        assert daemon.stolen_interface_info(dev) is None
        info2 = daemon.steal(dev)
        assert "10.87.0.2/24" in info2.ip_addresses
        daemon.release(dev)
        assert "10.87.0.2" in _ip("-o", "addr", "show", "dev", dev).stdout
    finally:
        _ip("link", "del", dev)
