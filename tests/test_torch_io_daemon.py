"""The IO daemon: vpp_tpu_torch's against vpp_tpu's, in process and as
its own process.

* A differential on the scenarios of tests/test_io.py (``TestWireToWire``
  and ``TestIcmpErrors``): one node per package, each its ``Dataplane``
  staged as test_io's ``IoHarness`` stages it (the port's on the CPU),
  its ``IORingPair``, its ``IODaemon`` over socketpair transports (client,
  server, uplink, host; the same interface MACs on both sides) and its
  ``DataplanePump`` with ICMP errors on. Each scenario sends the same
  frame into both nodes and waits until each daemon's tx counters
  account for every packet it received and every ICMP error its pump
  made; then the bytes each wire socket received, the daemon's stats
  and the pump's drop and ICMP counters must be equal, and the sockets
  the scenario names must have received.
* test_io's ``TestCodecSafety`` and ``TestBatchSyscalls`` run as written
  on the port's codec and transports (``test_torch_agent.port_case``).
* Across processes: ``python -m vpp_tpu_torch.cmd.io_daemon`` on the
  port's shared-memory rings and pump (test_io's
  ``TestCrossProcessDaemon``), killed with SIGKILL and started again from
  the same argv (the init supervisor's respawn): it attaches to the same
  rings and carries the next frame. Then the reference's daemon process
  on the port's rings and pump, and the port's daemon process on the
  reference's rings and pump (the ring layout is byte-identical). The
  daemon's process imports no torch, so on the card's host it takes no
  CUDA context.
* The control channel's wire format: each package's ``IOControlClient``
  against each package's ``IOControlServer``, the same requests, the
  same replies.

Every wait has a deadline of at most 30 s (60 s for a process that
imports the reference's JAX stack). Every quantity compared is an
integer or a byte: the tolerance is exact equality.
"""

from __future__ import annotations

import ipaddress
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import test_io as jio_tests
from test_torch_agent import port_case
from wire import make_frame

from vpp_tpu import io as jio
from vpp_tpu.io import control as jcontrol
from vpp_tpu.ir import rule as jrule
from vpp_tpu.native import pktio as jpktio
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.trace import tracer as jtracer
from vpp_tpu_torch import io as tio
from vpp_tpu_torch.io import control as tcontrol
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.native import pktio as tpktio
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline.vector import Disposition, ip4
from vpp_tpu_torch.trace import tracer as ttracer

ROOT = Path(__file__).resolve().parent.parent
CLIENT_IP = jio_tests.CLIENT_IP
SERVER_IP = jio_tests.SERVER_IP
REMOTE_POD = jio_tests.REMOTE_POD
GW_IP = jio_tests.GW_IP
VTEP_SELF = jio_tests.VTEP_SELF
VTEP_PEER = jio_tests.VTEP_PEER
DEADLINE = 30.0
WIRES = ("client", "server", "uplink", "host")
# each wire's daemon-side MAC, the same in both packages (a
# SocketPairTransport draws a random one)
MACS = {name: bytes([0x02, 0, 0, 0, 0x10, k]) for k, name in
        enumerate(WIRES)}
PKG = {"ref": (jdp, jtables, jio, jrule, jpktio, jtracer),
       "port": (tdp, ttables, tio, trule, tpktio, ttracer)}


class Node:
    """test_io's ``IoHarness`` in one package: the dataplane, the rings,
    the daemon over socketpairs and the pump."""

    def __init__(self, side: str):
        dp_mod, t_mod, io_mod, r, _, _ = PKG[side]
        cfg = t_mod.DataplaneConfig()
        self.dp = dp = (dp_mod.Dataplane(cfg) if side == "ref"
                        else dp_mod.Dataplane(cfg, device="cpu"))
        self.uplink_if = dp.add_uplink()
        self.host_if = dp.add_host_interface()
        client_if = dp.add_pod_interface(("default", "client"))
        server_if = dp.add_pod_interface(("default", "server"))
        dp.builder.add_route(f"{CLIENT_IP}/32", client_if,
                             Disposition.LOCAL)
        dp.builder.add_route(f"{SERVER_IP}/32", server_if,
                             Disposition.LOCAL)
        dp.builder.add_route("10.1.2.0/24", self.uplink_if,
                             Disposition.REMOTE, node_id=2,
                             next_hop=ip4(VTEP_PEER))
        dp.set_vtep(ip4(VTEP_SELF))
        slot = dp.alloc_table_slot("t-server")
        dp.builder.set_local_table(slot, [
            r.ContivRule(action=r.Action.PERMIT,
                         dest_network=ipaddress.ip_network(f"{SERVER_IP}/32"),
                         protocol=r.Protocol.UDP, dest_port=80),
            r.ContivRule(action=r.Action.PERMIT,
                         dest_network=ipaddress.ip_network("10.1.2.0/24"),
                         protocol=r.Protocol.UDP, dest_port=80),
            r.ContivRule(action=r.Action.DENY),
        ])
        dp.assign_pod_table(("default", "client"), "t-server")
        dp.builder.set_global_table(
            [r.ContivRule(action=r.Action.PERMIT, protocol=r.Protocol.ANY)])
        dp.swap()
        self.rings = io_mod.IORingPair(n_slots=8)
        self.inside, self.outside = {}, {}
        ifs = {"client": client_if, "server": server_if,
               "uplink": self.uplink_if, "host": self.host_if}
        for name in WIRES:
            inside, outside = io_mod.SocketPairTransport.pair(name)
            inside.mac = MACS[name]
            outside.sock.setblocking(True)
            self.inside[ifs[name]] = inside
            self.outside[name] = outside
        self.daemon = io_mod.IODaemon(
            self.rings, self.inside, uplink_if=self.uplink_if,
            host_if=self.host_if, vtep_ip=ip4(VTEP_SELF)).start()
        self.pump = io_mod.DataplanePump(dp, self.rings,
                                         icmp_src_ip=ip4(GW_IP))
        if side == "port":
            self.pump.warm()
        self.pump.start()
        self.sent = 0

    def send(self, wire: str, frame: bytes) -> None:
        self.outside[wire].sock.send(frame)
        self.sent += 1

    def accounted(self, icmp: int) -> bool:
        s = self.daemon.stats
        out = s["tx_pkts"] + s["tx_drops"] + s["tx_punts"] + s["trunc_drops"]
        made = self.pump.stats.get("icmp_errors", 0)
        return (s["rx_pkts"] == self.sent and made == icmp
                and out == self.sent + made)

    def drain(self) -> dict:
        out = {}
        for name, t in self.outside.items():
            t.sock.setblocking(False)
            got = []
            try:
                while True:
                    got.append(t.sock.recv(65535))
            except BlockingIOError:
                pass
            t.sock.setblocking(True)
            out[name] = got
        return out

    def close(self) -> None:
        assert self.pump.stop(join_timeout=DEADLINE)
        assert self.daemon.stop(join_timeout=DEADLINE)
        for t in list(self.inside.values()) + list(self.outside.values()):
            t.close()
        self.rings.close()


@pytest.fixture(scope="module")
def nodes():
    pair = {"ref": Node("ref"), "port": Node("port")}
    pair["icmp"] = 0
    yield pair
    for side in ("ref", "port"):
        pair[side].close()


def exchange(nodes, wire: str, frame: bytes, icmp: int = 0) -> dict:
    """Send ``frame`` on ``wire`` of both nodes; wait until each daemon
    accounts for it (and for the ``icmp`` errors it must raise); return
    what each wire received, equal on both sides, and compare the
    counters."""
    nodes["icmp"] += icmp
    got = {}
    for side in ("ref", "port"):
        node = nodes[side]
        node.send(wire, frame)
        deadline = time.monotonic() + DEADLINE
        while not node.accounted(nodes["icmp"]):
            assert time.monotonic() < deadline, (side, node.daemon.stats)
            time.sleep(0.002)
        got[side] = node.drain()
    assert got["port"] == got["ref"]
    # a daemon's tx thread counts the frame (tx_frames) only after the
    # packet counters that ``accounted`` reads: wait for both to settle
    deadline = time.monotonic() + DEADLINE
    while (nodes["port"].daemon.stats != nodes["ref"].daemon.stats
           and time.monotonic() < deadline):
        time.sleep(0.002)
    assert nodes["port"].daemon.stats == nodes["ref"].daemon.stats
    for key in tio.pump.PUMP_DROP_KEYS + ("icmp_errors",):
        assert nodes["port"].pump.stats.get(key) == \
            nodes["ref"].pump.stats.get(key), key
    return {w: len(v) for w, v in got["ref"].items() if v}


def _vxlan_from_peer(inner: bytes) -> bytes:
    arr = np.frombuffer(inner, np.uint8)
    return jpktio.PacketCodec().encap(
        np.ascontiguousarray(arr), len(inner), ip4(VTEP_PEER),
        ip4(VTEP_SELF), 50000, 10,
        b"\x02\x00\x00\x00\x00\x09", b"\x02\x00\x00\x00\x00\x08")


_ARP = (b"\xff" * 6 + b"\x02\x00\x00\x00\x00\x01" + b"\x08\x06"
        + b"\x00" * 28)

# test_io's scenarios in its order: (name, ingress wire, frame, ICMP
# errors it raises, the wires that receive)
SCENARIOS = [
    ("permitted_udp_forwarded_to_server", "client",
     make_frame(CLIENT_IP, SERVER_IP, proto=17, dport=80), 0,
     {"server": 1}),
    ("denied_udp_dropped", "client",
     make_frame(CLIENT_IP, SERVER_IP, proto=17, dport=9999), 0, {}),
    ("remote_pod_vxlan_encapped_to_peer", "client",
     make_frame(CLIENT_IP, REMOTE_POD, proto=17, dport=80), 0,
     {"uplink": 1}),
    ("non_ip_frame_punted_to_host", "client", _ARP, 0, {"host": 1}),
    ("vxlan_from_peer_decapped_and_delivered", "uplink",
     _vxlan_from_peer(make_frame(REMOTE_POD, SERVER_IP, proto=17,
                                 dport=80)), 0, {"server": 1}),
    ("ttl_expired_generates_time_exceeded", "client",
     make_frame(CLIENT_IP, SERVER_IP, proto=17, dport=80, ttl=1), 1,
     {"client": 1}),
    ("no_route_generates_net_unreachable", "server",
     make_frame(SERVER_IP, "203.0.113.9", proto=17, dport=80), 1,
     {"server": 1}),
    ("policy_deny_generates_no_icmp", "client",
     make_frame(CLIENT_IP, SERVER_IP, proto=17, dport=9999), 0, {}),
    ("remote_sender_gets_vxlan_encapped_time_exceeded", "uplink",
     _vxlan_from_peer(make_frame(REMOTE_POD, SERVER_IP, proto=17,
                                 dport=80, ttl=1)), 1, {"uplink": 1}),
]


@pytest.mark.parametrize("name,wire,frame,icmp,want", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_wire_to_wire_differential(nodes, name, wire, frame, icmp, want):
    assert exchange(nodes, wire, frame, icmp) == want


def test_armed_tracer_captures_pump_traffic(nodes):
    """The pump's tracing path forwards the frame and captures one entry
    per packet, the same entry in both packages."""
    tracers = {}
    for side in ("ref", "port"):
        tracers[side] = PKG[side][5].PacketTracer()
        nodes[side].dp.tracer = tracers[side]
        tracers[side].add(4)
    try:
        frame = make_frame(CLIENT_IP, SERVER_IP, proto=17, sport=41000,
                           dport=80)
        assert exchange(nodes, "client", frame) == {"server": 1}
        entries = {}
        for side, tr in tracers.items():
            deadline = time.monotonic() + DEADLINE
            while not tr.entries():
                assert time.monotonic() < deadline, side
                time.sleep(0.005)
            entries[side] = [(e.src, e.dst) for e in tr.entries()]
        assert entries["port"] == entries["ref"] == [(CLIENT_IP, SERVER_IP)]
    finally:
        for side in ("ref", "port"):
            nodes[side].dp.tracer = None


def test_stats_account_traffic(nodes):
    """test_io's ``test_stats_account_traffic`` on the port's node after
    the scenarios (the counters are equal to the reference's)."""
    s = nodes["port"].daemon.stats
    assert s["rx_frames"] >= 4 and s["tx_pkts"] >= 3
    assert s["vxlan_encap"] >= 1 and s["vxlan_decap"] >= 1
    assert s["drops_rx_full"] == 0
    assert nodes["port"].pump.stats["frames"] >= 4


CODEC_CASES = [f"TestCodecSafety.{m}" for m in sorted(
    vars(jio_tests.TestCodecSafety)) if m.startswith("test_")] + [
    f"TestBatchSyscalls.{m}" for m in sorted(
        vars(jio_tests.TestBatchSyscalls)) if m.startswith("test_")]


@pytest.mark.parametrize("case", CODEC_CASES)
def test_reference_codec_cases(case):
    """test_io's codec safety and batch-syscall cases, as written, on the
    port's codec and transports."""
    port_case(jio_tests, case)


# --- across processes -------------------------------------------------

def _stage(side: str):
    """test_io's ``TestCrossProcessDaemon`` dataplane: client, server,
    uplink, a permit-all global table."""
    dp_mod, t_mod, _, r, _, _ = PKG[side]
    cfg = t_mod.DataplaneConfig()
    dp = (dp_mod.Dataplane(cfg) if side == "ref"
          else dp_mod.Dataplane(cfg, device="cpu"))
    ifs = {"uplink": dp.add_uplink(),
           "client": dp.add_pod_interface(("default", "c")),
           "server": dp.add_pod_interface(("default", "s"))}
    dp.builder.add_route(f"{CLIENT_IP}/32", ifs["client"], Disposition.LOCAL)
    dp.builder.add_route(f"{SERVER_IP}/32", ifs["server"], Disposition.LOCAL)
    dp.set_vtep(ip4(VTEP_SELF))
    dp.builder.set_global_table(
        [r.ContivRule(action=r.Action.PERMIT, protocol=r.Protocol.ANY)])
    dp.swap()
    return dp, ifs


def _daemon_argv(package: str, shm: str, ifs: dict, pairs: dict) -> list:
    argv = [sys.executable, "-m", f"{package}.cmd.io_daemon", "--shm", shm,
            "--slots", "8", "--uplink", str(ifs["uplink"]),
            "--vtep", str(ip4(VTEP_SELF))]
    for name, (inside, _) in pairs.items():
        argv += ["--if", f"{ifs[name]}:fd:{inside.fileno()}"]
    return argv


def _through(pairs: dict, sport: int, timeout: float) -> bytes:
    """Send client -> server until a frame of flow ``sport`` arrives."""
    frame = make_frame(CLIENT_IP, SERVER_IP, proto=6, sport=sport, dport=80)
    srv = pairs["server"][1].sock
    srv.setblocking(True)
    srv.settimeout(0.5)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pairs["client"][1].sock.send(frame)
        try:
            while True:
                out = srv.recv(65535)
                if out[34:36] == sport.to_bytes(2, "big"):
                    return out
        except (socket.timeout, TimeoutError):
            continue
    raise AssertionError(f"flow {sport} never crossed the process boundary")


@pytest.mark.parametrize("daemon,rings", [("port", "port"), ("ref", "port"),
                                          ("port", "ref")])
def test_daemon_process_on_shared_rings(daemon, rings, tmp_path):
    """A daemon process of one package on the other's (or its own)
    shared-memory rings and pump; the port's daemon is then killed with
    SIGKILL and started again from the same argv, and must attach to
    the same rings and carry the next flow."""
    dp, ifs = _stage(rings)
    io_mod = PKG[rings][2]
    shm = f"vpp_tpu_torch_io_{daemon}_{rings}_{os.getpid()}"
    ring_pair = io_mod.IORingPair(n_slots=8, shm_name=shm, create=True)
    pump = io_mod.DataplanePump(dp, ring_pair)
    if rings == "port":
        pump.warm()
    pump.start()
    pairs = {name: PKG[rings][2].SocketPairTransport.pair(name)
             for name in ("client", "server", "uplink")}
    package = "vpp_tpu_torch" if daemon == "port" else "vpp_tpu"
    argv = _daemon_argv(package, shm, ifs, pairs)
    fds = [p[0].fileno() for p in pairs.values()]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    budget = DEADLINE if daemon == "port" else 2 * DEADLINE
    proc = subprocess.Popen(argv, pass_fds=fds, env=env)
    try:
        out = _through(pairs, 41001, budget)
        assert out[14 + 16:14 + 20] == ipaddress.ip_address(SERVER_IP).packed
        assert out[22] == 63
        if daemon == "port":
            proc.send_signal(signal.SIGKILL)
            assert proc.wait(timeout=DEADLINE) == -signal.SIGKILL
            assert os.path.exists(f"/dev/shm/{shm}")
            proc = subprocess.Popen(argv, pass_fds=fds, env=env)
            out = _through(pairs, 41002, budget)
            assert out[22] == 63
    finally:
        proc.terminate()
        proc.wait(timeout=DEADLINE)
        assert pump.stop(join_timeout=DEADLINE)
        for inside, outside in pairs.values():
            inside.close()
            outside.close()
        ring_pair.close(unlink=True)


def test_daemon_process_imports_no_torch():
    """The daemon's module and everything it imports are host code: its
    process never imports torch, so it can take no CUDA context."""
    code = ("import sys; import vpp_tpu_torch.cmd.io_daemon; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'vpp_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=DEADLINE)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --- the control channel's wire format --------------------------------

CONTROL = {"ref": (jio, jcontrol), "port": (tio, tcontrol)}


def _control_script(client) -> list:
    """A fixed sequence of control requests; every reply, in order."""
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
    out = []
    try:
        out.append(client.list_interfaces())
        out.append(client.attach(5, "fd", str(os.dup(a.fileno()))))
        out.append(client.list_interfaces())
        out.append(client.set_mac(ip4("10.1.1.9"), b"\x02\x00\x00\x00\x01\x09"))
        out.append(client.set_mac(ip4("10.1.1.9"), b"\x02\x00\x00\x00\x01\x0a"))
        out.append(sorted(client.neighbors()))
        out.append(client.del_mac(ip4("10.1.1.9")))
        out.append(client.del_mac(ip4("10.1.1.10")))
        out.append(sorted(client.neighbors()))
        out.append(client.stats())
        out.append(client.detach(5))
        out.append(client.detach(5))
        out.append(client.ping())
        for bad in (lambda: client.attach(6, "bogus", "x"),
                    lambda: client._call("nope")):
            with pytest.raises(RuntimeError) as err:
                bad()
            out.append(str(err.value))
    finally:
        a.close()
        b.close()
    return out


def test_control_wire_format_both_ways(tmp_path):
    """Each package's client against each package's server: the same
    replies (the daemons are built, not started: control requests touch
    only their transport table, neighbour table and counters)."""
    got = {}
    for srv_side in ("ref", "port"):
        for cli_side in ("ref", "port"):
            io_mod, ctl_mod = CONTROL[srv_side]
            rings = io_mod.IORingPair(n_slots=4)
            daemon = io_mod.IODaemon(rings, {}, uplink_if=0)
            path = str(tmp_path / f"{srv_side}-{cli_side}.sock")
            server = ctl_mod.IOControlServer(daemon, path).start()
            try:
                client = CONTROL[cli_side][1].IOControlClient(path,
                                                              timeout=5.0)
                got[(srv_side, cli_side)] = _control_script(client)
            finally:
                server.close()
                for t in daemon.transports.values():
                    t.close()
                rings.close()
    # the attached transport is named after its (per-run) fd number
    norm = {k: [r if i != 2 else {i5: n.rstrip("0123456789")
                                  for i5, n in r.items()}
                for i, r in enumerate(v)] for k, v in got.items()}
    assert norm[("ref", "ref")][2] == {5: "fd"}
    for key, replies in norm.items():
        assert replies == norm[("ref", "ref")], key


# --- the VXLAN byte codec ---------------------------------------------

@pytest.mark.parametrize("case", ["test_wire_codec_roundtrip",
                                  "test_wire_codec_rejects_non_vxlan"])
def test_reference_vxlan_codec_cases(case):
    """tests/test_vxlan.py's wire codec cases, as written, on the port's
    ``encode_frame`` / ``decode_frame``."""
    import test_vxlan as jvxlan_tests

    port_case(jvxlan_tests, case)


def test_vxlan_codec_cross_decodes():
    """Seeded headers: the port's bytes equal the reference's, each
    package decodes the other's, and a malformed frame raises the same
    ``ValueError`` in both."""
    from vpp_tpu.ops import vxlan as jv
    from vpp_tpu_torch.ops import vxlan as tv

    rng = np.random.default_rng(14)
    u32 = lambda: int(rng.integers(0, 1 << 32, dtype=np.uint64))  # noqa
    for k in range(64):
        outer = {"src": u32(), "dst": u32(),
                 "sport": int(rng.integers(0, 1 << 16)),
                 "ttl": int(rng.integers(1, 256))}
        inner = {"src": u32(), "dst": u32(),
                 "proto": int(rng.choice([6, 17, 1])),
                 "ttl": int(rng.integers(0, 256)),
                 "sport": int(rng.integers(0, 1 << 16)),
                 "dport": int(rng.integers(0, 1 << 16))}
        vni = int(rng.integers(0, 1 << 24))
        payload = rng.integers(0, 256, int(rng.integers(0, 64)),
                               dtype=np.uint8).tobytes()
        macs = ({} if k % 2 else dict(
            inner_src_mac=rng.integers(0, 256, 6, dtype=np.uint8).tobytes(),
            inner_dst_mac=rng.integers(0, 256, 6, dtype=np.uint8).tobytes()))
        wire = tv.encode_frame(outer, inner, vni, payload, **macs)
        assert wire == jv.encode_frame(outer, inner, vni, payload, **macs)
        assert tv.decode_frame(wire) == jv.decode_frame(wire)
        bad = bytearray(wire)
        pos = int(rng.choice([0, 9, 22, 23, 28, 48, 50]))
        bad[pos] ^= 0xFF
        for w in (bytes(bad), wire[:int(rng.integers(0, 78))]):
            try:
                want = jv.decode_frame(w)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tv.decode_frame(w)
                assert str(got.value) == str(e)
            else:
                assert tv.decode_frame(w) == want
