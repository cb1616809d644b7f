"""VCL: the host-stack socket shim.

Reference analog: VPP's VCL + ldpreload (tests/ld_preload*, the
contiv-cri shim injecting LD_PRELOAD env so app sockets ride VPP's TCP
stack and are filtered by session rules). Here the accelerated stack's
*policy surface* is reproduced: an app namespace opens sockets through
``HostStackApp``, and every connect()/accept() is checked against the
node's SessionRuleEngine before the OS proceeds — deny means the
connection never happens (connect raises, accept closes), exactly the
session-layer filtering the VPPTCP renderer programs.

The reference's ``vpp_tpu/hoststack/vcl.py``, over the port's
``SessionRuleEngine`` (its filter runs as tensor ops on the engine's
device); the port keeps its own copy and never imports the JAX package.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

from vpp_tpu_torch.hoststack.session_rules import SessionRuleEngine


class PolicyDenied(ConnectionRefusedError):
    """Raised when a session rule denies the connection."""


def _ip_int(addr: str) -> int:
    return struct.unpack("!I", socket.inet_aton(addr))[0]


class FilteredSocket:
    """A TCP/UDP socket whose session-layer operations are filtered.

    Wraps a real OS socket (tests exercise actual connections over
    loopback); the filtering decision is the part that mirrors VPP —
    where VPP consults its session rule tables inside the host stack,
    we consult the SessionRuleEngine at the same call sites.
    """

    def __init__(self, app: "HostStackApp", proto: int = 6,
                 sock: Optional[socket.socket] = None):
        self.app = app
        self.proto = proto
        kind = socket.SOCK_STREAM if proto == 6 else socket.SOCK_DGRAM
        self.sock = sock or socket.socket(socket.AF_INET, kind)

    # --- session-layer entry points ---
    def connect(self, address: Tuple[str, int]) -> None:
        rmt_ip, rmt_port = address
        lcl_ip, lcl_port = self._local()
        allowed = self.app.engine.check_connect([
            (self.app.appns_index, self.proto, _ip_int(lcl_ip), lcl_port,
             _ip_int(rmt_ip), rmt_port)
        ])[0]
        if not allowed:
            raise PolicyDenied(
                f"session rule denies connect to {rmt_ip}:{rmt_port} "
                f"(ns {self.app.appns_index})"
            )
        self.sock.connect(address)

    def bind(self, address: Tuple[str, int]) -> None:
        self.sock.bind(address)

    def listen(self, backlog: int = 16) -> None:
        self.sock.listen(backlog)

    def accept_batch(self, max_n: int = 64,
                     first_timeout: float = 0.01) -> list:
        """Admission-check a wave of pending inbound connections in ONE
        engine batch — the server-side twin of
        ``HostStackApp.connect_batch``. Waits up to ``first_timeout``
        for the FIRST connection, then drains whatever else is already
        queued non-blocking (a wave must never stall waiting for a
        member that isn't coming). Denied peers are closed; returns
        [(FilteredSocket, peer), ...] for the admitted ones."""
        prev_timeout = self.sock.gettimeout()
        wave = []
        try:
            # a closed/dead listener raises OSError out of here — the
            # caller must be able to tell that from "no connections
            # pending" or its accept loop busy-spins forever
            self.sock.settimeout(first_timeout)
            try:
                wave.append(self.sock.accept())
            except TimeoutError:
                return []
            self.sock.setblocking(False)
            while len(wave) < max_n:
                try:
                    wave.append(self.sock.accept())
                except BlockingIOError:
                    break
                except ConnectionAbortedError:
                    # a QUEUED pending connection RST before we got to
                    # it (health checks, impatient clients) — routine,
                    # affects only that connection: keep draining
                    continue
                except OSError:
                    # genuine listener failure mid-drain (closed,
                    # shutdown): the sockets already accepted into the
                    # wave would leak un-admission-checked if this
                    # propagated — close them before re-raising
                    for conn, _peer in wave:
                        try:
                            conn.close()
                        except OSError:
                            pass
                    raise
        finally:
            try:
                self.sock.settimeout(prev_timeout)
            except OSError:
                pass  # listener closed mid-wave (shutdown path)
        # per-connection local address, same as accept(): a wildcard
        # bind resolves to the real local IP on the accepted socket,
        # and rules match against THAT
        verdicts = self.app.engine.check_accept([
            (self.proto, _ip_int(conn.getsockname()[0]),
             conn.getsockname()[1], _ip_int(peer[0]), peer[1])
            for conn, peer in wave
        ])
        out = []
        for ok, (conn, peer) in zip(verdicts, wave):
            if ok:
                out.append((FilteredSocket(self.app, self.proto, conn),
                            peer))
            else:
                conn.close()
        return out

    def accept(self) -> Tuple["FilteredSocket", Tuple[str, int]]:
        """Accept the next ALLOWED connection; denied peers are closed
        (the VPP session layer resets filtered sessions) and the accept
        keeps waiting."""
        while True:
            conn, peer = self.sock.accept()
            lcl_ip, lcl_port = conn.getsockname()[:2]
            allowed = self.app.engine.check_accept([
                (self.proto, _ip_int(lcl_ip), lcl_port,
                 _ip_int(peer[0]), peer[1])
            ])[0]
            if allowed:
                return FilteredSocket(self.app, self.proto, conn), peer
            conn.close()

    # --- passthrough ---
    def _local(self) -> Tuple[str, int]:
        try:
            name = self.sock.getsockname()
            return name[0], name[1]
        except OSError:
            return ("0.0.0.0", 0)

    def getsockname(self):
        return self.sock.getsockname()

    def send(self, data: bytes) -> int:
        return self.sock.send(data)

    def sendall(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv(self, n: int) -> bytes:
        return self.sock.recv(n)

    def settimeout(self, t) -> None:
        self.sock.settimeout(t)

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HostStackApp:
    """One application namespace on the accelerated host stack.

    The reference derives the app namespace from the pod (contiv.API
    GetNsIndex); here the CNI layer supplies the same index (the pod's
    dataplane interface index, ContivAgent._pod_ns_index).
    """

    def __init__(self, engine: SessionRuleEngine, appns_index: int):
        self.engine = engine
        self.appns_index = appns_index

    def socket(self, proto: int = 6) -> FilteredSocket:
        return FilteredSocket(self, proto)

    def connect_batch(self, addresses, proto: int = 6) -> list:
        """Admission-check a wave of outbound connects in ONE engine
        batch — the device-batched form of N parallel ``connect()`` calls
        (one device round trip for the whole wave instead of one per
        connection; the reference's wrk harness opens 50 connections at
        a time, tests/policy/perf/RPS.sh).

        Returns a list parallel to ``addresses``: a connected
        FilteredSocket where allowed, None where policy denied. An
        OS-level connect failure is NOT a policy verdict: it closes the
        whole wave and re-raises, mirroring the single-connect path's
        PolicyDenied-vs-OSError separation."""
        socks = [FilteredSocket(self, proto) for _ in addresses]
        conns = []
        for s, (ip, port) in zip(socks, addresses):
            lcl_ip, lcl_port = s._local()
            conns.append((self.appns_index, proto, _ip_int(lcl_ip),
                          lcl_port, _ip_int(ip), port))
        allowed = self.engine.check_connect(conns)
        out = []
        try:
            for ok, s, addr in zip(allowed, socks, addresses):
                if ok:
                    s.sock.connect(addr)
                    out.append(s)
                else:
                    s.close()
                    out.append(None)
        except OSError:
            for s in out:
                if s is not None:
                    s.close()
            for s in socks[len(out):]:
                s.close()
            raise
        return out
