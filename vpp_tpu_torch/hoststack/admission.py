"""VCL admission socket: the session-layer policy endpoint for the
LD_PRELOAD shim.

Reference analog: VPP's VCL connects an app worker to the session layer
over the VCL app socket, and every session create/accept inside VPP is
filtered by the session rule tables the VPPTCP renderer programs
(plugins/policy/renderer/vpptcp/bin_api/session, tests/ld_preload*).
Here the unmodified-app path is reproduced natively: libvclshim.so
(native/vcl_preload.c) interposes connect()/accept() and asks THIS
server for a verdict before the call proceeds; the server answers from
the node's SessionRuleEngine — the same engine, and therefore the same
device-resident rule tables, the VPPTCP renderer commits to.

Wire protocol (one unix stream per client THREAD, requests pipelined
sequentially, all fields little-endian):

    request  (20 B): u8 op ('C' connect | 'A' accept), u8 proto,
                     u16 pad, u32 appns, u32 lcl_ip, u32 rmt_ip,
                     u16 lcl_port, u16 rmt_port
    response  (1 B): 1 allow, 0 deny

IPs are host-order u32s of the network-byte-order address (ntohl on the
C side), matching vcl.py's ``_ip_int``.

The reference's ``vpp_tpu/hoststack/admission.py``: the wire protocol,
the counters' names and the deny-on-engine-error rule are its own; the
engine is the port's (tensor ops on the agent dataplane's device).
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
from typing import Optional

from vpp_tpu_torch.hoststack.session_rules import SessionRuleEngine

log = logging.getLogger("vpp-tpu.vcl")

_REQ = struct.Struct("<BBHIIIHH")
REQ_SIZE = _REQ.size
OP_CONNECT = ord("C")
OP_ACCEPT = ord("A")


class VclAdmissionServer:
    """Threaded unix-socket server answering shim admission queries."""

    def __init__(self, engine: SessionRuleEngine, path: str):
        self.engine = engine
        self.path = path
        self._sock: Optional[socket.socket] = None
        self._threads: list = []
        self._stop = threading.Event()
        # admission counters (Prometheus via StatsCollector.set_vcl);
        # plain int updates under one lock — verdicts are sequential
        # per client but clients are concurrent
        self._stats_lock = threading.Lock()
        self.stats = {"connect_checks": 0, "connect_denies": 0,
                      "accept_checks": 0, "accept_denies": 0,
                      "clients": 0}
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def start(self) -> "VclAdmissionServer":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(64)
        t = threading.Thread(target=self._accept_loop,
                             name="vcl-admission", daemon=True)
        t.start()
        self._threads.append(t)
        # Warm the engine's check in the background: the first filter
        # on the card pays CUDA context and kernel-load costs that
        # would outlast the shim's bounded round trip and fail-open a
        # policy-bypass window exactly when the agent boots with deny
        # rules already installed.
        threading.Thread(target=self._warm, name="vcl-warm",
                         daemon=True).start()
        log.info("VCL admission socket at %s", self.path)
        return self

    def _warm(self) -> None:
        try:
            self.engine.check_connect([(0, 6, 0, 0, 0, 0)])
            self.engine.check_accept([(6, 0, 0, 0, 0)])
        except Exception:  # noqa: BLE001 — warmup is best-effort
            log.warning("admission warmup failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # close LIVE client channels too: _serve threads block in
        # recv() between requests, so a stopped server would otherwise
        # keep answering stale verdicts and the shims would never
        # re-dial a restarted agent
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # --- internals ---
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            # per-connection threads are daemons and never joined — do
            # not retain them (a churning node would grow the list for
            # the agent's lifetime)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        # live connection count (one per app thread in steady state;
        # the shim reconnects after agent hiccups, so cumulative counts
        # would inflate)
        with self._conns_lock:
            self._conns.add(conn)
        with self._stats_lock:
            self.stats["clients"] += 1
        try:
            self._serve_inner(conn)
        finally:
            with self._stats_lock:
                self.stats["clients"] -= 1
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_inner(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                buf = b""
                while len(buf) < REQ_SIZE:
                    chunk = conn.recv(REQ_SIZE - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                op, proto, _pad, appns, lcl_ip, rmt_ip, lcl_port, \
                    rmt_port = _REQ.unpack(buf)
                # an engine exception (a device error, a table
                # mid-swap bug) must answer DENY, not tear down the
                # connection: with the shim's default fail-open config
                # a killed serve loop turns every later verdict on that
                # app into an allow — an agent-side bug becoming a
                # policy bypass. Deny keeps the failure visible in the
                # deny counters while the loop keeps serving.
                try:
                    if op == OP_CONNECT:
                        ok = bool(self.engine.check_connect(
                            [(appns, proto, lcl_ip, lcl_port,
                              rmt_ip, rmt_port)])[0])
                        with self._stats_lock:
                            self.stats["connect_checks"] += 1
                            self.stats["connect_denies"] += int(not ok)
                    elif op == OP_ACCEPT:
                        ok = bool(self.engine.check_accept(
                            [(proto, lcl_ip, lcl_port, rmt_ip,
                              rmt_port)])[0])
                        with self._stats_lock:
                            self.stats["accept_checks"] += 1
                            self.stats["accept_denies"] += int(not ok)
                    else:
                        log.warning("unknown admission op %#x", op)
                        ok = False
                except Exception:  # incl. OSError: no socket ops in
                    #                this block, so it's engine-raised
                    log.exception("admission engine error — denying")
                    with self._stats_lock:
                        side = ("connect" if op == OP_CONNECT
                                else "accept")
                        # count the check too: deny rates computed as
                        # denies/checks must stay <= 1 under faults
                        self.stats[f"{side}_checks"] += 1
                        self.stats[f"{side}_denies"] += 1
                    ok = False
                conn.sendall(b"\x01" if ok else b"\x00")
        except OSError:
            pass  # client went away
        finally:
            try:
                conn.close()
            except OSError:
                pass
