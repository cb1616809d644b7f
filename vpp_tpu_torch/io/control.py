"""IO-daemon control channel: runtime attach/detach of packet endpoints.

The port's copy of ``vpp_tpu/io/control.py``, on the same wire format:
either package's client drives either package's daemon. A daemon whose
transport set were fixed at process start could never carry a pod added
at runtime; this unix-socket JSON-line RPC lets the agent drive the
daemon the way the reference's CNI server drives VPP interface creation over the
binary API (plugins/contiv/remote_cni_server.go:895-1250):

  attach   {if_idx, kind, arg}   create a transport (afpacket|tap|fd)
                                 and plug it in as interface if_idx
  detach   {if_idx}              unplug + close the transport
  set_mac  {ip, mac}             static (ip → MAC) entry — the analog of
                                 the reference's configured static ARPs
                                 (pod.go:375-452), replacing broadcast-
                                 flood fallback for known pods
  del_mac  {ip}                  unpin a static entry (interface gone):
                                 it becomes evictable like a learned one
  stats    {}                    daemon counters
  list     {}                    current interface table
  neighbors {}                   (ip → MAC) table dump (show ip arp)

One request per connection, newline-delimited JSON — same wire shape as
the CNI shim transport (cni/transport.py), so the protocol layer is
shared.
"""

from __future__ import annotations

import logging
from typing import Optional

from vpp_tpu_torch.cni.transport import CNITransportServer, cni_call

log = logging.getLogger("io_control")


class IOControlServer:
    """Control endpoint living inside the IO daemon process."""

    def __init__(self, daemon, socket_path: str):
        self.daemon = daemon
        self.socket_path = socket_path
        self._server = CNITransportServer(socket_path, self._dispatch)

    def start(self) -> "IOControlServer":
        self._server.start()
        return self

    def close(self) -> None:
        self._server.close()

    def _dispatch(self, method: str, params: dict) -> dict:
        try:
            if method == "attach":
                self.daemon.attach(
                    int(params["if_idx"]), params["kind"], params["arg"]
                )
                return {"result": 0}
            if method == "detach":
                removed = self.daemon.detach(int(params["if_idx"]))
                return {"result": 0, "removed": bool(removed)}
            if method == "set_mac":
                displaced = self.daemon.set_static_mac(
                    int(params["ip"]), bytes.fromhex(params["mac"])
                )
                # displaced=True: installed, but another pod's pinned
                # entry was evicted (it lost its no-flood guarantee) —
                # the agent decides whether to re-install that pod's ARP
                return {"result": 0, "displaced": bool(displaced)}
            if method == "del_mac":
                found = self.daemon.del_static_mac(int(params["ip"]))
                return {"result": 0, "found": bool(found)}
            if method == "stats":
                return {"result": 0, "stats": dict(self.daemon.stats)}
            if method == "neighbors":
                return {
                    "result": 0,
                    "neighbors": [
                        {"ip": ip, "mac": mac.hex(), "pin": pin}
                        for ip, mac, pin in self.daemon.mac.entries()
                    ],
                }
            if method == "list":
                return {
                    "result": 0,
                    "interfaces": {
                        str(idx): t.name
                        for idx, t in self.daemon.transports.items()
                    },
                }
            return {"result": 1, "error": f"unknown method {method!r}"}
        except Exception as e:  # noqa: BLE001 — fault isolation per request
            log.exception("control %s failed", method)
            return {"result": 1, "error": f"{type(e).__name__}: {e}"}


class IOControlClient:
    """Agent-side handle on a running IO daemon."""

    def __init__(self, socket_path: str, timeout: float = 10.0):
        self.socket_path = socket_path
        self.timeout = timeout

    def _call(self, method: str, params: Optional[dict] = None) -> dict:
        reply = cni_call(self.socket_path, method, params or {},
                         timeout=self.timeout)
        if reply.get("result") != 0:
            raise RuntimeError(
                f"io-daemon {method} failed: {reply.get('error')}"
            )
        return reply

    def attach(self, if_idx: int, kind: str, arg: str) -> None:
        self._call("attach", {"if_idx": if_idx, "kind": kind, "arg": arg})

    def detach(self, if_idx: int) -> bool:
        return bool(self._call("detach", {"if_idx": if_idx})["removed"])

    def set_mac(self, ip: int, mac: bytes) -> bool:
        """Install a static neighbor entry. True = installed but a
        DIFFERENT pod's pinned entry was displaced (pin pressure) —
        that pod lost its no-flood guarantee."""
        reply = self._call("set_mac", {"ip": ip, "mac": mac.hex()})
        return bool(reply.get("displaced"))

    def del_mac(self, ip: int) -> bool:
        """Unpin a static neighbor entry (interface unwired). True if
        an entry for ip existed."""
        return bool(self._call("del_mac", {"ip": ip})["found"])

    def stats(self) -> dict:
        return self._call("stats")["stats"]

    def neighbors(self) -> list:
        """The daemon's (ip → MAC) neighbor table: list of
        (ip, mac_bytes, pinned) — `show ip arp` analog data."""
        return [
            (int(e["ip"]), bytes.fromhex(e["mac"]), bool(e["pin"]))
            for e in self._call("neighbors")["neighbors"]
        ]

    def list_interfaces(self) -> dict:
        return {int(k): v
                for k, v in self._call("list")["interfaces"].items()}

    def ping(self) -> bool:
        try:
            self.stats()
            return True
        except (OSError, RuntimeError):
            return False
