"""Unix-socket JSON-line RPC between the CNI shim and the agent.

Reference analog: the gRPC channel between cmd/contiv-cni and the
agent's remoteCNIserver (contiv_cni.go:34-104, port 9111). One request
per connection — the shim is a short-lived exec'd binary, so connection
reuse buys nothing; a newline-delimited JSON request/reply keeps the
shim dependency-free.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
from typing import Callable, Optional

Dispatch = Callable[[str, dict], dict]


class CNITransportServer:
    """Threaded unix-socket server delegating to a dispatch callable."""

    def __init__(self, socket_path: str, dispatch: Dispatch):
        self.socket_path = socket_path
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                    reply = outer.dispatch(msg.get("method", ""), msg.get("params", {}))
                except Exception as e:
                    reply = {"result": 1, "error": f"bad request: {e}"}
                self.wfile.write(json.dumps(reply).encode() + b"\n")

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        self.dispatch = dispatch
        # SO_REUSEADDR is a no-op for AF_UNIX: a stale socket file from an
        # unclean exit would make bind() fail forever. Unlink it first.
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass
        self._server = Server(socket_path, Handler)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="cni-transport"
        )
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def cni_call(socket_path: str, method: str, params: dict, timeout: float = 30.0) -> dict:
    """Client side: one request, one JSON-line reply."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall(json.dumps({"method": method, "params": params}).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    try:
        return json.loads(buf)
    except ValueError as e:
        # Connection dropped mid-reply: surface as the transport error it
        # is, so the shim's OSError path emits a retryable CNI error.
        raise ConnectionError(f"incomplete reply from agent: {e}") from e
