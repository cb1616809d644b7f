"""StatusCheck: per-plugin liveness registry + probe endpoints.

Reference analog: cn-infra statuscheck — every plugin registers, reports
OK/ERROR transitions, and the agent's overall state is the worst plugin
state; exposed over HTTP for k8s liveness probes and consumed in-process
(e.g. KSR pauses reflection while ETCD is down; the STN watchdog reverts
NICs when the agent goes dark).
"""

from __future__ import annotations

import enum
import http.server
import json
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple


class PluginState(enum.IntEnum):
    INIT = 0
    OK = 1
    ERROR = 2

    # worst-of aggregation: ERROR > INIT > OK
    @property
    def severity(self) -> int:
        return {PluginState.OK: 0, PluginState.INIT: 1, PluginState.ERROR: 2}[self]


class StatusCheck:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._plugins: Dict[str, Tuple[PluginState, str, float]] = {}
        self._probes: Dict[str, Callable[[], bool]] = {}
        self._watchers: List[Callable[[str, PluginState], None]] = []

    # --- registration / reporting ---
    def register(self, plugin: str) -> Callable[[PluginState, str], None]:
        """Register a plugin (state INIT); returns its report function."""
        with self._lock:
            self._plugins[plugin] = (PluginState.INIT, "", self._clock())
        return lambda state, error="": self.report(plugin, state, error)

    def register_probe(self, plugin: str, probe: Callable[[], bool]) -> None:
        """A pull-style probe: polled by run_probes(); False → ERROR."""
        with self._lock:
            self._probes[plugin] = probe
            self._plugins.setdefault(
                plugin, (PluginState.INIT, "", self._clock())
            )

    def report(self, plugin: str, state: PluginState, error: str = "") -> None:
        with self._lock:
            if plugin not in self._plugins:
                raise KeyError(f"plugin {plugin!r} not registered")
            old = self._plugins[plugin][0]
            self._plugins[plugin] = (state, error, self._clock())
            watchers = list(self._watchers) if old != state else []
        for w in watchers:
            w(plugin, state)

    def watch_state(self, cb: Callable[[str, PluginState], None]) -> None:
        with self._lock:
            self._watchers.append(cb)

    def run_probes(self) -> None:
        with self._lock:
            probes = dict(self._probes)
        for plugin, probe in probes.items():
            try:
                ok = bool(probe())
            except Exception as e:
                self.report(plugin, PluginState.ERROR, f"probe raised: {e}")
                continue
            self.report(
                plugin,
                PluginState.OK if ok else PluginState.ERROR,
                "" if ok else "probe failed",
            )

    # --- aggregation ---
    def plugin_status(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                name: {
                    "state": state.name,
                    "error": error,
                    "last_change": ts,
                }
                for name, (state, error, ts) in self._plugins.items()
            }

    def agent_state(self) -> PluginState:
        with self._lock:
            states = [s for s, _, _ in self._plugins.values()]
        if not states:
            return PluginState.INIT
        return max(states, key=lambda s: s.severity)

    def liveness(self) -> dict:
        state = self.agent_state()
        return {
            "state": state.name,
            "alive": state != PluginState.ERROR,
            "ready": state == PluginState.OK,
            "plugins": self.plugin_status(),
        }


class HealthHTTPServer:
    """Serves /liveness and /readiness JSON (k8s probe endpoints)."""

    def __init__(self, statuscheck: StatusCheck, port: int = 9191,
                 host: str = "127.0.0.1"):
        outer = self
        self.statuscheck = statuscheck

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                live = outer.statuscheck.liveness()
                path = urllib.parse.urlsplit(self.path).path
                if path == "/liveness":
                    ok = live["alive"]
                elif path == "/readiness":
                    ok = live["ready"]
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = json.dumps(live).encode()
                self.send_response(200 if ok else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="health-http"
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
