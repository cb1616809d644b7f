"""STN ("Steal The NIC") daemon: hand a host NIC to the dataplane, give
it back on crash.

Reference analog: cmd/contiv-stn — a host daemon outside the agent's
blast radius. Steal: record the kernel NIC's IPs/routes, unbind it from
the kernel driver so the dataplane can claim it (main.go:209-323,
pci.go:30-76). Release: rebind + restore. Watchdog: poll the agent's
health endpoint; after `grace_failures` consecutive misses, revert every
stolen NIC so the node keeps network connectivity even with the agent
dead (main.go:44-47, 486-537). State is persisted so a restarted daemon
still knows what it stole.

The OS layer is abstracted behind ``NetlinkBackend`` (netlink + sysfs
driver bind in production, ``FakeNetlink`` in tests) — the daemon logic,
persistence and watchdog are fully testable without root.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("vpp_tpu_torch.stn")


@dataclasses.dataclass(frozen=True)
class StolenInterface:
    name: str
    pci_addr: str
    driver: str             # original kernel driver, for rebind
    ip_addresses: List[str]  # CIDR strings
    routes: List[dict]       # {dst, gw}
    stolen_at: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StolenInterface":
        return cls(**d)


class NetlinkBackend:
    """OS interface the daemon drives; production impl shells netlink +
    /sys/bus/pci driver bind/unbind (reference pci.go:30-76)."""

    def interface_info(self, name: str) -> StolenInterface:
        raise NotImplementedError

    def unbind(self, iface: StolenInterface) -> None:
        raise NotImplementedError

    def rebind(self, iface: StolenInterface) -> None:
        raise NotImplementedError

    def restore_config(self, iface: StolenInterface) -> None:
        raise NotImplementedError


class FakeNetlink(NetlinkBackend):
    """In-memory host network state for tests."""

    def __init__(self, interfaces: Optional[Dict[str, dict]] = None):
        # name -> {pci, driver, ips: [..], routes: [..], bound: True}
        self.state = interfaces or {}
        self.calls: List[str] = []

    def add_interface(self, name: str, pci: str = "0000:00:08.0",
                      driver: str = "mlx5_core",
                      ips: Optional[List[str]] = None,
                      routes: Optional[List[dict]] = None) -> None:
        self.state[name] = {
            "pci": pci, "driver": driver, "ips": ips or [],
            "routes": routes or [], "bound": True,
        }

    def interface_info(self, name: str) -> StolenInterface:
        s = self.state[name]
        return StolenInterface(
            name=name, pci_addr=s["pci"], driver=s["driver"],
            ip_addresses=list(s["ips"]), routes=list(s["routes"]),
        )

    def unbind(self, iface: StolenInterface) -> None:
        self.calls.append(f"unbind:{iface.name}")
        s = self.state[iface.name]
        s["bound"] = False
        s["ips"], s["routes"] = [], []

    def rebind(self, iface: StolenInterface) -> None:
        self.calls.append(f"rebind:{iface.name}")
        self.state[iface.name]["bound"] = True

    def restore_config(self, iface: StolenInterface) -> None:
        self.calls.append(f"restore:{iface.name}")
        s = self.state[iface.name]
        s["ips"] = list(iface.ip_addresses)
        s["routes"] = list(iface.routes)


class STNDaemon:
    def __init__(
        self,
        backend: NetlinkBackend,
        persist_path: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.backend = backend
        self.persist_path = persist_path
        self._clock = clock
        self._stolen: Dict[str, StolenInterface] = {}
        self._lock = threading.RLock()
        self._load()

    # --- gRPC API surface (Steal / Release / StolenInterfaceInfo) ---
    def steal(self, name: str) -> StolenInterface:
        with self._lock:
            if name in self._stolen:
                return self._stolen[name]  # idempotent
            info = self.backend.interface_info(name)
            info = dataclasses.replace(info, stolen_at=self._clock())
            self.backend.unbind(info)
            self._stolen[name] = info
            self._persist()
            return info

    def release(self, name: str) -> bool:
        with self._lock:
            info = self._stolen.get(name)
            if info is None:
                return False
            # backend first, bookkeeping after: a rebind failure must
            # leave the NIC tracked so release/revert can be retried
            self.backend.rebind(info)
            self.backend.restore_config(info)
            del self._stolen[name]
            self._persist()
            return True

    def stolen_interface_info(self, name: str) -> Optional[StolenInterface]:
        with self._lock:
            return self._stolen.get(name)

    def revert_all(self) -> int:
        """Give every stolen NIC back to the kernel (watchdog / shutdown).
        One NIC failing to rebind must not stop the others; failed NICs
        stay tracked for retry."""
        with self._lock:
            names = list(self._stolen)
        n = 0
        for name in names:
            try:
                if self.release(name):
                    n += 1
            except Exception:
                log.exception("revert of %s failed; will retry", name)
        return n

    # --- persistence (daemon restart survival) ---
    def _persist(self) -> None:
        if not self.persist_path:
            return
        data = {k: v.to_dict() for k, v in self._stolen.items()}
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.persist_path)

    def _load(self) -> None:
        if not self.persist_path or not os.path.exists(self.persist_path):
            return
        with open(self.persist_path) as f:
            data = json.load(f)
        self._stolen = {
            k: StolenInterface.from_dict(v) for k, v in data.items()
        }


class Watchdog:
    """Reverts stolen NICs when the agent health probe stays dead.

    Reference: contiv-stn's check loop (main.go:486-537) — poll the
    agent's health port every `interval`; after `grace_failures`
    consecutive failures revert all NICs; keep polling so a recovered
    agent can steal again. Driven by tick() for testability; run() wraps
    it in a thread with real sleep.
    """

    def __init__(
        self,
        daemon: STNDaemon,
        probe: Callable[[], bool],
        grace_failures: int = 3,
        interval: float = 1.0,
    ):
        self.daemon = daemon
        self.probe = probe
        self.grace_failures = grace_failures
        self.interval = interval
        self.failures = 0
        self.reverted = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> None:
        try:
            ok = bool(self.probe())
        except Exception:
            ok = False
        if ok:
            self.failures = 0
            self.reverted = False
            return
        self.failures += 1
        if self.failures >= self.grace_failures and not self.reverted:
            try:
                remaining = len(self.daemon._stolen)
                reverted = self.daemon.revert_all()
            except Exception:
                log.exception("revert_all failed; retrying next tick")
                return
            # only disarm once every NIC actually went back; partial
            # failure retries on the next tick
            if reverted >= remaining:
                self.reverted = True

    def run(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="stn-watchdog"
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
