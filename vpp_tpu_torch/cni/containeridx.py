"""ContainerIndex: in-memory + store-persisted index of configured pods.

Reference analog: plugins/contiv/containeridx (ConfigIndex backed by a
proto model, persisted under the agent's ETCD prefix so a restarted
agent can resync every pod it had wired — containeridx/persist.go).

Lookup axes follow the reference: by container ID (primary), by pod
(namespace, name), and by dataplane interface index (the statscollector
needs ifindex→pod for metric labels).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from vpp_tpu_torch.kvstore.store import Broker

PERSIST_PREFIX = "contiv/containers/"


@dataclasses.dataclass(frozen=True)
class ContainerConfig:
    container_id: str
    pod_name: str
    pod_namespace: str
    if_index: int          # dataplane interface slot
    if_name: str           # interface name inside the sandbox ("eth0")
    ip: str                # pod IP (no prefix)
    netns: str = ""

    @property
    def pod_id(self) -> Tuple[str, str]:
        return (self.pod_namespace, self.pod_name)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ContainerConfig":
        return cls(**d)


class ContainerIndex:
    def __init__(self, broker: Optional[Broker] = None):
        self._broker = broker
        self._by_id: Dict[str, ContainerConfig] = {}
        self._by_pod: Dict[Tuple[str, str], str] = {}
        self._by_if: Dict[int, str] = {}
        self._lock = threading.RLock()

    def register(self, cfg: ContainerConfig) -> None:
        with self._lock:
            self._by_id[cfg.container_id] = cfg
            self._by_pod[cfg.pod_id] = cfg.container_id
            self._by_if[cfg.if_index] = cfg.container_id
            if self._broker is not None:
                self._broker.put(PERSIST_PREFIX + cfg.container_id, cfg.to_dict())

    def unregister(self, container_id: str) -> Optional[ContainerConfig]:
        with self._lock:
            cfg = self._by_id.pop(container_id, None)
            if cfg is None:
                return None
            self._by_pod.pop(cfg.pod_id, None)
            self._by_if.pop(cfg.if_index, None)
            if self._broker is not None:
                self._broker.delete(PERSIST_PREFIX + container_id)
            return cfg

    def lookup(self, container_id: str) -> Optional[ContainerConfig]:
        with self._lock:
            return self._by_id.get(container_id)

    def lookup_pod(self, namespace: str, name: str) -> Optional[ContainerConfig]:
        with self._lock:
            cid = self._by_pod.get((namespace, name))
            return self._by_id.get(cid) if cid else None

    def lookup_if(self, if_index: int) -> Optional[ContainerConfig]:
        with self._lock:
            cid = self._by_if.get(if_index)
            return self._by_id.get(cid) if cid else None

    def all(self) -> List[ContainerConfig]:
        with self._lock:
            return list(self._by_id.values())

    def load_persisted(self) -> List[ContainerConfig]:
        """Rebuild the in-memory index from the store (restart resync)."""
        if self._broker is None:
            return []
        loaded = []
        for _key, val in self._broker.list_values(PERSIST_PREFIX).items():
            cfg = ContainerConfig.from_dict(val)
            with self._lock:
                self._by_id[cfg.container_id] = cfg
                self._by_pod[cfg.pod_id] = cfg.container_id
                self._by_if[cfg.if_index] = cfg.container_id
            loaded.append(cfg)
        return loaded
