"""ContivService: the processor→configurator service representation.

Reference: plugins/service/configurator/configurator_api.go (ContivService
with ports, backends, external IPs, traffic policy).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


class TrafficPolicy(enum.IntEnum):
    CLUSTER = 0   # any backend in the cluster
    LOCAL = 1     # only backends on the receiving node


@dataclass(frozen=True)
class Backend:
    ip: str
    port: int
    local: bool = False    # runs on this node (gets 2x LB weight)


@dataclass(frozen=True)
class ServicePortSpec:
    protocol: str          # "TCP" | "UDP"
    port: int              # service (VIP) port
    node_port: int = 0     # 0 = none


@dataclass
class ContivService:
    id: Tuple[str, str]    # (namespace, name)
    traffic_policy: TrafficPolicy = TrafficPolicy.CLUSTER
    cluster_ip: str = ""
    external_ips: List[str] = field(default_factory=list)
    # port name -> spec ; backends keyed by the same port name
    ports: Dict[str, ServicePortSpec] = field(default_factory=dict)
    backends: Dict[str, List[Backend]] = field(default_factory=dict)

    def has_nodeport(self) -> bool:
        return any(p.node_port for p in self.ports.values())
