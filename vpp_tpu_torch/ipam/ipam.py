"""Node-local IPAM: node-ID ⊕ subnet arithmetic, no central allocator.

Every node derives its own address blocks purely from its cluster-unique
node ID and the shared IPAM config — pod network, VPP↔host interconnect
network, node interconnect IP, VXLAN IP — so cluster-wide IPAM is fully
distributed (SURVEY.md §2.4 "Cluster-wide address sharding").

Scheme (reference: plugins/contiv/ipam/doc.go:1-21, ipam.go):
  pod_subnet (e.g. 10.1.0.0/16) + node_id -> per-node pod network
  (10.1.<id>.0/24); pod IPs allocated from .2 upward (.1 = gateway);
  host interconnect subnet likewise; node/VXLAN interconnect IP =
  CIDR base + node_id (truncated to the free host bits).

Allocation state (pod-IP ↔ pod-ID map) is persisted through a kvstore
broker so an agent restart reconstructs assignments (ipam/persist.go).
"""

from __future__ import annotations

import ipaddress
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from vpp_tpu_torch.kvstore.store import Broker

# seq index 1 within a pod network is the gateway, never assigned to pods
_GATEWAY_SEQ = 1

_PERSIST_PREFIX = "ipam/"


@dataclass
class IpamConfig:
    """Shared cluster IPAM configuration (reference: ipam.go Config +
    defaults from k8s/contiv-vpp.yaml ConfigMap)."""

    pod_subnet_cidr: str = "10.1.0.0/16"
    pod_network_prefix_len: int = 24
    pod_if_ip_cidr: str = "10.2.1.0/24"
    vpp_host_subnet_cidr: str = "172.30.0.0/16"
    vpp_host_network_prefix_len: int = 24
    node_interconnect_cidr: str = "192.168.16.0/24"
    node_interconnect_dhcp: bool = False
    vxlan_cidr: str = "192.168.30.0/24"
    service_cidr: str = "10.96.0.0/12"


def _apply_node_id(
    subnet: ipaddress.IPv4Network, node_id: int, network_prefix_len: int
) -> ipaddress.IPv4Network:
    """Carve the per-node /network_prefix_len block out of the subnet by
    placing the node ID into the intermediate bits.

    Unlike the reference (which silently truncates the ID,
    ipam.go convertToNodeIPPart), an ID that does not fit the available
    node bits is an error — truncation would give two nodes overlapping
    pod networks with no warning.
    """
    node_bits = network_prefix_len - subnet.prefixlen
    if node_bits < 0:
        raise ValueError(
            f"network prefix /{network_prefix_len} is wider than subnet {subnet}"
        )
    if node_bits < 32 and node_id >= (1 << node_bits):
        raise ValueError(
            f"node ID {node_id} does not fit the {node_bits} node bits of "
            f"{subnet} with per-node /{network_prefix_len} networks"
        )
    base = int(subnet.network_address) + (node_id << (32 - network_prefix_len))
    return ipaddress.ip_network((base, network_prefix_len))


def _host_ip_in(cidr: ipaddress.IPv4Network, node_id: int) -> ipaddress.IPv4Address:
    """CIDR base + node_id. Raises if the ID does not fit the host bits
    (same no-silent-collision stance as _apply_node_id) or would be the
    broadcast address."""
    host_bits = 32 - cidr.prefixlen
    if node_id >= (1 << host_bits) - 1:
        raise ValueError(
            f"node ID {node_id} does not fit as a host address in {cidr}"
        )
    return ipaddress.ip_address(int(cidr.network_address) + node_id)


class IPAM:
    """See module docstring. Thread-safe."""

    def __init__(
        self,
        node_id: int,
        config: Optional[IpamConfig] = None,
        broker: Optional[Broker] = None,
    ):
        if not 0 < node_id < 256:
            raise ValueError(f"node_id must be in 1..255, got {node_id}")
        self._lock = threading.RLock()
        self.node_id = node_id
        self.config = config or IpamConfig()
        self.broker = broker
        c = self.config

        self.pod_subnet = ipaddress.ip_network(c.pod_subnet_cidr)
        self.pod_network = _apply_node_id(
            self.pod_subnet, node_id, c.pod_network_prefix_len
        )
        self.pod_if_ip_cidr = ipaddress.ip_network(c.pod_if_ip_cidr)
        self.vpp_host_subnet = ipaddress.ip_network(c.vpp_host_subnet_cidr)
        self.vpp_host_network = _apply_node_id(
            self.vpp_host_subnet, node_id, c.vpp_host_network_prefix_len
        )
        self.node_interconnect_cidr = ipaddress.ip_network(c.node_interconnect_cidr)
        self.vxlan_cidr = ipaddress.ip_network(c.vxlan_cidr)
        self.service_network = ipaddress.ip_network(c.service_cidr)

        # assigned pod IPs: uint32 -> pod id string
        self._assigned: Dict[int, str] = {}
        self._last_assigned = 1
        if broker is not None:
            self._load_assigned()

    # --- derived addresses ---
    def pod_gateway_ip(self) -> ipaddress.IPv4Address:
        """.1 of the node's pod network (default GW for pods)."""
        return ipaddress.ip_address(int(self.pod_network.network_address) + _GATEWAY_SEQ)

    def veth_vpp_end_ip(self) -> ipaddress.IPv4Address:
        """VPP-side address of the VPP↔host interconnect (x.y.z.1)."""
        return ipaddress.ip_address(int(self.vpp_host_network.network_address) + 1)

    def veth_host_end_ip(self) -> ipaddress.IPv4Address:
        """Host-side address of the VPP↔host interconnect (x.y.z.2)."""
        return ipaddress.ip_address(int(self.vpp_host_network.network_address) + 2)

    def node_ip_address(self, node_id: Optional[int] = None) -> ipaddress.IPv4Address:
        return _host_ip_in(self.node_interconnect_cidr, node_id or self.node_id)

    def node_ip_with_prefix(self, node_id: Optional[int] = None) -> ipaddress.IPv4Interface:
        return ipaddress.ip_interface(
            f"{self.node_ip_address(node_id)}/{self.node_interconnect_cidr.prefixlen}"
        )

    def vxlan_ip_address(self, node_id: Optional[int] = None) -> ipaddress.IPv4Address:
        return _host_ip_in(self.vxlan_cidr, node_id or self.node_id)

    def other_node_pod_network(self, node_id: int) -> ipaddress.IPv4Network:
        return _apply_node_id(
            self.pod_subnet, node_id, self.config.pod_network_prefix_len
        )

    def other_node_vpp_host_network(self, node_id: int) -> ipaddress.IPv4Network:
        return _apply_node_id(
            self.vpp_host_subnet, node_id, self.config.vpp_host_network_prefix_len
        )

    # --- pod IP allocation ---
    def next_pod_ip(self, pod_id: str) -> ipaddress.IPv4Address:
        """Allocate the next free pod IP, persisting the assignment.

        Scans from just past the last assignment (wrapping), skipping the
        gateway — same rotation as the reference (ipam.go:261-298) so
        recently released addresses are not immediately reused.
        """
        if not pod_id:
            raise ValueError("pod ID must be non-empty (used to release the IP)")
        with self._lock:
            base = int(self.pod_network.network_address)
            # seq 0 = network address, last = broadcast: never assigned.
            max_seq = self.pod_network.num_addresses - 1
            order = list(range(self._last_assigned + 1, max_seq)) + list(
                range(1, self._last_assigned + 1)
            )
            for seq in order:
                if seq == _GATEWAY_SEQ:
                    continue
                ip = base + seq
                if ip in self._assigned:
                    continue
                self._assigned[ip] = pod_id
                self._last_assigned = seq
                self._save_assigned(ip, pod_id)
                return ipaddress.ip_address(ip)
            raise RuntimeError(
                f"no free pod IP in {self.pod_network} (all assigned)"
            )

    def release_pod_ip(self, pod_id: str) -> bool:
        """Release the IP assigned to the pod; True if one was found."""
        if not pod_id:
            return False
        with self._lock:
            for ip, pid in list(self._assigned.items()):
                if pid == pod_id:
                    del self._assigned[ip]
                    if self.broker is not None:
                        self.broker.delete(_PERSIST_PREFIX + pod_id)
                    return True
            return False

    def get_pod_ip(self, pod_id: str) -> Optional[ipaddress.IPv4Address]:
        with self._lock:
            for ip, pid in self._assigned.items():
                if pid == pod_id:
                    return ipaddress.ip_address(ip)
            return None

    def assigned_count(self) -> int:
        with self._lock:
            return len(self._assigned)

    # --- persistence (reference: ipam/persist.go) ---
    def _save_assigned(self, ip: int, pod_id: str) -> None:
        if self.broker is not None:
            self.broker.put(_PERSIST_PREFIX + pod_id, {"ip": ip, "pod": pod_id})

    def _load_assigned(self) -> None:
        base = int(self.pod_network.network_address)
        max_seq = self.pod_network.num_addresses - 1
        for key, item in self.broker.list_values(_PERSIST_PREFIX).items():
            ip = int(item["ip"])
            seq = ip - base
            if not 0 < seq < max_seq:
                # Persisted entry from a different pod network (e.g. the
                # node came back with a new ID): stale — drop it rather
                # than poisoning the allocator bounds.
                self.broker.delete(key)
                continue
            self._assigned[ip] = item["pod"]
            if seq > self._last_assigned:
                self._last_assigned = seq
