"""ContivRule: the canonical 5-tuple policy rule with a total order.

This is the most basic policy rule definition that every renderer (and the
TPU data plane) must support, together with the total order used to keep
rule tables sorted most-specific-first.

Reference semantics: plugins/policy/renderer/api.go:65-136 (ContivRule,
Compare) and plugins/policy/utils/utils.go (CompareIPNets, ComparePorts).
Re-designed for Python: networks are ``ipaddress.IPv4Network`` /
``IPv6Network`` instances or ``None`` for "match all".
"""

from __future__ import annotations

import enum
import ipaddress
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Union

IPNetwork = Union[ipaddress.IPv4Network, ipaddress.IPv6Network]

# Port number 0 stands for "any port".
ANY_PORT = 0


class PodID(NamedTuple):
    """Identifier of a pod: (namespace, name).

    Reference: plugins/ksr/model/pod/keyer.go (podmodel.ID).
    """

    namespace: str
    name: str

    def __str__(self) -> str:  # "<ns>/<name>" form used in ETCD keys and logs
        return f"{self.namespace}/{self.name}"

    @classmethod
    def parse(cls, s: str) -> "PodID":
        ns, _, name = s.partition("/")
        return cls(ns, name)


class Action(enum.IntEnum):
    """Rule action. Reference: renderer/api.go:139-147."""

    DENY = 0
    PERMIT = 1


class Protocol(enum.IntEnum):
    """L4 protocol of a rule. Reference: renderer/api.go:161-169.

    The reference's renderer layer only distinguishes TCP/UDP (ICMP and
    OTHER are handled by explicit appended rules in the ACL renderer); we
    additionally carry ANY/ICMP through the IR so the TPU tables can encode
    them natively rather than via renderer-specific appendices.
    """

    TCP = 0
    UDP = 1
    ICMP = 2
    ANY = 3

    @property
    def ip_proto(self) -> int:
        """IANA protocol number (ANY has none; returns -1)."""
        return {Protocol.TCP: 6, Protocol.UDP: 17, Protocol.ICMP: 1}.get(self, -1)


@dataclass(frozen=True)
class ContivRule:
    """An n-tuple rule: action + L3 src/dst networks + L4 protocol/ports.

    ``src_network``/``dest_network`` of ``None`` and port ``0`` mean
    "match all". Instances are immutable and hashable so they can be used
    directly as dict keys (the renderer cache dedups tables by rule lists).

    Reference: plugins/policy/renderer/api.go:65-77.
    """

    action: Action
    src_network: Optional[IPNetwork] = None
    dest_network: Optional[IPNetwork] = None
    protocol: Protocol = Protocol.TCP
    src_port: int = ANY_PORT
    dest_port: int = ANY_PORT

    def __str__(self) -> str:
        src = str(self.src_network) if self.src_network is not None else "ANY"
        dst = str(self.dest_network) if self.dest_network is not None else "ANY"
        sp = str(self.src_port) if self.src_port else "ANY"
        dp = str(self.dest_port) if self.dest_port else "ANY"
        return (
            f"Rule <{self.action.name} {src}[{self.protocol.name}:{sp}]"
            f" -> {dst}[{self.protocol.name}:{dp}]>"
        )

    # Total order (see compare_rules); enables `sorted(rules)`.
    def __lt__(self, other: "ContivRule") -> bool:
        return compare_rules(self, other) < 0


def compare_ints(a: int, b: int) -> int:
    return (a > b) - (a < b)


def compare_ports(a: int, b: int) -> int:
    """Port order: 0 (= all ports) is *higher* than any specific port.

    Reference: plugins/policy/utils/utils.go ComparePorts.
    """
    if a == b:
        return 0
    if a == ANY_PORT:
        return 1
    if b == ANY_PORT:
        return -1
    return compare_ints(a, b)


def compare_ip_nets(a: Optional[IPNetwork], b: Optional[IPNetwork]) -> int:
    """Network order such that a ⊂ b ⇒ a < b; None (= 0/0) is the maximum.

    Reference: plugins/policy/utils/utils.go CompareIPNets.
    """
    if a is None:
        return 0 if b is None else 1
    if b is None:
        return -1

    # IPv4 sorts before IPv6.
    a4, b4 = a.version == 4, b.version == 4
    if a4 != b4:
        return -1 if a4 else 1

    # Same common prefix => longer (more specific) prefix sorts first.
    common = min(a.prefixlen, b.prefixlen)
    a_net = int(a.network_address) >> (a.max_prefixlen - common) if common else 0
    b_net = int(b.network_address) >> (b.max_prefixlen - common) if common else 0
    if a_net == b_net:
        return compare_ints(b.prefixlen, a.prefixlen)

    # Disjoint subnets: arbitrary but total order (by mask desc, then address).
    mask_order = compare_ints(b.prefixlen, a.prefixlen)
    if mask_order != 0:
        return mask_order
    return compare_ints(int(a.network_address), int(b.network_address))


def compare_rules(a: ContivRule, b: ContivRule) -> int:
    """Total order over rules: if a matches a subset of b's traffic, a < b.

    Order of significance: protocol, src net, dst net, src port, dst port,
    action. Reference: renderer/api.go:110-136.
    """
    for cmp in (
        compare_ints(int(a.protocol), int(b.protocol)),
        compare_ip_nets(a.src_network, b.src_network),
        compare_ip_nets(a.dest_network, b.dest_network),
        compare_ports(a.src_port, b.src_port),
        compare_ports(a.dest_port, b.dest_port),
    ):
        if cmp != 0:
            return cmp
    return compare_ints(int(a.action), int(b.action))


def compare_rule_lists(a: List[ContivRule], b: List[ContivRule]) -> int:
    """Lexicographic order over sorted rule lists (used for table dedup)."""
    for ra, rb in zip(a, b):
        cmp = compare_rules(ra, rb)
        if cmp != 0:
            return cmp
    return compare_ints(len(a), len(b))


def allow_all_tcp() -> ContivRule:
    """PERMIT ANY->ANY TCP. Reference: cache_impl.go allowAllTCP."""
    return ContivRule(action=Action.PERMIT, protocol=Protocol.TCP)


def allow_all_udp() -> ContivRule:
    """PERMIT ANY->ANY UDP. Reference: cache_impl.go allowAllUDP."""
    return ContivRule(action=Action.PERMIT, protocol=Protocol.UDP)


def one_host_subnet(addr: str) -> IPNetwork:
    """The /32 (or /128) subnet containing only the given host address.

    Reference: plugins/policy/utils/utils.go GetOneHostSubnet.
    """
    ip = ipaddress.ip_address(addr)
    return ipaddress.ip_network(f"{ip}/{ip.max_prefixlen}")


def rule_matches(
    rule: ContivRule,
    src_ip: str,
    dst_ip: str,
    protocol: Protocol,
    src_port: int,
    dst_port: int,
) -> bool:
    """Pure-Python oracle: does the rule match the given 5-tuple?

    Used by tests and the mock classification engine to cross-check the
    TPU kernels (the reference's analog is mock/aclengine).
    """
    if rule.protocol != Protocol.ANY and protocol != rule.protocol:
        return False
    if rule.src_network is not None and ipaddress.ip_address(src_ip) not in rule.src_network:
        return False
    if rule.dest_network is not None and ipaddress.ip_address(dst_ip) not in rule.dest_network:
        return False
    if rule.src_port != ANY_PORT and src_port != rule.src_port:
        return False
    if rule.dest_port != ANY_PORT and dst_port != rule.dest_port:
        return False
    return True
