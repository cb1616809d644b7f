"""ContivPolicy: the processor→configurator intermediate representation.

A ContivPolicy is a K8s NetworkPolicy with all indirection resolved:
label selectors evaluated to pod lists, namespaces expanded, CIDRs
parsed. Traffic matched by any Match of any policy is ALLOWED; traffic
not matched by a non-empty policy set is DENIED.

Reference: plugins/policy/configurator/configurator_api.go:41-160.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from vpp_tpu_torch.ir.rule import IPNetwork, PodID
from vpp_tpu_torch.ir.rule import Protocol as RuleProtocol


class PolicyType(enum.IntEnum):
    INGRESS = 0
    EGRESS = 1
    BOTH = 2


class MatchType(enum.IntEnum):
    # Direction from the *pod's* point of view (K8s semantics):
    # INGRESS matches traffic entering the pod, EGRESS traffic leaving it.
    INGRESS = 0
    EGRESS = 1


class Protocol(enum.IntEnum):
    TCP = 0
    UDP = 1

    @property
    def rule_protocol(self) -> RuleProtocol:
        return RuleProtocol.TCP if self == Protocol.TCP else RuleProtocol.UDP


@dataclass(frozen=True)
class Port:
    protocol: Protocol = Protocol.TCP
    number: int = 0


@dataclass(frozen=True)
class IPBlock:
    network: IPNetwork = None
    except_nets: Tuple[IPNetwork, ...] = ()


@dataclass
class Match:
    """Predicate selecting a subset of traffic to be allowed.

    ``pods``/``ip_blocks`` of None (not empty list!) means the L3 side is
    unrestricted; ``ports`` empty means all ports.
    """

    type: MatchType
    pods: Optional[List[PodID]] = None
    ip_blocks: Optional[List[IPBlock]] = None
    ports: List[Port] = field(default_factory=list)


@dataclass
class ContivPolicy:
    id: Tuple[str, str]  # (namespace, name)
    type: PolicyType
    matches: List[Match] = field(default_factory=list)

    def sort_key(self) -> Tuple[str, str]:
        return self.id
