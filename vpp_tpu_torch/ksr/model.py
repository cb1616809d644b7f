"""K8s data models mirrored into the kvstore, as JSON-able dataclasses.

A copy of the reference's ``vpp_tpu/ksr/model.py`` (this package never
imports the JAX package).

Field sets follow the reference's protobufs (plugins/ksr/model/*/*.proto)
but use idiomatic Python: plain dicts for labels/selectors, dataclasses
with ``to_dict``/``from_dict`` instead of generated protobuf classes.

Key scheme (reference: ksr/model/ksrkey/keyval_key.go:22-44):
  namespaced types:  k8s/<type>/<name>/namespace/<ns>
  cluster types:     k8s/<type>/<name>
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Type, TypeVar, Union

K8S_PREFIX = "k8s"

T = TypeVar("T", bound="_Model")


class _Model:
    """Mixin: dict (JSON) conversion for nested dataclasses."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
        def build(tp, val):
            if val is None:
                return None
            if dataclasses.is_dataclass(tp):
                kwargs = {}
                for f in dataclasses.fields(tp):
                    if f.name in val:
                        kwargs[f.name] = build_field(f.type, val[f.name])
                return tp(**kwargs)
            return val

        def build_field(tp, val):
            # typing constructs as strings (from __future__ annotations) are
            # resolved by name against this module's namespace.
            if isinstance(tp, str):
                tp = eval(tp, globals())  # noqa: S307 - controlled input
            origin = getattr(tp, "__origin__", None)
            if origin is list:
                (item_tp,) = tp.__args__
                return [build_field(item_tp, v) for v in (val or [])]
            if origin is dict:
                return dict(val or {})
            if origin is Union:
                args = [a for a in tp.__args__ if a is not type(None)]
                if len(args) == 1:
                    return build_field(args[0], val)
                return val
            if dataclasses.is_dataclass(tp):
                return build(tp, val)
            return val

        return build(cls, d)


def key_prefix(key_type: str) -> str:
    return f"{K8S_PREFIX}/{key_type}/"


def key_for(key_type: str, name: str, namespace: Optional[str] = None) -> str:
    if namespace is None:
        return f"{K8S_PREFIX}/{key_type}/{name}"
    return f"{K8S_PREFIX}/{key_type}/{name}/namespace/{namespace}"


def parse_key(key: str) -> Dict[str, str]:
    """Parse a data-store key into {type, name, namespace?}."""
    parts = key.split("/")
    if len(parts) >= 2 and parts[0] == K8S_PREFIX:
        if len(parts) == 5 and parts[3] == "namespace":
            return {"type": parts[1], "name": parts[2], "namespace": parts[4]}
        if len(parts) == 3:
            return {"type": parts[1], "name": parts[2]}
    raise ValueError(f"invalid KSR key: {key}")


# --- label selectors (policy.proto LabelSelector) ---

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"


@dataclass
class LabelExpression(_Model):
    key: str
    operator: str                     # In / NotIn / Exists / DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector(_Model):
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelExpression] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        """K8s label-selector semantics: AND of all terms. An empty
        selector matches everything."""
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            has = expr.key in labels
            if expr.operator == IN:
                if not has or labels[expr.key] not in expr.values:
                    return False
            elif expr.operator == NOT_IN:
                if has and labels[expr.key] in expr.values:
                    return False
            elif expr.operator == EXISTS:
                if not has:
                    return False
            elif expr.operator == DOES_NOT_EXIST:
                if has:
                    return False
            else:
                raise ValueError(f"unknown operator {expr.operator}")
        return True


# --- pod (pod.proto) ---


@dataclass
class ContainerPort(_Model):
    name: str = ""
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"


@dataclass
class Container(_Model):
    name: str = ""
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class Pod(_Model):
    TYPE = "pod"
    name: str = ""
    namespace: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    ip_address: str = ""
    host_ip_address: str = ""
    containers: List[Container] = field(default_factory=list)

    def key(self) -> str:
        return key_for(self.TYPE, self.name, self.namespace)


# --- namespace (namespace.proto) ---


@dataclass
class Namespace(_Model):
    TYPE = "namespace"
    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)

    def key(self) -> str:
        return key_for(self.TYPE, self.name)


# --- network policy (policy.proto) ---

POLICY_DEFAULT = "DEFAULT"
POLICY_INGRESS = "INGRESS"
POLICY_EGRESS = "EGRESS"
POLICY_BOTH = "INGRESS_AND_EGRESS"


@dataclass
class IPBlock(_Model):
    cidr: str = ""
    except_cidrs: List[str] = field(default_factory=list)


@dataclass
class PolicyPeer(_Model):
    pods: Optional[LabelSelector] = None
    namespaces: Optional[LabelSelector] = None
    ip_block: Optional[IPBlock] = None


@dataclass
class PolicyPort(_Model):
    protocol: str = "TCP"
    port: Optional[int] = None        # numeric port
    port_name: str = ""               # named port (resolved per pod)


@dataclass
class PolicyRule(_Model):
    """One ingress ("from") or egress ("to") rule."""

    ports: List[PolicyPort] = field(default_factory=list)
    peers: List[PolicyPeer] = field(default_factory=list)


@dataclass
class Policy(_Model):
    TYPE = "policy"
    name: str = ""
    namespace: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    pods: LabelSelector = field(default_factory=LabelSelector)
    policy_type: str = POLICY_DEFAULT
    ingress_rules: List[PolicyRule] = field(default_factory=list)
    egress_rules: List[PolicyRule] = field(default_factory=list)

    def key(self) -> str:
        return key_for(self.TYPE, self.name, self.namespace)

    def applies_ingress(self) -> bool:
        return self.policy_type in (POLICY_DEFAULT, POLICY_INGRESS, POLICY_BOTH)

    def applies_egress(self) -> bool:
        return self.policy_type in (POLICY_EGRESS, POLICY_BOTH)


# --- service (service.proto) ---


@dataclass
class ServicePort(_Model):
    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: Union[int, str] = 0  # number or named container port
    node_port: int = 0


@dataclass
class Service(_Model):
    TYPE = "service"
    name: str = ""
    namespace: str = ""
    ports: List[ServicePort] = field(default_factory=list)
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""
    service_type: str = "ClusterIP"
    external_ips: List[str] = field(default_factory=list)
    external_traffic_policy: str = "Cluster"

    def key(self) -> str:
        return key_for(self.TYPE, self.name, self.namespace)


# --- endpoints (endpoints.proto) ---


@dataclass
class EndpointAddress(_Model):
    ip: str = ""
    node_name: str = ""
    target_pod: str = ""              # "<ns>/<name>" of the backing pod


@dataclass
class EndpointPort(_Model):
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class EndpointSubset(_Model):
    addresses: List[EndpointAddress] = field(default_factory=list)
    not_ready_addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[EndpointPort] = field(default_factory=list)


@dataclass
class Endpoints(_Model):
    TYPE = "endpoints"
    name: str = ""
    namespace: str = ""
    subsets: List[EndpointSubset] = field(default_factory=list)

    def key(self) -> str:
        return key_for(self.TYPE, self.name, self.namespace)


# --- node (node.proto) ---


@dataclass
class NodeAddress(_Model):
    type: str = ""                    # InternalIP / Hostname / ...
    address: str = ""


@dataclass
class Node(_Model):
    TYPE = "node"
    name: str = ""
    addresses: List[NodeAddress] = field(default_factory=list)
    pod_cidr: str = ""

    def key(self) -> str:
        return key_for(self.TYPE, self.name)


MODEL_TYPES: Dict[str, type] = {
    m.TYPE: m for m in (Pod, Namespace, Policy, Service, Endpoints, Node)
}
