"""CNI request/reply model.

Mirrors the gRPC contract kubelet's shim speaks to the agent in the
reference (plugins/contiv/model/cni/cni.proto:22-28): Add/Delete carry
the container/sandbox identity plus free-form extra args (K8s pod name
and namespace travel in CNI_ARGS); the reply carries the result code,
created interfaces with their IPs, and routes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List


class ResultCode(enum.IntEnum):
    OK = 0
    ERROR = 1
    TRY_AGAIN = 11  # base vswitch config not ready yet


@dataclasses.dataclass(frozen=True)
class CNIRequest:
    container_id: str
    netns: str = ""
    if_name: str = "eth0"
    extra_args: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def pod_name(self) -> str:
        return self.extra_args.get("K8S_POD_NAME", "")

    @property
    def pod_namespace(self) -> str:
        return self.extra_args.get("K8S_POD_NAMESPACE", "default")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CNIRequest":
        return cls(
            container_id=d["container_id"],
            netns=d.get("netns", ""),
            if_name=d.get("if_name", "eth0"),
            extra_args=dict(d.get("extra_args", {})),
        )


@dataclasses.dataclass(frozen=True)
class CNIIpAddress:
    address: str            # CIDR form, e.g. "10.1.1.5/32"
    gateway: str = ""
    version: int = 4


@dataclasses.dataclass(frozen=True)
class CNIInterface:
    name: str
    sandbox: str = ""
    ip_addresses: List[CNIIpAddress] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class CNIRoute:
    dst: str
    gw: str = ""


@dataclasses.dataclass(frozen=True)
class CNIReply:
    result: ResultCode = ResultCode.OK
    error: str = ""
    interfaces: List[CNIInterface] = dataclasses.field(default_factory=list)
    routes: List[CNIRoute] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["result"] = int(self.result)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CNIReply":
        return cls(
            result=ResultCode(d.get("result", 0)),
            error=d.get("error", ""),
            interfaces=[
                CNIInterface(
                    name=i["name"],
                    sandbox=i.get("sandbox", ""),
                    ip_addresses=[
                        CNIIpAddress(**a) for a in i.get("ip_addresses", [])
                    ],
                )
                for i in d.get("interfaces", [])
            ],
            routes=[CNIRoute(**r) for r in d.get("routes", [])],
        )
