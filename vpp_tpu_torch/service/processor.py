"""ServiceProcessor: Service + Endpoints models → ContivService.

Tracks services and endpoints (fed from kvstore watches or directly),
merges each pair into a ContivService — resolving target ports through
endpoint subsets and marking node-local backends — and pushes changes to
the configurator.

Reference: plugins/service/processor (processor_impl.go:90-373,
service.go GetContivService/GetLocalBackends).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from vpp_tpu_torch.ksr import model as m
from vpp_tpu_torch.service.config import Backend, ContivService, ServicePortSpec, TrafficPolicy
from vpp_tpu_torch.service.configurator import ServiceConfigurator


class ServiceProcessor:
    def __init__(self, configurator: ServiceConfigurator, node_name: str = ""):
        self.configurator = configurator
        self.node_name = node_name
        self.services: Dict[Tuple[str, str], m.Service] = {}
        self.endpoints: Dict[Tuple[str, str], m.Endpoints] = {}

    # --- event ingestion ---
    def update_service(self, svc: m.Service) -> None:
        key = (svc.namespace, svc.name)
        existed = key in self.services
        self.services[key] = svc
        contiv = self._build(key)
        if contiv is None:
            # Service became unrenderable (e.g. ports removed): withdraw
            # any previously installed mappings instead of leaving them.
            if existed:
                self.configurator.delete_service(key)
            return
        if existed:
            self.configurator.update_service(contiv)
        else:
            self.configurator.add_service(contiv)

    def delete_service(self, namespace: str, name: str) -> None:
        key = (namespace, name)
        if self.services.pop(key, None) is not None:
            self.configurator.delete_service(key)

    def update_endpoints(self, eps: m.Endpoints) -> None:
        key = (eps.namespace, eps.name)
        self.endpoints[key] = eps
        if key in self.services:
            contiv = self._build(key)
            if contiv is not None:
                self.configurator.update_service(contiv)

    def delete_endpoints(self, namespace: str, name: str) -> None:
        key = (namespace, name)
        if self.endpoints.pop(key, None) is not None and key in self.services:
            contiv = self._build(key)
            if contiv is not None:
                self.configurator.update_service(contiv)

    def resync(self, services: List[m.Service], endpoints: List[m.Endpoints]) -> None:
        self.services = {(s.namespace, s.name): s for s in services}
        self.endpoints = {(e.namespace, e.name): e for e in endpoints}
        contivs = []
        for key in self.services:
            c = self._build(key)
            if c is not None:
                contivs.append(c)
        self.configurator.resync(contivs)

    # --- merge (reference: processor/service.go) ---
    def _build(self, key: Tuple[str, str]) -> Optional[ContivService]:
        svc = self.services.get(key)
        if svc is None or not svc.ports:
            return None
        eps = self.endpoints.get(key)
        contiv = ContivService(
            id=key,
            traffic_policy=(
                TrafficPolicy.LOCAL
                if svc.external_traffic_policy == "Local"
                else TrafficPolicy.CLUSTER
            ),
            cluster_ip=svc.cluster_ip if svc.cluster_ip not in ("", "None") else "",
            external_ips=list(svc.external_ips),
        )
        for sp in svc.ports:
            pname = sp.name or str(sp.port)
            contiv.ports[pname] = ServicePortSpec(
                protocol=sp.protocol or "TCP",
                port=sp.port,
                node_port=sp.node_port,
            )
            contiv.backends[pname] = self._backends_for(sp, eps)
        return contiv

    def _backends_for(
        self, sp: m.ServicePort, eps: Optional[m.Endpoints]
    ) -> List[Backend]:
        if eps is None:
            return []
        out: List[Backend] = []
        for subset in eps.subsets:
            # Resolve the endpoint port: by name if the service port is
            # named, else the single port of the subset.
            target_port = None
            for ep_port in subset.ports:
                if sp.name and ep_port.name == sp.name:
                    target_port = ep_port.port
                    break
            if target_port is None and subset.ports:
                if len(subset.ports) == 1 or not sp.name:
                    target_port = subset.ports[0].port
            if target_port is None:
                # No resolvable port; fall back to the numeric target_port.
                if isinstance(sp.target_port, int) and sp.target_port:
                    target_port = sp.target_port
                else:
                    continue
            for addr in subset.addresses:
                out.append(
                    Backend(
                        ip=addr.ip,
                        port=target_port,
                        local=bool(self.node_name) and addr.node_name == self.node_name,
                    )
                )
        return out
