"""ServiceConfigurator: ContivService set → NAT44 device configuration.

Renders every tracked service into the data plane's NAT mapping/backend
arrays and publishes one table epoch per change. Semantics follow the
reference (plugins/service/configurator/configurator_impl.go):

- one DNAT mapping per (frontend address, service port): cluster IP,
  each external IP, and each node IP / node mgmt IP for nodeports
  (:299-404);
- weighted backend choice with local backends at 2x weight
  (localEndpointWeight, :31-33);
- "Local" external traffic policy keeps only node-local backends;
- SNAT address for traffic leaving the cluster (:258-264).

Two rendering paths, picked by the ``svc_vips`` capacity knob:

* **Legacy (svc_vips == 0)**: the full NAT table is rebuilt from the
  service map on every change — services are few, the rebuild is
  O(total backends), and it keeps the device arrays dense and
  fragmentation-free (the device analog of the reference's full-resync
  path against DumpNat44DNat, :213-296).
* **svc planes (svc_vips > 0)**: each VIP renders through
  the builder's KEYED service registry (set_service/del_service) into
  the ``svc_*`` planes, which ride their OWN "svc" upload group — a
  rolling backend replacement ships a few-KB scatter blob and ZERO
  ACL/ML/FIB bytes (docs/OVERLAY.md "zero-reship backend churn").
  Way assignment is sticky per VIP, so surviving backends keep their
  flows. The staging loop carries the ``service.churn`` fault point
  (testing/faults.py): a failure mid-churn rolls the builder back to
  the pre-churn snapshot, so a half-applied backend set never reaches
  a swap — the device either serves the OLD set or the NEW one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.vector import ip4
from vpp_tpu_torch.service.config import Backend, ContivService, TrafficPolicy
from vpp_tpu_torch.testing import faults
from vpp_tpu_torch.trace import spans

# Local backends get twice the share of hash space (reference
# configurator_impl.go localEndpointWeight).
LOCAL_BACKEND_WEIGHT = 2
REMOTE_BACKEND_WEIGHT = 1

_PROTO_NUM = {"TCP": 6, "UDP": 17}


class ServiceConfigurator:
    def __init__(self, dataplane: Dataplane, node_ips: Optional[List[str]] = None):
        self.dataplane = dataplane
        # Node frontend addresses used for nodeport mappings (node IP +
        # mgmt IP; reference processor feeds these on node events).
        self.node_ips: List[str] = list(node_ips or [])
        self.services: Dict[Tuple[str, str], ContivService] = {}

    # --- API (reference: configurator_api.go) ---
    def add_service(self, svc: ContivService) -> None:
        self.services[svc.id] = svc
        self._rebuild()

    def update_service(self, svc: ContivService) -> None:
        self.services[svc.id] = svc
        self._rebuild()

    def delete_service(self, svc_id: Tuple[str, str]) -> None:
        self.services.pop(svc_id, None)
        self._rebuild()

    def set_node_ips(self, node_ips: List[str]) -> None:
        """Node add/remove: nodeport frontends change on every node
        (reference: reconfigureNodePorts, processor_impl.go:357-373)."""
        self.node_ips = list(node_ips)
        self._rebuild()

    def set_snat_ip(self, ip: str) -> None:
        with self.dataplane.commit_lock:
            self.dataplane.builder.set_snat_ip(ip4(ip))
            self.dataplane.builder.txn_label = "service-snat-ip"
            self.dataplane.swap()

    def resync(self, services: List[ContivService]) -> None:
        self.services = {s.id: s for s in services}
        self._rebuild()

    # --- rendering ---
    def _rebuild(self) -> None:
        # "render" span: NAT table rebuild + its epoch swap, the service
        # path's leg of an applied txn's timeline
        with spans.RECORDER.span(
            "render", "service-nat-rebuild", services=len(self.services),
        ):
            with self.dataplane.commit_lock:
                if int(getattr(self.dataplane.config, "svc_vips", 0)) > 0:
                    self._render_svc_locked()
                else:
                    self._rebuild_locked()

    def _frontends(self, svc: ContivService,
                   spec) -> List[Tuple[int, int, bool]]:
        # (frontend ip, frontend port, self_snat): nodeport
        # frontends are marked self-snat so flows DNAT'd to a
        # remote backend also get source-NAT'd — the backend's
        # reply must return through this node for un-DNAT
        # (reference nodeport/TwoNodeNAT semantics).
        frontends: List[Tuple[int, int, bool]] = []
        if svc.cluster_ip:
            frontends.append((ip4(svc.cluster_ip), spec.port, False))
        for ext in svc.external_ips:
            frontends.append((ip4(ext), spec.port, False))
        if spec.node_port:
            for nip in self.node_ips:
                frontends.append((ip4(nip), spec.node_port, True))
        return frontends

    def _render_svc_locked(self) -> None:
        """svc-plane path: diff the desired VIP set against
        the builder's keyed registry and stage only the delta — removed
        VIPs first (frees rows), then set_service per surviving VIP
        (idempotent: an unchanged set compiles byte-identical rows, so
        the incremental "svc" upload ships nothing for it). The
        ``service.churn`` fault point fires after every staged
        mutation; any failure mid-churn restores the pre-churn builder
        snapshot — the swap below only ever publishes a COMPLETE set."""
        dp = self.dataplane
        builder = dp.builder
        desired: Dict[Tuple[int, int, int],
                      Tuple[List[Tuple[int, int, int]], bool]] = {}
        for svc in self.services.values():
            for pname, spec in svc.ports.items():
                weighted = self._weighted_backends(
                    svc, svc.backends.get(pname, []))
                if not weighted:
                    continue
                proto = _PROTO_NUM.get(spec.protocol.upper(), 6)
                for ext_ip, ext_port, self_snat in self._frontends(
                        svc, spec):
                    desired[(ext_ip, ext_port, proto)] = (
                        weighted, self_snat)
        snap = builder.state_snapshot()
        try:
            for key in sorted(set(builder.services) - set(desired)):
                builder.del_service(*key)
                faults.fire("service.churn")
            for key in sorted(desired):
                backends, self_snat = desired[key]
                builder.set_service(key[0], key[1], key[2], backends,
                                    self_snat=self_snat)
                faults.fire("service.churn")
        except Exception:
            builder.state_restore(snap)
            raise
        builder.txn_label = f"service-svc {len(desired)} vips"
        dp.swap()

    def _rebuild_locked(self) -> None:
        dp = self.dataplane
        builder = dp.builder
        builder.clear_nat()
        slot = 0
        boff = 0
        cfg = dp.config
        for svc in self.services.values():
            for pname, spec in svc.ports.items():
                backends = svc.backends.get(pname, [])
                weighted = self._weighted_backends(svc, backends)
                if not weighted:
                    continue
                frontends = self._frontends(svc, spec)
                proto = _PROTO_NUM.get(spec.protocol.upper(), 6)
                # All frontends of this service port share one backend range.
                n = len(weighted)
                if boff + n > cfg.nat_backends:
                    raise RuntimeError("NAT backend capacity exhausted")
                for ext_ip, ext_port, self_snat in frontends:
                    if slot >= cfg.nat_mappings:
                        raise RuntimeError("NAT mapping capacity exhausted")
                    builder.set_nat_mapping(
                        slot, ext_ip, ext_port, proto, weighted, boff=boff,
                        self_snat=self_snat,
                    )
                    slot += 1
                boff += n
        builder.txn_label = f"service-rebuild {len(self.services)} services"
        dp.swap()

    def _weighted_backends(
        self, svc: ContivService, backends: List[Backend]
    ) -> List[Tuple[int, int, int]]:
        if svc.traffic_policy == TrafficPolicy.LOCAL:
            backends = [b for b in backends if b.local]
        return [
            (
                ip4(b.ip),
                b.port,
                LOCAL_BACKEND_WEIGHT if b.local else REMOTE_BACKEND_WEIGHT,
            )
            for b in backends
        ]
