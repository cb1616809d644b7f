"""The device policy renderer: ContivRules → rule tables on the card.

The counterpart of the reference's ``vpp_tpu/renderer/tpu.py``; the
module and the class keep their names (``TpuRenderer``,
``TpuRendererTxn``) so that a reader finds the counterpart and the
callers name one class in both packages. It renders to the port's
``Dataplane`` on the CUDA device: it builds on the shared RendererCache
for minimal diffs, maps each shared local table to a device table slot,
points pod interfaces at their slots, installs the global table, and
publishes everything as one table-epoch swap per commit (the role the
reference's ACL renderer plays for the VPP ACL plugin,
plugins/policy/renderer/acl).

Orientation: INGRESS — local tables classify traffic entering the
vswitch from a pod's interface, the global table classifies traffic
entering the node from the uplink (the VPPTCP renderer's orientation;
the ACL renderer uses EGRESS — either is expressible here, ingress needs
one classify point per packet instead of two).

Stateful return traffic is admitted by the data plane's reflective
session table (vpp_tpu_torch.ops.session), the analog of the reference's
reflective ACL (acl_renderer.go:40-44).
"""

from __future__ import annotations

from typing import List, Optional

from vpp_tpu_torch.ir.rule import ContivRule, IPNetwork, PodID
from vpp_tpu_torch.ir.table import TableType
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.renderer.api import PodConfig, PolicyRendererAPI, RendererTxn
from vpp_tpu_torch.renderer.cache import Orientation, RendererCache


class TpuRenderer(PolicyRendererAPI):
    def __init__(self, dataplane: Dataplane):
        self.dataplane = dataplane
        self.cache = RendererCache(Orientation.INGRESS)

    def new_txn(self, resync: bool = False) -> "TpuRendererTxn":
        return TpuRendererTxn(self, resync)

    def dump_tables(self):
        """Dump the installed tables (for resync verification/tests)."""
        return list(self.cache.local_tables) + [self.cache.get_global_table()]


class TpuRendererTxn(RendererTxn):
    def __init__(self, renderer: TpuRenderer, resync: bool):
        self.renderer = renderer
        self.resync = resync
        if resync:
            # Full replacement: wipe cached state; the txn below re-renders
            # everything, and commit() rebuilds the device tables.
            renderer.cache.flush()
            for table_id in list(renderer.dataplane.table_slots):
                renderer.dataplane.free_table_slot(table_id)
            for pod in list(renderer.dataplane.pod_if):
                renderer.dataplane.assign_pod_table(pod, None)
        self.cache_txn = renderer.cache.new_txn()

    def render(
        self,
        pod: PodID,
        pod_ip: Optional[IPNetwork],
        ingress: List[ContivRule],
        egress: List[ContivRule],
        removed: bool = False,
    ) -> "TpuRendererTxn":
        self.cache_txn.update(
            pod,
            PodConfig(pod_ip=pod_ip, ingress=ingress, egress=egress, removed=removed),
        )
        return self

    def commit(self) -> None:
        dp = self.renderer.dataplane
        with dp.commit_lock:
            self._commit_locked(dp)

    def _commit_locked(self, dp: Dataplane) -> None:
        changes = self.cache_txn.get_changes()
        for change in changes:
            table = change.table
            if table.type == TableType.GLOBAL:
                dp.builder.set_global_table(table.rules)
                continue
            if not table.pods:
                # Table lost all pods: release its device slot.
                dp.free_table_slot(table.id)
                continue
            slot = dp.alloc_table_slot(table.id)
            dp.builder.set_local_table(slot, table.rules)
        self.cache_txn.commit()
        # Reconcile interface→table assignment for every tracked pod: the
        # cache's ingress↔egress folding means a change to one pod's
        # policies can re-shape *other* pods' local tables (e.g. a new
        # policy on a server pod adds pinned rules to every sender's
        # table), so assignments can move for pods outside this txn.
        for pod in self.renderer.cache.get_all_pods():
            table = self.renderer.cache.get_local_table_by_pod(pod)
            dp.assign_pod_table(pod, table.id if table is not None else None)
        for pod in self.cache_txn.get_removed_pods():
            dp.assign_pod_table(pod, None)
        # A resync always publishes (its __init__ already mutated the
        # builder, even when nothing gets re-rendered).
        if changes or self.cache_txn.get_updated_pods() or self.resync:
            dp.builder.txn_label = (
                "policy-resync" if self.resync else "policy-render"
            )
            dp.swap()
