"""Cluster-unique node ID allocation via kvstore compare-and-put.

Each agent claims the smallest free uint8 ID by CAS-inserting its node
name under ``allocatedIDs/<id>``; on restart it finds and reuses its
existing claim. The allocator also publishes the node's data-plane IP and
management IP for other nodes' node-event handlers to consume.

Reference: plugins/contiv/node_id_allocator.go (getID :77,
writeIfNotExists :178, updateEtcdEntry :133).
"""

from __future__ import annotations

from typing import Dict, Optional

from vpp_tpu_torch.kvstore.store import KVStore

ID_PREFIX = "allocatedIDs/"
# lease-attached liveness keys: present while the node's agent keeps
# its lease alive; expiry (crash, partition) deletes the key and every
# peer's watch removes the routes toward that node. The ID claim itself
# stays persistent so a restarting node reuses its ID (the reference
# keeps allocations in etcd; liveness is the etcd-lease analog).
LIVENESS_PREFIX = "nodeliveness/"
MAX_ID = 255


class NodeIDAllocator:
    def __init__(self, store: KVStore, node_name: str,
                 liveness_ttl_s: float = 15.0):
        self.store = store
        self.node_name = node_name
        self.node_id: Optional[int] = None
        self.liveness_ttl_s = liveness_ttl_s
        self._lease: Optional[int] = None
        self._liveness_info: Optional[dict] = None

    def get_or_allocate(self) -> int:
        """Find this node's existing claim or CAS-claim the smallest free ID."""
        if self.node_id is not None:
            return self.node_id
        # Reuse an existing claim (agent restart).
        for key, val in self.store.list_values(ID_PREFIX).items():
            if isinstance(val, dict) and val.get("name") == self.node_name:
                self.node_id = int(key[len(ID_PREFIX):])
                return self.node_id
        # Claim the smallest free ID; retry on CAS races with other agents.
        for attempt in range(MAX_ID):
            taken = {
                int(k[len(ID_PREFIX):]) for k in self.store.list_keys(ID_PREFIX)
            }
            candidate = next(
                (i for i in range(1, MAX_ID + 1) if i not in taken), None
            )
            if candidate is None:
                raise RuntimeError("node ID space exhausted")
            if self.store.compare_and_put(
                ID_PREFIX + str(candidate), None, {"name": self.node_name}
            ):
                self.node_id = candidate
                return candidate
        raise RuntimeError("node ID space exhausted")

    def publish_ips(self, node_ip: str, mgmt_ip: str = "") -> None:
        """Publish this node's data-plane and management IPs for peers."""
        if self.node_id is None:
            raise RuntimeError("allocate an ID before publishing IPs")
        self.store.put(
            ID_PREFIX + str(self.node_id),
            {"name": self.node_name, "ip": node_ip, "mgmt_ip": mgmt_ip},
        )

    def publish_liveness(self, node_ip: str, mgmt_ip: str = "") -> int:
        """Publish a lease-attached liveness key; keep it alive with
        liveness_keepalive() from the agent maintenance loop. Expiry
        (crash/partition) auto-deletes the key — peers' node watches see
        the DELETE and tear down routes to this node."""
        if self.node_id is None:
            raise RuntimeError("allocate an ID before publishing liveness")
        self._lease = self.store.lease_grant(self.liveness_ttl_s)
        self._liveness_info = {
            "name": self.node_name, "ip": node_ip, "mgmt_ip": mgmt_ip,
        }
        self.store.put(
            LIVENESS_PREFIX + str(self.node_id), self._liveness_info,
            lease=self._lease,
        )
        return self._lease

    def liveness_keepalive(self) -> bool:
        """Refresh the liveness lease; re-grants + re-publishes if the
        lease was lost (kvserver restart, long partition)."""
        if self._lease is None or self._liveness_info is None:
            return False
        if self.store.lease_keepalive(self._lease):
            return True
        self._lease = self.store.lease_grant(self.liveness_ttl_s)
        self.store.put(
            LIVENESS_PREFIX + str(self.node_id), self._liveness_info,
            lease=self._lease,
        )
        return True

    def list_live_nodes(self) -> Dict[int, dict]:
        """Nodes with a current liveness key: id -> {name, ip, mgmt_ip}."""
        out = {}
        for key, val in self.store.list_values(LIVENESS_PREFIX).items():
            try:
                out[int(key[len(LIVENESS_PREFIX):])] = val
            except ValueError:
                continue
        return out

    def list_nodes(self) -> Dict[int, dict]:
        """All known nodes: id -> {name, ip?, mgmt_ip?}."""
        out = {}
        for key, val in self.store.list_values(ID_PREFIX).items():
            try:
                out[int(key[len(ID_PREFIX):])] = val
            except ValueError:
                continue
        return out

    def release(self) -> None:
        if self._lease is not None:
            try:
                self.store.lease_revoke(self._lease)
            except Exception:  # noqa: BLE001 — store may be gone
                pass
            self._lease = None
        if self.node_id is not None:
            self.store.delete(ID_PREFIX + str(self.node_id))
            self.node_id = None
