"""MeshRuntime: the deployable mesh data plane.

The PyTorch counterpart of ``vpp_tpu/parallel/runtime.py``: N cooperating
vswitch agents in ONE process share a ``ClusterDataplane`` over a
(node, rule) mesh. Every agent's dataplane is a cluster node handle, so
the unchanged renderer, CNI, service and node-event commit paths publish
cluster epochs through swap delegation, and inter-node traffic crosses
the fabric. VXLAN is left for the cluster's EDGE peers: nodes registered
in the store that are not on this mesh. The agents share one store and
learn each other through it, as standalone agents do; the runtime's
resolver tells each agent which allocator ids are mesh rows.

With ``io.enabled`` the runtime owns one ``IORingPair`` per node (the
per-node IO daemons attach to them) and ONE ``ClusterPump`` stepping
the fabric over all of them; the agents make no pump of their own
(``_external_io``). A maintenance thread ages the cluster's sessions
(``expire_sessions(lazy=True)``): the agents' own loops act on their
node handles, whose sessions belong to the cluster.

This runtime is one process on one device (parallel/mesh.py); the
multi-host form, one process per host, is parallel/multihost.py
``MultiHostRuntime``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Sequence

from vpp_tpu_torch.parallel.cluster import ClusterDataplane, ClusterStepResult
from vpp_tpu_torch.parallel.mesh import cluster_mesh
from vpp_tpu_torch.pipeline.vector import PacketVector

log = logging.getLogger("vpp_tpu_torch.mesh")


class MeshRuntime:
    """N agents + one ClusterDataplane over one mesh. Construction wires
    everything and starts nothing; ``start()`` boots the agents in mesh
    order, then the fabric pump and the aging thread."""

    def __init__(self, n_nodes: int, base_config, rule_shards: int = 1,
                 store=None, devices: Optional[Sequence] = None):
        from vpp_tpu_torch.cmd.agent import ContivAgent
        from vpp_tpu_torch.kvstore.client import connect_store

        self.mesh = cluster_mesh(n_nodes, rule_shards, devices=devices)
        self.cluster = ClusterDataplane(self.mesh, base_config.dataplane)
        if store is None:
            # the standalone agent's backend selection: node ids and pod
            # IPs must survive a mesh-agent restart as theirs do
            store = connect_store(base_config.store_url,
                                  persist_path=base_config.persist_path)
        self.store = store
        # allocator node id -> mesh row, filled as agents claim ids; the
        # agents resolve against the LIVE dict, so one built first still
        # routes into the fabric toward one built later
        self._mesh_pos: Dict[int, int] = {}
        self.agents: List[ContivAgent] = []
        for i in range(n_nodes):
            agent = ContivAgent(
                _node_config(base_config, i), store=store,
                dataplane=self.cluster.node(i),
                mesh_node_resolver=lambda nid: self._mesh_pos.get(nid, -1))
            self._mesh_pos[agent.node_id] = i
            agent.mesh_runtime = self  # `show mesh` on any node's CLI
            # the placement and per-shard gauges: snapshots of shared
            # state, so every node's collector may export them
            agent.stats.set_cluster(self.cluster)
            self.agents.append(agent)
        self.ring_pairs = None
        self.cluster_pump = None
        if base_config.io.enabled:
            from vpp_tpu_torch.io.cluster_pump import ClusterPump
            from vpp_tpu_torch.io.rings import IORingPair

            io = base_config.io
            self.ring_pairs = [
                IORingPair(n_slots=io.n_slots, snap=io.snap,
                           shm_name=(f"{io.shm_name}.{i}" if io.shm_name
                                     else None), create=True)
                for i in range(n_nodes)]
            self.cluster_pump = ClusterPump(
                self.cluster, self.ring_pairs, snap=io.snap,
                max_inflight=io.max_inflight,
                # ICMP errors from each node's pod gateway, re-injected
                # as that node's self-originated ingress (host if)
                icmp_src_ips=(
                    [int(a.ipam.pod_gateway_ip()) for a in self.agents]
                    if io.icmp_errors else None),
                ingress_ifs=[a.host_if for a in self.agents])
            for agent in self.agents:
                agent._external_io = True
                # the shared fabric pump backs every node's `show io`
                agent.io_pump = self.cluster_pump
            # cluster-wide counters: exported from ONE collector, so a
            # sum over the mesh's /stats endpoints does not overcount
            self.agents[0].stats.set_pump(self.cluster_pump)
        self._maint_stop: Optional[threading.Event] = None
        self._maint_thread: Optional[threading.Thread] = None

    @property
    def n_nodes(self) -> int:
        return self.cluster.n_nodes

    def mesh_position(self, allocator_node_id: int) -> int:
        """Mesh row of a registered node, -1 if it is an edge peer."""
        return self._mesh_pos.get(allocator_node_id, -1)

    def start(self) -> "MeshRuntime":
        for agent in self.agents:
            agent.start()
        if self.cluster_pump is not None:
            # after the agents' first swap published live tables
            self.cluster_pump.warm()
            self.cluster_pump.start()
        self._maint_stop = threading.Event()

        def _maint(interval: float = 5.0) -> None:
            while not self._maint_stop.wait(interval):
                try:
                    self.cluster.expire_sessions(lazy=True)
                except Exception:
                    log.exception("cluster session expiry failed")

        self._maint_thread = threading.Thread(
            target=_maint, daemon=True, name="mesh-maintenance")
        self._maint_thread.start()
        return self

    def close(self) -> None:
        if self._maint_stop is not None:
            self._maint_stop.set()
            # an expiry in flight must not race the pump and ring teardown
            self._maint_thread.join(timeout=30.0)
        pump_stopped = True
        if self.cluster_pump is not None:
            pump_stopped = self.cluster_pump.stop(join_timeout=30.0)
        for agent in reversed(self.agents):
            agent.close()
        if self.ring_pairs is not None:
            if pump_stopped:
                for rings in self.ring_pairs:
                    rings.close(
                        unlink=bool(self.agents[0].config.io.shm_name))
            else:
                # a wedged pump still holds ring pointers: leave the
                # mappings (process exit reclaims them)
                log.error("cluster pump did not stop; leaving rings mapped")

    # --- traffic (the fabric path the agents configure) ---
    def make_frames(self, per_node_packets, n: int = 256) -> PacketVector:
        return self.cluster.make_frames(per_node_packets, n=n)

    def step(self, pkts: PacketVector, now=None) -> ClusterStepResult:
        return self.cluster.step(pkts, now=now)


def _node_config(base, i: int):
    """Per-node AgentConfig: a distinct node name, sockets and ports, so
    N agents coexist in one process and host."""

    def suffix(path: str) -> str:
        return f"{path}.{i}" if path else path

    return dataclasses.replace(
        base,
        node_name=f"{base.node_name}-{i}" if base.node_name else f"node-{i}",
        cni_socket=suffix(base.cni_socket),
        cli_socket=suffix(base.cli_socket),
        vcl_socket=suffix(base.vcl_socket),
        txn_journal_path=suffix(base.txn_journal_path),
        stats_port=base.stats_port + i,
        health_port=base.health_port + i,
        # each node talks to its OWN IO daemon
        io=dataclasses.replace(
            base.io,
            control_socket=suffix(base.io.control_socket),
            shm_name=suffix(base.io.shm_name),
            plan_path=suffix(base.io.plan_path)))
