"""Multi-host cluster data plane: one mesh across processes.

The PyTorch counterpart of ``vpp_tpu/parallel/multihost.py``. The
reference scales past one machine by running more DaemonSet replicas
joined over the DCN; here the same cluster step (parallel/cluster.py)
runs with its mesh rows split over ``torch.distributed`` ranks, one
process per host. What multi-host adds is the *process discipline*:

- ``init_multihost`` first: the ranks' process group, given its
  coordinator address, world size and rank (nothing tells a process of
  a cluster). Its backend is ``gloo`` (``BACKEND``), the one transport
  everywhere: a rank's fabric rows are staged through pinned host
  buffers, as the reference's fabric crosses hosts over the DCN. The
  group's timeout is the heartbeat timeout, so a dead peer raises inside
  a collective instead of hanging it.
- Rank r of R owns the contiguous mesh rows ``[r N/R, (r+1) N/R)``,
  held as a single-host ``ClusterDataplane`` of ``[N/R, rule_shards]``
  on its device; it stages ONLY those nodes' builders. Only the node
  axis crosses processes: a node's rule shards never span two, so the
  rule-axis recombines stay in-process tensor operations. The one
  collective of a data-path step is the fabric's ``all_to_all``; the
  agreements (``process_allgather``) are small host collectives.
- ``publish()`` and ``step()`` are COLLECTIVE: every rank must call
  them the same number of times in the same order, at the same vector
  width (the standard SPMD multi-controller contract). A result holds
  this rank's rows only: ``local_rows`` reads them.

Without an initialised process group the cluster is a world of one:
the reference's single-controller case, which its own unit suite runs
(``tests/test_multihost_unit.py``), with ``process_allgather`` the
identity and the exchange's swap in-process. That is the same semantics
at R = 1, not a fallback.

``vpp-tpu-torch-mesh-agent --coordinator host:port --num-processes R
--process-id r`` runs ``MultiHostRuntime`` (one per host);
``vpp_tpu_torch.testing.multihost`` holds the reference's multi-process
scenarios as rank programs.
"""

from __future__ import annotations

import datetime
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vpp_tpu_torch.parallel.cluster import ClusterDataplane, ClusterStepResult
from vpp_tpu_torch.parallel.mesh import cluster_mesh
from vpp_tpu_torch.pipeline.tables import DataplaneConfig, resolve_device
from vpp_tpu_torch.pipeline.vector import PacketVector

log = logging.getLogger("vpp_tpu_torch.multihost")

# the process group's backend: the one transport of the ranks, on the
# CPU and on the card alike (module doc)
BACKEND = "gloo"


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   heartbeat_timeout_s: int = 100) -> None:
    """This process's rank of the process group: ``coordinator_address``
    is ``host:port``, served by rank 0. ``heartbeat_timeout_s`` is the
    group's timeout: a collective a peer never joins raises after it."""
    dist.init_process_group(
        BACKEND, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=heartbeat_timeout_s))


def rank_and_world():
    """(this process's rank, the number of ranks): (0, 1) without an
    initialised process group (module doc)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier(name: str) -> None:
    """Cross-process sync point (e.g. 'tables-staged' before a
    collective publish); ``name`` labels it in the log."""
    if rank_and_world()[1] > 1:
        log.debug("barrier %s", name)
        dist.barrier()


def shutdown_multihost() -> None:
    """Leave the process group together: a barrier, then its teardown,
    so no rank exits while a peer still reads the rendezvous store rank
    0 serves (what ``jax.distributed``'s exit hook does for the
    reference). A no-op without a group."""
    if dist.is_available() and dist.is_initialized():
        barrier("shutdown")
        dist.destroy_process_group()


def process_allgather(x) -> np.ndarray:
    """Every rank's int32 array ``x``, stacked in rank order
    (``[world, *x.shape]``): a host collective."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.int32))
    world = rank_and_world()[1]
    if world == 1:
        return x[None]
    got = [torch.empty(x.shape, dtype=torch.int32) for _ in range(world)]
    dist.all_gather(got, torch.from_numpy(x))
    return torch.stack(got).numpy()


class FabricSwap:
    """The exchange's swap across ranks: the pack's ``[n_src, N, B, ...]``
    header and payload rows, each destination's block of this rank's
    sources, go to the rank that owns the destination in one
    ``all_to_all`` of host copies (pinned on the card), one byte row per
    (destination, source) pair, and come back as ``[world, n_dst, n_src,
    B, ...]`` views of one device buffer (the leading axis the source
    rank), what ``ClusterStep.unpack`` reads. One device-to-host copy and
    one host sync before the collective, one host-to-device copy after
    it. The buffers are kept per shape, so the views a captured part
    reads are the same memory every swap.

    ``stats`` sums, per swap: ``wait_s``, the host's wait for the
    device's work before the swap; ``d2h_s`` and ``h2d_s``, the copies'
    device time (CUDA events; host time on the CPU; the last swap's
    host-to-device copy counts once ``settle`` has run after it);
    ``all_to_all_s``, the collective's host time; ``bytes_sent``, the
    bytes this rank sent to other ranks."""

    def __init__(self, world: int):
        self.world = world
        self._bufs: Dict[tuple, tuple] = {}
        self._h2d = None  # the last host-to-device copy's events
        self.stats = {"swaps": 0, "bytes_sent": 0, "wait_s": 0.0,
                      "d2h_s": 0.0, "all_to_all_s": 0.0, "h2d_s": 0.0}

    def settle(self) -> None:
        """Count the last host-to-device copy's device time (after the
        stream reached it)."""
        if self._h2d is not None and self._h2d[1].query():
            self.stats["h2d_s"] += self._h2d[0].elapsed_time(
                self._h2d[1]) / 1e3
            self._h2d = None

    def _buffers(self, n_src, n, b, hb, snap, device) -> tuple:
        key = (n_src, n, b, hb, snap, device)
        bufs = self._bufs.get(key)
        if bufs is None:
            n_dst, row = n // self.world, b * (hb + snap)
            cuda = device.type == "cuda"
            out = torch.empty((self.world, n_dst, n_src, row),
                              dtype=torch.uint8, device=device)
            views = (out[..., :b * hb].view(self.world, n_dst, n_src, b, hb),
                     out[..., b * hb:].view(self.world, n_dst, n_src, b, snap)
                     if snap else None)
            bufs = (*(torch.empty((n, n_src, row), dtype=torch.uint8,
                                  pin_memory=cuda) for _ in range(2)),
                    out, views)
            self._bufs[key] = bufs
        return bufs

    def __call__(self, packed) -> tuple:
        hdr, pay = packed.hdr, packed.pay
        n_src, n, b, hb = hdr.shape
        snap = 0 if pay is None else pay.shape[3]
        n_dst = n // self.world
        cuda = hdr.device.type == "cuda"
        host_send, host_recv, out, views = self._buffers(
            n_src, n, b, hb, snap, hdr.device)
        # destination-major: rank j's block is rows [j n_dst, (j+1) n_dst)
        send = hdr.transpose(0, 1).reshape(n, n_src, b * hb)
        if pay is not None:
            send = torch.cat([send, pay.transpose(0, 1)
                              .reshape(n, n_src, b * snap)], dim=2)
        st = self.stats
        t0 = time.perf_counter()
        if cuda:
            a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            host_send.copy_(send, non_blocking=True)
            e.record()
            e.synchronize()   # the swap's one host sync
            self.settle()
            d2h = a.elapsed_time(e) / 1e3
        else:
            host_send.copy_(send)
            d2h = time.perf_counter() - t0
        t1 = time.perf_counter()
        dist.all_to_all_single(host_recv, host_send)
        t2 = time.perf_counter()
        recv = host_recv.view(out.shape)
        if cuda:
            self._h2d = tuple(torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
            self._h2d[0].record()
            out.copy_(recv, non_blocking=True)
            self._h2d[1].record()
        else:
            out.copy_(recv)
            st["h2d_s"] += time.perf_counter() - t2
        st["swaps"] += 1
        st["bytes_sent"] += (n - n_dst) * host_send[0].numel()
        st["wait_s"] += max(0.0, t1 - t0 - d2h)
        st["d2h_s"] += d2h
        st["all_to_all_s"] += t2 - t1
        return views


class MultiHostCluster:
    """Process-local controller of a cross-process cluster mesh.

    Mirrors ClusterDataplane's surface for the nodes THIS rank owns
    (``local_nodes``; ``node(i)`` takes a global mesh row); ``publish``
    and ``step`` are collective (module doc). ``device``: where this
    rank's rows live (None: the card; raises without one)."""

    def __init__(self, n_nodes: int,
                 config: Optional[DataplaneConfig] = None,
                 rule_shards: int = 1, device=None):
        self.rank, self.world = rank_and_world()
        if n_nodes % self.world:
            raise ValueError(
                f"{n_nodes} mesh rows do not split evenly over "
                f"{self.world} processes: no rank may hold part of a row "
                "(rule_shards must not split a node across hosts)")
        n_local = n_nodes // self.world
        dev = resolve_device(device)
        self.n_nodes = n_nodes
        self.local_nodes: List[int] = list(range(self.rank * n_local,
                                                 (self.rank + 1) * n_local))
        self.mesh = cluster_mesh(n_local, rule_shards,
                                 [dev] * (n_local * rule_shards))
        # the rule-sharding refusals (partitioning, tenancy, BV word
        # alignment) are ClusterDataplane's, the reference's messages
        self.fabric = FabricSwap(self.world) if self.world > 1 else None
        self.plane = ClusterDataplane(self.mesh, config, fabric=self.fabric)
        self.config = self.plane.config
        self.device = self.plane.device

        def _no_local_swap():
            raise RuntimeError(
                "node swap() is collective in multi-host mode: "
                "stage builders on every process, then call "
                "MultiHostCluster.publish() on all of them")

        self.nodes: Dict[int, object] = {}
        for k, i in enumerate(self.local_nodes):
            node = self.plane.node(k)
            node._swap_delegate = _no_local_swap
            self.nodes[i] = node

    def node(self, i: int):
        return self.nodes[i]

    # --- the live epoch (this rank's rows) ---
    @property
    def tables(self):
        return self.plane.tables

    @property
    def epoch(self) -> int:
        return self.plane.epoch

    @property
    def fib_impl(self) -> str:
        """The FIB rung the LIVE fleet epoch runs ("dense" | "lpm"),
        agreed across processes at publish."""
        return self.plane.fib_impl

    @property
    def classifier_impl(self) -> str:
        return self.plane.classifier_impl

    @property
    def _use_mxu(self) -> bool:
        return self.plane._use_mxu

    @property
    def mxu_threshold(self) -> int:
        return self.plane.mxu_threshold

    @mxu_threshold.setter
    def mxu_threshold(self, v: int) -> None:
        self.plane.mxu_threshold = v

    @property
    def graphs(self) -> bool:
        return self.plane.graphs

    @graphs.setter
    def graphs(self, v: bool) -> None:
        self.plane.graphs = bool(v)

    # --- collective operations ---
    def publish(self) -> int:
        """COLLECTIVE: upload this rank's staged node builders into its
        rows and agree the fleet's selection (ClusterDataplane.swap
        split across processes). Sessions carry over."""
        plane = self.plane
        with plane._lock:
            # ClusterDataplane.swap's misconfiguration guard, made
            # COLLECTIVE: targets and uplinks live on different ranks,
            # so each contributes its local bitmaps and every rank
            # checks the identical union
            n = self.n_nodes
            targets = np.zeros(n, np.int32)
            uplinked = np.zeros(n, np.int32)
            oob = np.zeros(n, np.int32)  # row 2 of the gather
            oob_detail = ""
            for i, node in self.nodes.items():
                with node._lock:
                    b = node.builder
                    t = np.asarray(b.fib_node_id)[np.asarray(b.fib_plen) >= 0]
                t = np.unique(t[t >= 0])
                if (t >= n).any():
                    # a raw allocator id where a mesh POSITION belongs.
                    # Do NOT raise here: the peers are already inside (or
                    # entering) the gather and a one-sided abort would
                    # strand them — the flag rides the gather so EVERY
                    # rank raises on the same tick
                    oob[0] = 1
                    oob_detail = (f"node {i} stages routes to node id(s) "
                                  f"{t[t >= n].tolist()}")
                targets[t[t < n]] = 1
                if node.uplink_if is not None:
                    uplinked[i] = 1
            gathered = process_allgather(np.stack([targets, uplinked, oob]))
            if gathered[:, 2].max() > 0:
                raise ValueError(
                    "staged fabric routes target node id(s) outside this "
                    f"{n}-node mesh (allocator id vs mesh position "
                    f"aliasing?) {oob_detail}".rstrip())
            bad = np.nonzero((gathered[:, 0].max(axis=0) > 0)
                             & ~(gathered[:, 1].max(axis=0) > 0))[0]
            if len(bad):
                raise ValueError(
                    f"fabric routes target node(s) {bad.tolist()} which "
                    "have no uplink interface (call add_uplink())")
            plane._upload()
            # the selection is CLUSTER state: one step variant serves
            # every node, so each rank's eligibility is gathered and the
            # SAME ladder runs on the agreed rows everywhere
            plane._refresh_selection(
                process_allgather(plane._selection_bits()))
            return plane._commit_epoch()

    def make_frames(self, per_local_node_packets: Sequence[list],
                    n: int = 256) -> PacketVector:
        """This rank's frames for ITS nodes, stacked ``[n_local, n]``."""
        return self.plane.make_frames(per_local_node_packets, n=n)

    def step(self, pkts: PacketVector, now: Optional[int] = None,
             budget: int = 0) -> ClusterStepResult:
        """COLLECTIVE: one fabric step over this rank's ``[n_local, P]``
        vector. ``now`` must be identical on every rank (pass an
        explicit logical tick; wall clocks drift)."""
        if self.tables is None:
            raise RuntimeError("publish() first")
        return self.plane.step(pkts, now=self.epoch if now is None else now,
                               budget=budget)

    def step_wire(self, pkts: PacketVector, payload, now: int,
                  budget: int = 0):
        """COLLECTIVE: the wire step — headers AND payload bytes ride
        the fabric (ClusterDataplane.step_wire over this rank's rows)."""
        if self.tables is None:
            raise RuntimeError("publish() first")
        return self.plane.step_wire(pkts, payload, now=now, budget=budget)

    def expire_sessions(self, now: int, max_age: Optional[int] = None,
                        lazy: bool = False) -> int:
        """Bulk-age this rank's session tables (reflective + NAT) at the
        fleet-agreed tick ``now`` (ClusterDataplane.expire_sessions).
        The rule axis never crosses ranks, so no collective runs; the
        ``lazy`` decision derives from the collective step counter and
        the fleet-identical config, so every rank decides alike."""
        return self.plane.expire_sessions(max_age, lazy=lazy, now=now)

    # --- host views of a step result ---
    @staticmethod
    def local_rows(arr) -> np.ndarray:
        """This rank's node rows of a result field (a result holds only
        this rank's rows), as NumPy."""
        if torch.is_tensor(arr):
            return arr.detach().cpu().numpy()
        return np.asarray(arr)


class LockstepDriver:
    """Store-coordinated epoch commits for a MultiHostCluster.

    publish() is collective, but config changes originate on ONE host
    (a policy event, a CNI Add). The protocol, per tick of the driver
    loop every process runs:

      1. the requesting process stages its builder mutations locally
         and bumps the ``commit_req`` counter (CAS);
      2. every process reads the counter LOCALLY, then the fleet agrees
         on ``min(process_allgather(seen))`` — a tiny host collective,
         so the DECISION to publish is itself deterministic;
      3. once every process has seen request N > applied, they all
         publish() on the SAME tick, then step().

    A process that hasn't noticed the request yet holds the fleet's
    epoch back (min-agreement) but never deadlocks it: the fabric keeps
    stepping on the old epoch until agreement lands.
    """

    def __init__(self, cluster: MultiHostCluster, store,
                 prefix: str = "/mesh/epoch/",
                 expire_every: int = 512):
        self.cluster = cluster
        self.store = store
        self.req_key = prefix + "commit_req"
        self.stop_key = prefix + "stop_req"
        self.applied = 0
        self.ticks = 0
        # stop requests count RELATIVE to construction: a stop agreed by
        # a PREVIOUS deployment persists in the store and must not halt
        # a restarted fleet on its first tick. The baseline itself is
        # AGREED (max over every rank's read), so construction is
        # collective: every rank builds its driver at the same point
        self._stop_base = int(process_allgather(
            int(self.store.get(self.stop_key) or 0)).max())
        # session aging cadence (in ticks): deterministic from the shared
        # tick count, so the aging runs on the same tick fleet-wide
        self.expire_every = expire_every

    def _bump(self, key: str) -> int:
        while True:
            cur = self.store.get(key)
            nxt = int(cur or 0) + 1
            if self.store.compare_and_put(key, cur, nxt):
                return nxt

    def request_commit(self) -> int:
        """Bump the commit counter (any process; CAS-safe)."""
        return self._bump(self.req_key)

    def request_stop(self) -> int:
        """Ask the WHOLE fleet to stop ticking: collectives can't be
        abandoned unilaterally (a peer blocked in one would hang), so
        shutdown is agreed the same way commits are."""
        return self._bump(self.stop_key)

    def tick(self, per_local_node_packets: Sequence[list],
             n: int = 256) -> Optional[ClusterStepResult]:
        """COLLECTIVE: agree on pending commits / stop, publish if the
        whole fleet has seen a commit, then run one fabric step.
        Returns None once the fleet has agreed to stop — no further
        collectives may be issued after that."""
        out = self.tick_fabric(
            lambda t: self.cluster.step(
                self.cluster.make_frames(per_local_node_packets, n=n),
                now=t),
            has_work=True)  # header-mode callers pass explicit frames
        return None if out is self._STOPPED else out

    _STOPPED = object()

    def tick_fabric(self, fabric_fn, has_work: bool = True):
        """COLLECTIVE tick with a caller-supplied fabric step (the wire
        pump's ring -> device -> ring dispatch). Same agreement as
        tick(); returns ``LockstepDriver._STOPPED`` once the fleet agreed
        to stop, else ``fabric_fn(tick)``'s result (None when the step
        was skipped). fabric_fn MUST issue the identical collective
        sequence on every process.

        ``has_work``: this host's local signal (pending frames). The
        gather carries it, and when the WHOLE fleet is idle every
        process skips the fabric step on the same tick."""
        seen = np.int32([int(self.store.get(self.req_key) or 0),
                         int(self.store.get(self.stop_key) or 0),
                         int(bool(has_work))])
        gathered = process_allgather(seen).reshape(-1, 3)
        agreed_req = int(gathered[:, 0].min())
        agreed_stop = int(gathered[:, 1].min())
        fleet_has_work = bool(gathered[:, 2].max())
        if agreed_stop > self._stop_base:
            return self._STOPPED
        pending_commit = agreed_req > self.applied
        if pending_commit:
            self.cluster.publish()
            self.applied = agreed_req
        self.ticks += 1
        out = None
        # a commit tick always steps: in-flight state (sessions) must
        # advance onto the new epoch deterministically everywhere
        if fleet_has_work or pending_commit:
            out = fabric_fn(self.ticks)
        if self.expire_every and self.ticks % self.expire_every == 0:
            # lazy: the bulk pass is skipped only when the in-step sweep
            # has covered the whole ring since the last expiry; the
            # decision derives from the collective step counter and the
            # fleet-identical config, so no rank diverges on it
            self.cluster.expire_sessions(now=self.ticks, lazy=True)
        return out


class _LocalWireView:
    """Cluster-shaped LOCAL view for ClusterPump in multi-host mode.

    The pump stages and reads only THIS rank's mesh rows; ``step_wire``
    runs the COLLECTIVE wire step over them (a result holds them alone).
    ``now`` is set per tick by the runtime (the fleet-agreed tick, not
    wall clock)."""

    def __init__(self, mh: MultiHostCluster):
        self.mh = mh
        self.now = 0

    @property
    def n_nodes(self) -> int:
        return len(self.mh.local_nodes)

    @property
    def epoch(self) -> int:
        return self.mh.epoch

    @property
    def device(self) -> torch.device:
        return self.mh.device

    def step_wire(self, pkts: PacketVector, payload, now=None):
        return self.mh.step_wire(pkts, payload,
                                 now=self.now if now is None else now)


class MultiHostRuntime:
    """The DEPLOYABLE multi-host mesh: real ContivAgents per local node
    over a cross-process MultiHostCluster.

    One MultiHostRuntime per host (``vpp-tpu-torch-mesh-agent
    --coordinator ...``): each boots agents for the mesh rows its rank
    owns; the agents' unchanged renderer / CNI / service / node-event
    commit paths STAGE into their node builders, and every commit is
    routed through ``LockstepDriver.request_commit`` (the swap
    delegate), so the publish happens on the next agreed tick. ONE tick
    thread issues every collective (the driver's agreements, the
    publishes, the fabric steps, the aging); collectives self-
    synchronise, so the fleet runs at the slowest host's pace.

    Cross-process peer resolution rides the shared store: each agent
    publishes (allocator node id -> mesh position) under ``POS_PREFIX``
    and the resolver reads peers' entries, so node events on ANY host
    produce fabric routes toward the right mesh row.

    A failed tick (a collective that raised) halts the fabric: the
    runtime asks its peers to stop, records the error in ``failed`` and
    sets ``halted`` (as it does when the fleet agrees to stop); the
    mesh agent then exits nonzero.
    """

    POS_PREFIX = "/mesh/pos/"

    def __init__(self, n_nodes: int, base_config, rule_shards: int = 1,
                 store=None, tick_interval: float = 0.02,
                 frame_n: int = 256,
                 on_result: Optional[Callable] = None, device=None):
        from vpp_tpu_torch.cmd.agent import ContivAgent
        from vpp_tpu_torch.kvstore.client import connect_store
        from vpp_tpu_torch.parallel.runtime import _node_config

        if store is None:
            if not base_config.store_url:
                raise ValueError(
                    "multi-host mesh requires store_url (a kvstore "
                    "shared by every host)")
            store = connect_store(base_config.store_url,
                                  persist_path=base_config.persist_path)
        self.store = store
        self.cluster = MultiHostCluster(n_nodes, base_config.dataplane,
                                        rule_shards, device=device)
        self.n_nodes = n_nodes
        self.driver = LockstepDriver(self.cluster, store)
        self.tick_interval = tick_interval
        self.frame_n = frame_n
        self.on_result = on_result
        self.last_result: Optional[ClusterStepResult] = None
        self.failed: Optional[BaseException] = None
        self.halted = threading.Event()
        for i in self.cluster.local_nodes:
            self.cluster.node(i)._swap_delegate = self.driver.request_commit

        def resolver(nid: int) -> int:
            v = self.store.get(self.POS_PREFIX + str(int(nid)))
            return -1 if v is None else int(v)

        self.agents = []
        for i in self.cluster.local_nodes:
            agent = ContivAgent(_node_config(base_config, i), store=store,
                                dataplane=self.cluster.node(i),
                                mesh_node_resolver=resolver)
            agent._external_io = True  # no per-agent pump on node handles
            agent.mesh_runtime = self  # `show mesh` on any node's CLI
            self.store.put(self.POS_PREFIX + str(agent.node_id), i)
            self.agents.append(agent)
        self._frames_lock = threading.Lock()
        self._pending: Dict[int, list] = {
            i: [] for i in self.cluster.local_nodes}
        self._tick_thread: Optional[threading.Thread] = None
        self._watch_cancel: Optional[Callable[[], None]] = None
        # packet IO (io.enabled): per-LOCAL-node ring pairs + ONE
        # tick-driven ClusterPump over the local wire view; the fabric
        # step is issued by the tick loop so it interleaves
        # deterministically with the driver's other collectives
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
                for i in self.cluster.local_nodes]
            self.wire_view = _LocalWireView(self.cluster)
            self.cluster_pump = ClusterPump(self.wire_view, self.ring_pairs,
                                            snap=io.snap,
                                            max_inflight=io.max_inflight)
            self.cluster_pump.step_when_idle = True
            self.cluster_pump.raise_on_error = True
            # fleet-agreed coalesce bucket: every host stages the SAME
            # shape every tick (ClusterPump.max_frames_per_ring)
            self.cluster_pump.max_frames_per_ring = 1
            for agent in self.agents:
                agent.io_pump = self.cluster_pump
            # one designated exporter: every agent exporting the SHARED
            # pump would overcount by n_local
            self.agents[0].stats.set_pump(self.cluster_pump)

    # --- traffic injection (tests / local IO front-ends) ---
    def inject(self, node: int, packets: Sequence[dict]) -> None:
        if self.cluster_pump is not None:
            # the io tick loop steps the WIRE pump, not _pending —
            # silently queueing here would blackhole forever
            raise RuntimeError(
                "inject() is for header-only mode; with io.enabled "
                "push wire frames into ring_pairs[i].rx instead")
        with self._frames_lock:
            self._pending[node].extend(packets)

    def _drain(self) -> List[list]:
        with self._frames_lock:
            out = [self._pending[i][:self.frame_n]
                   for i in self.cluster.local_nodes]
            for i in self.cluster.local_nodes:
                del self._pending[i][:self.frame_n]
            return out

    # --- lifecycle ---
    def _on_position(self, ev) -> None:
        """A mesh row published: every local agent re-asks its resolver
        for that peer (``ContivAgent.reresolve_peer``), since the peer's
        node event may have come first and left edge routes."""
        from vpp_tpu_torch.kvstore.store import Op

        if ev.op != Op.PUT:
            return
        try:
            nid = int(ev.key[len(self.POS_PREFIX):])
        except ValueError:
            return
        for agent in self.agents:
            if agent.node_id != nid:
                agent.reresolve_peer(nid)

    def start(self) -> "MultiHostRuntime":
        # before the agents start: a row published after an agent took
        # its peer's node event must still reach it
        self._watch_cancel = self.store.watch(self.POS_PREFIX,
                                              self._on_position)
        for agent in self.agents:
            agent.start()
        if self.cluster_pump is not None:
            # the wire step needs live tables and its captured program
            # BEFORE traffic; both are collectives, so every host runs
            # them here, in the same order, before the tick loop
            self.cluster.publish()
            self.cluster_pump.warm()
            self.cluster_pump.start(dispatch=False)  # writer only
        self._tick_thread = threading.Thread(
            target=self._loop, daemon=True, name="mh-tick")
        self._tick_thread.start()
        return self

    def _loop(self) -> None:
        stopped = LockstepDriver._STOPPED
        try:
            while True:
                if self.cluster_pump is not None:
                    def fabric(tick):
                        self.wire_view.now = tick
                        self.cluster_pump._dispatch_once()
                        return True

                    res = self.driver.tick_fabric(
                        fabric, has_work=self.cluster_pump.has_pending())
                    if res is stopped:
                        return
                else:
                    res = self.driver.tick(self._drain(), n=self.frame_n)
                    if res is None:
                        return  # fleet agreed to stop
                    self.last_result = res
                    if self.on_result is not None:
                        self.on_result(res)
                time.sleep(self.tick_interval)
        except Exception as e:  # noqa: BLE001 — recorded, then halted
            # a failed collective leaves the fleet out of step: there is
            # no local recovery. Record it, and ask the peers to stop
            # (helps any that have not yet entered this tick's
            # collectives; ones already inside are released by the
            # process group's timeout)
            log.exception("mesh tick failed; fabric halted")
            self.failed = e
            try:
                self.driver.request_stop()
            except Exception:  # noqa: BLE001 — the store may be gone too
                log.exception("could not ask the fleet to stop")
        finally:
            self.halted.set()

    def close(self, join_timeout: float = 60.0) -> None:
        if self._watch_cancel is not None:
            self._watch_cancel()
        if self._tick_thread is not None:
            self.driver.request_stop()
            self._tick_thread.join(timeout=join_timeout)
            if self._tick_thread.is_alive():
                # a dead peer strands our tick thread inside a
                # collective; nothing safe to do but report (process
                # exit reclaims it)
                log.error("tick thread did not stop (peer host down?)")
        pump_stopped = True
        if self.cluster_pump is not None:
            pump_stopped = self.cluster_pump.stop(join_timeout=30.0)
            # in multi-host io mode the TICK thread is the pump's
            # dispatcher: if it is still wedged in a collective (peer
            # down) it can resume into the rings later — freeing them
            # now would be a use-after-free into shared memory
            pump_stopped = pump_stopped and not (
                self._tick_thread is not None
                and self._tick_thread.is_alive())
        for agent in reversed(self.agents):
            agent.close()
        if self.ring_pairs is not None:
            if pump_stopped:
                for rings in self.ring_pairs:
                    rings.close(
                        unlink=bool(self.agents[0].config.io.shm_name))
            else:
                # a wedged writer still holds ring pointers (the same
                # policy as MeshRuntime and the agent's close)
                log.error("cluster pump did not stop; leaving rings "
                          "mapped")
