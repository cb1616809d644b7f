"""ContivAgent: the vswitch-node process, all plugins wired.

Reference analogs: flavors/contiv FlavorContiv.Inject
(contiv_flavor.go:102-191 — the DI graph of ~20 plugins) and
cmd/contiv-agent/main.go:28-49 (event loop + SIGTERM graceful close).

Startup order mirrors the reference's Init/AfterInit phases (SURVEY.md
§3.1): data store → node ID → IPAM → dataplane + renderers → policy/
service plugins → CNI server → watchers subscribed → first resync →
ready. The kvstore watch bridge is the cn-infra kvdbsync analog: KSR
writes `k8s/<type>/...` keys; the bridge deserializes model objects and
fans them out to the policy cache and service processor.

The port's copy of ``vpp_tpu/cmd/agent.py`` over the port's own
modules. The dataplane and the session-rule engine run on the card
(``device=None``; ``resolve_device`` raises without one) unless the
caller passes ``device="cpu"``. A ``tcp://`` ``store_url`` (one
endpoint, or a primary and its standbys) connects a ``RemoteKVStore``;
``cli_socket`` serves the debug CLI (``cli.py``) to
``vpp-tpu-torch-ctl``; ``ml_model_path`` publishes an artifact through
``MlModelSource``. With a remote store, watch events reach the agent on
the client's dispatcher thread, the CLI serves on its transport's
threads and the maintenance thread steps: each touches the dataplane
through its device (never a thread's current device) and under its
``_lock``. ``io.control_socket`` drives the node's IO daemon
(``io/control.py``, its own process started by ``vpp-tpu-torch-init``):
CNI Adds wire veth pairs (``cni/wiring.py``), ``io.host_interconnect``
wires the host stack's veth, and the collector reads the daemon's
counters. ``vcl_socket`` serves the VCL admission socket
(``hoststack/admission.py``) over the agent's session-rule engine.

Mesh mode (parallel/runtime.py ``MeshRuntime``): ``dataplane`` injects a
cluster node handle, whose swap publishes the cluster epoch;
``mesh_node_resolver`` maps a peer's allocator node id to its mesh row,
so on-mesh peers route into the fabric (``node_id`` = the row, no
VXLAN next hop) and off-mesh peers get edge routes (``node_id`` -1);
the runtime sets ``mesh_runtime`` (``show mesh``) and ``_external_io``
(its ``ClusterPump`` bridges every node's rings, so the agent makes no
pump of its own).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Optional

from vpp_tpu_torch.agent import node_id as node_id_mod
from vpp_tpu_torch.agent.node_id import NodeIDAllocator
from vpp_tpu_torch.cni.containeridx import ContainerIndex
from vpp_tpu_torch.cni.server import RemoteCNIServer
from vpp_tpu_torch.cni.transport import CNITransportServer
from vpp_tpu_torch.cmd.config import AgentConfig
from vpp_tpu_torch.health.statuscheck import HealthHTTPServer, PluginState, StatusCheck
from vpp_tpu_torch.health.stn import STNDaemon
from vpp_tpu_torch.hoststack.session_rules import SessionRuleEngine
from vpp_tpu_torch.ipam.ipam import IPAM
from vpp_tpu_torch.ir.rule import PodID
from vpp_tpu_torch.ksr import model as m
from vpp_tpu_torch.kvstore.proxy import KVProxy
from vpp_tpu_torch.kvstore.store import Broker, KVEvent, KVStore, Op
from vpp_tpu_torch.net.linux import IpCmdError
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.tables import resolve_device
from vpp_tpu_torch.pipeline.vector import Disposition
from vpp_tpu_torch.policy import PolicyCache, PolicyConfigurator, PolicyProcessor
from vpp_tpu_torch.renderer.tpu import TpuRenderer
from vpp_tpu_torch.renderer.vpptcp import VpptcpRenderer
from vpp_tpu_torch.service import ServiceConfigurator, ServiceProcessor
from vpp_tpu_torch.stats.collector import StatsCollector, register_control_plane_metrics
from vpp_tpu_torch.stats.prometheus import StatsHTTPServer
from vpp_tpu_torch.trace import spans

log = logging.getLogger("vpp_tpu_torch.agent")

# KSR publishes under this store prefix (the reference's
# /vnf-agent/contiv-ksr/ microservice-label prefix,
# flavors/contiv/contiv_flavor.go:129-138).
KSR_PREFIX = "ksr/"


def _ksr_key(ev_key: str) -> str:
    """Strip the KSR store prefix off a watched key for parse_key()."""
    return ev_key[len(KSR_PREFIX):] if ev_key.startswith(KSR_PREFIX) else ev_key


class ContivAgent:
    def __init__(self, config: Optional[AgentConfig] = None,
                 store: Optional[KVStore] = None,
                 dataplane=None, device=None, mesh_node_resolver=None):
        """``store`` injection lets tests (and multi-agent simulations)
        share one in-memory store; production passes None and gets the
        configured backend — a RemoteKVStore against the cluster's
        KVServer when ``store_url`` is set (the deployed-etcd analog),
        else a persisted local store.

        ``device`` places the dataplane and the session-rule engine:
        None is the card (raises without one), ``"cpu"`` runs the plain
        versions; an injected ``dataplane`` brings its own.

        ``dataplane`` injection is the mesh-mode path (a cluster node
        handle); ``mesh_node_resolver`` maps a peer's allocator node id
        to its mesh row, -1 off the mesh (module doc)."""
        self.config = config or AgentConfig()
        c = self.config
        self.mesh_node_resolver = mesh_node_resolver
        # the card, or the CPU when asked: resolved before the store
        # sees this node, so an agent without a card leaves no trace
        self.device = (dataplane.device if dataplane is not None
                       and device is None else resolve_device(device))

        # --- data store + proxy (cn-infra kvdbsync analog) ---
        if store is None:
            from vpp_tpu_torch.kvstore.client import connect_store

            store = connect_store(c.store_url, persist_path=c.persist_path)
        self.store = store
        self.proxy = KVProxy(self.store)
        self._watch_cancels = []

        # --- statuscheck ---
        self.statuscheck = StatusCheck()
        self._report_core = self.statuscheck.register("core")
        self._report_policy = self.statuscheck.register("policy")
        self._report_service = self.statuscheck.register("service")

        # --- node identity + IPAM ---
        self.node_allocator = NodeIDAllocator(
            self.store, c.node_name,
            liveness_ttl_s=c.node_liveness_ttl_s)
        self.node_id = self.node_allocator.get_or_allocate()
        broker = Broker(self.store, f"agent/{c.node_name}/")
        self.ipam = IPAM(self.node_id, c.ipam, broker=broker)

        # --- data plane + renderers ---
        self.dataplane = (dataplane if dataplane is not None
                          else Dataplane(c.dataplane, device=self.device))
        # api-trace: enabled BEFORE any staging so the journal opens with
        # this agent's base vswitch config and replays to identical
        # tables (reference contiv-vswitch.conf:13-15 `api-trace { on }`)
        if c.txn_journal_path:
            self.dataplane.enable_journal(c.txn_journal_path)
            self.dataplane.builder.txn_label = "base-vswitch-config"
        self.uplink_if = self.dataplane.add_uplink()
        self.host_if = self.dataplane.add_host_interface()
        self.dataplane.set_vtep(int(self.ipam.vxlan_ip_address()))
        # Cluster-egress: default route out the uplink, source-NAT'd to
        # the node IP so external replies return through this node
        # (reference: service configurator SNAT pool for traffic leaving
        # the cluster, configurator_impl.go:258-264). Staged here,
        # published by start()'s base-config swap.
        from vpp_tpu_torch.pipeline.vector import ip4

        self.dataplane.builder.add_route(
            "0.0.0.0/0", self.uplink_if, Disposition.REMOTE, snat=True
        )
        # Cluster-internal subnets must never leak out the SNAT egress:
        # a drop route for the whole pod/host supernets that per-peer
        # routes (longest prefix) override — traffic to a removed node
        # drops instead of escaping NAT'd (reference: only pod-external
        # traffic hits the SNAT pool).
        self.dataplane.builder.add_route(
            str(self.ipam.pod_subnet), -1, Disposition.DROP
        )
        self.dataplane.builder.add_route(
            str(self.ipam.vpp_host_subnet), -1, Disposition.DROP
        )
        if c.io.host_interconnect and c.io.control_socket:
            # this node's own host-interconnect /24 punts to the host
            # stack (longest prefix wins over the supernet drop above)
            # — the routesToHost analog (host.go:92-110). Gated on the
            # interconnect actually being wired: without a host
            # transport these flows must stay attributed FIB drops, not
            # phantom punts that die in tx dispatch
            self.dataplane.builder.add_route(
                str(self.ipam.vpp_host_network), self.host_if,
                Disposition.HOST
            )
        self.dataplane.builder.set_snat_ip(
            ip4(str(self.ipam.node_ip_address()))
        )
        self.tpu_renderer = TpuRenderer(self.dataplane)
        self.session_engine = SessionRuleEngine(
            device=self.dataplane.device)
        self.vpptcp_renderer = VpptcpRenderer(
            self.session_engine, self._pod_ns_index
        )

        # --- policy plugin (cache → processor → configurator) ---
        self.policy_cache = PolicyCache()
        self.policy_configurator = PolicyConfigurator(
            self.policy_cache,
            parallel_commits=c.parallel_renderer_commits,
        )
        self.policy_configurator.register_renderer(self.tpu_renderer)
        self.policy_configurator.register_renderer(self.vpptcp_renderer)
        self.policy_processor = PolicyProcessor(
            self.policy_cache, self.policy_configurator
        )

        # --- service plugin ---
        self.service_configurator = ServiceConfigurator(
            self.dataplane,
            node_ips=[str(self.ipam.node_ip_address())],
        )
        self.service_processor = ServiceProcessor(
            self.service_configurator, node_name=c.node_name
        )

        # --- CNI ---
        # pod wiring: with an IO-daemon control socket configured, CNI
        # Adds create real veth pairs and attach them to the daemon at
        # runtime (reference pod.go:262-452)
        wirer = None
        self.io_ctl = None
        if c.io.control_socket:
            from vpp_tpu_torch.cni.wiring import VethPodWirer
            from vpp_tpu_torch.io.control import IOControlClient

            self.io_ctl = IOControlClient(c.io.control_socket)
            wirer = VethPodWirer(
                self.io_ctl, gateway_ip=str(self.ipam.pod_gateway_ip())
            )
        # VPP↔host interconnect (host.go:105-200): wired in start()
        # once the IO daemon serves the control socket
        self.host_interconnect = None
        if c.io.host_interconnect and self.io_ctl is not None:
            from vpp_tpu_torch.cni.wiring import HostInterconnectWirer

            self.host_interconnect = HostInterconnectWirer(
                self.io_ctl, self.ipam
            )
        self.container_index = ContainerIndex(broker)
        self.cni_server = RemoteCNIServer(
            self.dataplane, self.ipam, self.container_index,
            on_pod_change=self._on_local_pod_change,
            wirer=wirer,
        )
        self.cni_transport: Optional[CNITransportServer] = None
        self.cli_transport: Optional[CNITransportServer] = None
        self.vcl_admission = None  # VclAdmissionServer when vcl_socket set
        self.mesh_runtime = None   # set by MeshRuntime (show mesh)

        # --- crash-consistent session snapshot/restore (ISSUE 8) ---
        # a mesh node handle's sessions belong to the cluster epoch
        self.snapshotter = None
        if c.snapshot_path and self.dataplane.tables is not None:
            from vpp_tpu_torch.pipeline.snapshot import SessionSnapshotter

            self.snapshotter = SessionSnapshotter(
                self.dataplane, c.snapshot_path,
                chunk_buckets=c.snapshot_chunk_buckets,
                pace_s=c.snapshot_pace_s,
            )

        # --- per-packet ML model source (ml/loader.py) ---
        # only with the stage configured on and a standalone dataplane
        self.ml_source = None
        if (c.ml_model_path
                and getattr(c.dataplane, "ml_stage", "off") != "off"
                and self.dataplane.tables is not None):
            from vpp_tpu_torch.ml.loader import MlModelSource

            self.ml_source = MlModelSource(self.dataplane,
                                           c.ml_model_path)

        # --- observability ---
        self.stats = StatsCollector(self.dataplane, self.container_index)
        # degraded-mode surface: kvstore reachability/staleness +
        # snapshot age/outcomes ride the same registry
        self.stats.set_store(self.store)
        if self.snapshotter is not None:
            self.stats.set_snapshotter(self.snapshotter)
        if self.ml_source is not None:
            self.stats.set_ml(self.ml_source)
        # control-plane latency histograms: propagation SLO + txn commit
        # observed at the epoch swap, CNI add/del at the CNI server
        self.cp_metrics = register_control_plane_metrics(self.stats.registry)
        self.dataplane.propagation_hist = self.cp_metrics["config_propagation"]
        self.dataplane.txn_commit_hist = self.cp_metrics["txn_commit"]
        self.cni_server.duration_hist = self.cp_metrics["cni_request"]
        self.stats_http: Optional[StatsHTTPServer] = None
        self.health_http: Optional[HealthHTTPServer] = None

        # --- STN bootstrap (contiv-init analog) ---
        self.stn: Optional[STNDaemon] = None

        # --- packet IO (rings + pump, created in start() when enabled) ---
        self.io_rings = None
        self.io_pump = None
        # mesh mode: the MeshRuntime's ClusterPump bridges every node's
        # rings; this agent makes no pump of its own
        self._external_io = False

        # peers with installed routes: node_id -> peer vtep ip
        self._peer_routes = {}
        self._closed = threading.Event()
        self._maint_thread: Optional[threading.Thread] = None
        # session idle timeout in clock ticks; None = the dataplane
        # config's sess_max_age (wall-clock based — the VPP session/NAT
        # timer analog; lookups also enforce it in-kernel)
        self.session_max_age = None

    # --- contiv.API analogs ---
    def _pod_ns_index(self, pod: PodID) -> int:
        """GetNsIndex analog: a pod's app-namespace index is its
        dataplane interface index (unique per pod on this node)."""
        return self.dataplane.pod_if.get(pod, -1)

    def _on_local_pod_change(self) -> None:
        """A pod was wired/unwired by CNI: re-render policies (the
        reference reacts to the ETCD echo; we shortcut in-process)."""
        self.policy_processor.resync()

    # --- lifecycle ---
    def start(self, netlink_backend=None) -> None:
        c = self.config
        # STN bootstrap (contiv-init main.go:66-119): steal the
        # configured NIC before bringing up the data plane's uplink path
        if c.stn_interface and netlink_backend is not None:
            self.stn = STNDaemon(
                netlink_backend, persist_path=c.stn_persist_path
            )
            self.stn.steal(c.stn_interface)
        # multi-tenant gateway mode (ISSUE 14; vpp_tpu/tenancy/):
        # stage the configured tenants BEFORE the base swap so the
        # first epoch already derives/slices/limits per tenant —
        # entries were validated at config load
        if c.tenants:
            for e in c.tenants:
                kw = {k: v for k, v in e.items() if k != "id"}
                self.dataplane.builder.set_tenant(e["id"], **kw)
        # publish the base vswitch config (uplink/host interfaces staged
        # in __init__) before anything can send through those interfaces
        # — configureVswitchConnectivity's final txn in the reference
        self.dataplane.swap()
        # warm restart (ISSUE 8): adopt the last crash-consistent
        # session snapshot generation BEFORE any traffic, so
        # established flows (and the fastpath hit rate) survive the
        # restart; a refusal (torn/corrupt/geometry) cold-starts
        # cleanly and the outcome counter says why
        if self.snapshotter is not None:
            try:
                if self.snapshotter.restore_into():
                    log.info("session table restored warm from %s",
                             c.snapshot_path)
            except Exception:
                log.exception("session restore failed (cold start)")
        # initial ML model publish: before traffic, so the first
        # packets already score; a refusal is a counted outcome and the
        # stage stays off until a good load lands
        if self.ml_source is not None:
            self.ml_source.poll()
        # packet-IO front-end: shared-memory rings + the dataplane pump
        # (the vpp-tpu-torch-io daemon attaches to the same shm and
        # owns the NIC/TAP endpoints). Created before the
        # CNI resync: resync re-attaches pod veths through the daemon's
        # control socket and those packets land in these rings.
        if c.io.enabled and not self._external_io:
            from vpp_tpu_torch.io.pump import DataplanePump
            from vpp_tpu_torch.io.rings import IORingPair

            self.io_rings = IORingPair(
                n_slots=c.io.n_slots, snap=c.io.snap,
                shm_name=c.io.shm_name or None, create=True,
            )
            # reflex-plane latency governor + priority lane (ISSUE
            # 13; io/governor.py): built only when configured — an
            # SLO of 0 keeps the open-loop pump, and the priority
            # lane works with or without the governor
            governor = None
            if c.io.latency_slo_us > 0:
                from vpp_tpu_torch.io.governor import LatencyGovernor

                governor = LatencyGovernor(
                    c.io.latency_slo_us,
                    tick_s=c.io.governor_tick_s,
                    hysteresis_pct=c.io.governor_hysteresis_pct,
                    brownout_ticks=c.io.governor_brownout_ticks,
                    recover_ticks=c.io.governor_recover_ticks,
                )
            priority = None
            if (c.io.priority_ports or c.io.priority_prefixes
                    or c.io.priority_protos):
                from vpp_tpu_torch.io.governor import PriorityFilter

                priority = PriorityFilter(
                    ports=c.io.priority_ports,
                    prefixes=c.io.priority_prefixes,
                    protos=c.io.priority_protos,
                )
            # tenant lanes (ISSUE 14): the pump's weighted-fair
            # classifier mirrors the staged tenant registry (same
            # prefixes/weights/VNIs the device derivation uses)
            tenant_cls = None
            if c.tenants:
                from vpp_tpu_torch.tenancy.sched import TenantClassifier

                tenant_cls = TenantClassifier(c.tenants)
            self.io_pump = DataplanePump(
                self.dataplane, self.io_rings,
                max_batch=c.io.max_batch, depth=c.io.depth,
                workers=c.io.workers,
                max_inflight=c.io.max_inflight,
                fetch_workers=c.io.fetch_workers,
                chain_k=c.io.chain_k,
                mode=c.io.pump_mode,
                ring_slots=c.io.io_ring_slots,
                ring_windows=c.io.io_ring_windows,
                ring_fault_limit=c.io.io_ring_fault_limit,
                governor=governor,
                priority=priority,
                tenants=tenant_cls,
                tenant_quantum=c.io.io_tenant_quantum,
                # ICMP errors (time-exceeded/unreachable) originate from
                # the node's pod gateway address — the hop traceroute
                # shows (reference: VPP ip4-icmp-error)
                icmp_src_ip=(int(self.ipam.pod_gateway_ip())
                             if c.io.icmp_errors else 0),
            )
            # warm every dispatch bucket rung before serving — a lazy
            # mid-traffic rung compile would stall the rx rings
            t0 = time.monotonic()
            rungs = self.io_pump.warm()
            log.info("pump dispatch rungs %s warmed in %.1fs",
                     rungs, time.monotonic() - t0)
            self.io_pump.start()
        if c.io.enabled and c.io.plan_path:
            # vpp-tpu-init waits for this file to launch the node's
            # vpp-tpu-io daemon
            self._write_io_plan()
        if self.io_pump is not None and not self._external_io:
            # export pump counters over Prometheus (the shared
            # ClusterPump's from one collector only: MeshRuntime)
            self.stats.set_pump(self.io_pump)
        if self.io_ctl is not None:
            # the rx_full drop cause is counted in the IO daemon (a
            # separate process): feed its stats over the control
            # socket so vpp_tpu_pump_drops_total{reason="rx_full"}
            # reports real overflow, not a structural 0. A dedicated
            # SHORT-timeout client: the scrape path must not inherit
            # the control client's 10 s budget when the daemon wedges
            # (the collector additionally caches + backs off).
            from vpp_tpu_torch.io.control import IOControlClient as _IoCtl

            self.stats.set_io_daemon(
                _IoCtl(c.io.control_socket, timeout=0.5).stats)
        if self.host_interconnect is not None:
            # vpp-tpu-torch-init only STARTS the IO daemon after it sees
            # the plan file written above, so on a cold boot the control
            # socket appears a moment later — wait for it instead of
            # losing the race (CNI pod wiring never hits this because
            # Adds arrive only once the daemon is up)
            deadline = time.monotonic() + 60.0
            while True:
                try:
                    self.host_interconnect.wire(self.host_if)
                    break
                except IpCmdError:
                    # ip(8)/daemon command failures are permanent
                    # (missing CAP_NET_ADMIN, EEXIST, ...) — retrying
                    # them only re-runs wire()'s create+rollback for a
                    # minute; surface immediately
                    raise
                except OSError:
                    # the boot race this wait exists for: control
                    # socket not yet bound (FileNotFoundError /
                    # ConnectionRefusedError)
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.5)
            log.info("host interconnect wired (%s <-> %s)",
                     self.host_interconnect.host_end,
                     self.host_interconnect.vsw_end)
        # resync persisted pods before serving (restart path)
        n = self.cni_server.resync()
        if n:
            log.info("resynced %d persisted pods", n)
        self._subscribe_watchers()
        # first resync: replay existing KSR state from the store through
        # the same handlers — the watch bridge only sees future events,
        # but KSR typically reflected pods/policies/services before this
        # agent (re)started (the reference's startup resync, SURVEY §3.1)
        self._resync_from_store()
        # node events: learn peers that registered before we started
        # (node_events.go resync), then publish our own IPs for them.
        # Only LIVE peers (current liveness lease): allocatedIDs claims
        # deliberately survive crashes for ID reuse, so routing from
        # them would resurrect routes to dead nodes that lease expiry
        # already tore down on everyone else.
        for node_id, info in self.node_allocator.list_live_nodes().items():
            self._apply_node(node_id, info)
        self.node_allocator.publish_ips(
            str(self.ipam.node_ip_address()),
        )
        # lease-attached liveness: if this agent dies without cleanup,
        # the lease expires server-side and every peer's liveness watch
        # removes its routes to us (VERDICT r2 Next #8)
        try:
            self.node_allocator.publish_liveness(
                str(self.ipam.node_ip_address())
            )
        except Exception:
            log.exception("liveness publish failed (continuing)")
        self.cni_server.set_ready()
        if c.vcl_socket:
            # the ldpreload endpoint: unmodified apps launched with
            # vcl_env() get session-rule admission on every
            # connect()/accept() against this node's session rules
            # (reference: VCL ldpreload, tests/ld_preload*). A policy
            # endpoint, not observability — independent of serve_http.
            from vpp_tpu_torch.hoststack.admission import VclAdmissionServer

            self.vcl_admission = VclAdmissionServer(
                self.session_engine, c.vcl_socket
            ).start()
            self.stats.set_vcl(self.vcl_admission)
        if c.serve_http:
            self.cni_transport = CNITransportServer(
                c.cni_socket, self.cni_server.dispatch
            )
            self.cni_transport.start()
            self.stats_http = StatsHTTPServer(
                self.stats.registry, port=c.stats_port, host=c.http_host
            )
            # debug surface next to the scrape paths: span timelines and
            # the txn journal with per-stage timings (both JSON; the
            # CLI's `show spans` / `show config-history` render the
            # same data for humans). `/` indexes everything served.
            self.stats_http.add_page("/debug/spans", self.debug_spans_json)
            self.stats_http.add_page("/debug/txns", self.debug_txns_json)
            self.stats_http.add_page("/debug/jit", self.debug_jit_json)
            self.stats_http.start()
            self.health_http = HealthHTTPServer(
                self.statuscheck, port=c.health_port, host=c.http_host
            )
            self.health_http.start()
            if c.cli_socket:
                self._serve_cli(c.cli_socket)
        self._report_core(PluginState.OK)
        self._report_policy(PluginState.OK)
        self._report_service(PluginState.OK)
        if c.serve_http:
            self._maint_thread = threading.Thread(
                target=self._maintenance_loop, daemon=True,
                name="agent-maintenance",
            )
            self._maint_thread.start()

    def _serve_cli(self, path: str) -> None:
        """The vppctl transport: one-shot debug commands against the
        RUNNING agent (``vpp-tpu-torch-ctl "show interface"`` ...), each
        answered on the transport's thread; every read of a live plane
        and every probe runs under the dataplane's ``_lock``."""
        from vpp_tpu_torch.cli import DebugCLI
        from vpp_tpu_torch.cni.transport import cni_call

        # `vpp-tpu-torch-ctl trace add N` lazily attaches the packet
        # tracer to the dataplane; disarmed it is an early return per
        # step
        cli = DebugCLI(
            self.dataplane, stats=self.stats, pump=self.io_pump,
            io_ctl=self.io_ctl,
            session_engine=self.session_engine, store=self.store,
            snapshotter=self.snapshotter, ml_source=self.ml_source,
            mesh_runtime=self.mesh_runtime,
        )

        def _cli_dispatch(method: str, params: dict) -> dict:
            if method != "run":
                return {"result": 1, "error": f"unknown method {method!r}"}
            try:
                return {"result": 0,
                        "output": cli.run(str(params.get("line", "")))}
            except Exception as e:  # noqa: BLE001 — debug path
                return {"result": 1, "error": f"{type(e).__name__}: {e}"}

        # the transport unlinks an existing socket on bind, so a path
        # collision would silently STEAL another live agent's CLI
        # socket — probe first and refuse instead
        live = False
        try:
            cni_call(path, "run", {"line": "help"}, timeout=1.0)
            live = True
        except TimeoutError:
            # connected but no answer within the window: a LIVE but busy
            # agent (e.g. mid-capture holding the dataplane lock) —
            # refuse takeover; only connection-refused/absent is stale
            live = True
        except (OSError, RuntimeError, ValueError):
            pass  # nothing answering: stale or absent socket
        if live:
            log.warning("cli socket %s already served by a live agent; "
                        "not taking it over", path)
            return
        try:
            self.cli_transport = CNITransportServer(path, _cli_dispatch)
            self.cli_transport.start()
        except OSError as e:
            # a debug convenience must never take the node's data plane
            # down with it
            log.warning("cli socket %s unavailable: %s", path, e)
            self.cli_transport = None

    def _write_io_plan(self) -> None:
        """Publish the IO-daemon launch plan (ring geometry, interface
        indices, overlay parameters) once the shm rings exist —
        vpp-tpu-init waits for this file and starts vpp-tpu-io with
        matching flags (the supervised-start handshake of the
        reference's contiv-init, main.go:201-273)."""
        import json as _json
        import os as _os

        c = self.config
        plan = {
            "shm": c.io.shm_name,
            "slots": c.io.n_slots,
            "snap": c.io.snap,
            "uplink_if": self.uplink_if,
            "host_if": self.host_if,
            "uplink_interface": c.io.uplink_interface,
            "vtep": int(self.ipam.vxlan_ip_address()),
            "vni": c.io.vni,
            "control_socket": c.io.control_socket,
        }
        _os.makedirs(_os.path.dirname(c.io.plan_path) or ".",
                     exist_ok=True)
        tmp = c.io.plan_path + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(plan, f)
        _os.replace(tmp, c.io.plan_path)

    # --- debug pages (served by the stats HTTP server) ---
    @staticmethod
    def debug_spans_json() -> str:
        """/debug/spans: recorded span timelines grouped by trace."""
        return spans.RECORDER.to_json()

    @staticmethod
    def debug_jit_json() -> str:
        """/debug/jit: the capture guard's full state — per (step part,
        table signature) capture counts and the recaptures (the
        scrapeable twin of ``vpp_tpu_jit_compiles_total`` with the
        shape axis kept). A captured step program is the port's
        counterpart of the reference's jit compile."""
        import json as _json

        from vpp_tpu_torch.pipeline.capture import (
            capture_counts,
            capture_totals,
        )

        counts = sorted(capture_counts().items())
        return _json.dumps({
            "totals": capture_totals(),
            "compiles": [
                {"step": label, "shapes": repr(sig), "count": n}
                for (label, sig), n in counts
            ],
            "recompiled": [
                {"step": label, "shapes": repr(sig), "count": n}
                for (label, sig), n in counts if n > 1
            ],
        }, indent=1)

    # /debug/txns tail cap: a long-lived agent's journal grows without
    # bound; the debug page serves the recent history, not an export
    DEBUG_TXNS_LIMIT = 200

    def debug_txns_json(self) -> str:
        """/debug/txns: journal tail (last DEBUG_TXNS_LIMIT entries,
        bounded tail read — never a full-file parse per scrape) joined
        with each applied txn's span timeline (per-stage exclusive
        seconds, keyed by swap epoch)."""
        import json as _json

        journal = self.dataplane.journal
        entries = (journal.load_tail_entries(self.DEBUG_TXNS_LIMIT)
                   if journal is not None else [])
        by_epoch = spans.RECORDER.epoch_timings()
        out = []
        for e in entries:
            epoch = e.get("epoch")
            trace_id, stages = by_epoch.get(epoch, (None, None))
            out.append({
                "epoch": epoch,
                "t": e.get("t"),
                "label": e.get("label", ""),
                "ops": len(e.get("ops", [])),
                "trace_id": trace_id,
                "stage_seconds": stages,
            })
        return _json.dumps({
            "applied": journal.applied if journal is not None else 0,
            "shown": len(entries),
            "torn_lines": journal.torn_lines if journal is not None else 0,
            "txns": out,
        })

    def maintenance_tick(self) -> None:
        """One round of periodic upkeep: age sessions, publish stats,
        poll health probes. Called by the background loop; callable
        directly in tests."""
        try:
            # lazy: when the in-step amortized sweep has cycled the
            # whole table since the last tick, the bulk pass is skipped
            # (steady-state aging rides the fused step); idle nodes
            # still reclaim here
            self.dataplane.expire_sessions(self.session_max_age,
                                           lazy=True)
        except Exception:
            log.exception("session expiry failed")
        try:
            # interval-paced incremental snapshot: dirty chunks drain
            # off the hot path on this maintenance thread (failures
            # mark the snapshotter degraded, never kill the tick —
            # the liveness keepalive below must always run). A
            # persistent-mode pump threads its session state privately
            # through the resident ring: graft a consistent copy into
            # dp.tables first, or the snapshot would capture the
            # launch-time state against an advancing clock.
            if self.snapshotter is not None and self.snapshotter.due(
                    self.config.snapshot_interval_s):
                # gated on the snapshot actually being due: the ring
                # checkpoint is a full device copy of the session
                # columns and must not run on every 5 s tick
                sync = getattr(self.io_pump, "sync_sessions", None)
                if callable(sync):
                    sync()
                self.snapshotter.maybe_snapshot(
                    self.config.snapshot_interval_s)
        except Exception:
            log.exception("session snapshot failed")
        try:
            # ML model hot reload: mtime-gated, so the tick is one
            # stat() in steady state; a refused artifact keeps the
            # previous model serving (counted, degraded{component=ml})
            if self.ml_source is not None:
                self.ml_source.poll()
        except Exception:
            log.exception("ml model poll failed")
        try:
            self.stats.publish()
        except Exception:
            log.exception("stats publish failed")
        try:
            self.statuscheck.run_probes()
        except Exception:
            log.exception("probe round failed")
        try:
            self.node_allocator.liveness_keepalive()
        except Exception:
            log.exception("liveness keepalive failed")
        # in-process stores have no server-side sweeper; expire overdue
        # leases here so liveness semantics hold in dev mode too
        sweep = getattr(self.store, "sweep_leases", None)
        if callable(sweep):
            try:
                sweep()
            except Exception:
                log.exception("lease sweep failed")

    def _maintenance_loop(self, interval: float = 5.0) -> None:
        while not self._closed.wait(interval):
            self.maintenance_tick()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for cancel in self._watch_cancels:
            cancel()
        for srv in (self.cni_transport, self.cli_transport,
                    self.stats_http, self.health_http):
            if srv is not None:
                srv.close()
        if self.vcl_admission is not None:
            self.vcl_admission.stop()
        self.proxy.close()
        pump_stopped = True
        if self.io_pump is not None and not self._external_io:
            # the shared ClusterPump's lifecycle is the MeshRuntime's
            pump_stopped = self.io_pump.stop(join_timeout=30.0)
        if self.io_rings is not None:
            if pump_stopped:
                self.io_rings.close(unlink=bool(self.config.io.shm_name))
            else:
                # A wedged pump still holds ring pointers; freeing the
                # buffers under it would be a use-after-free into shared
                # memory. Leak the mapping (process exit reclaims it).
                log.error("pump did not stop; leaving rings mapped")
        if self.host_interconnect is not None:
            try:
                self.host_interconnect.unwire(self.host_if)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.warning("host interconnect unwire failed")
        if self.stn is not None:
            self.stn.revert_all()
        if self.snapshotter is not None:
            # a clean shutdown's parting snapshot: the next start
            # restores the freshest possible generation — the pump
            # merged its final ring sessions into dp.tables above, and
            # final_snapshot waits out any maintenance drain still in
            # flight (which began from pre-merge state) before
            # draining once more (best effort — failures land in the
            # degraded counters)
            self.snapshotter.final_snapshot()
        if self.store.persist_path:
            self.store.save()

    # --- the kvdbsync watch bridge ---
    def _traced(self, kind: str, handler):
        """Wrap a watch handler in an "agent" dispatch span, joining the
        active config trace (or rooting one for out-of-band events)."""
        def dispatch(ev: KVEvent) -> None:
            with spans.RECORDER.span(
                "agent", f"dispatch {kind} {ev.key}", node=self.config.node_name,
            ):
                handler(ev)
        return dispatch

    def _subscribe_watchers(self) -> None:
        sub = self.proxy.watch
        traced = self._traced
        self._watch_cancels = [
            sub(KSR_PREFIX + m.key_prefix(m.Pod.TYPE),
                traced("pod", self._on_pod_event)),
            sub(KSR_PREFIX + m.key_prefix(m.Policy.TYPE),
                traced("policy", self._on_policy_event)),
            sub(KSR_PREFIX + m.key_prefix(m.Namespace.TYPE),
                traced("namespace", self._on_namespace_event)),
            sub(KSR_PREFIX + m.key_prefix(m.Service.TYPE),
                traced("service", self._on_service_event)),
            sub(KSR_PREFIX + m.key_prefix(m.Endpoints.TYPE),
                traced("endpoints", self._on_endpoints_event)),
            sub(node_id_mod.ID_PREFIX,
                traced("node", self._on_node_event)),
            sub(node_id_mod.LIVENESS_PREFIX,
                traced("liveness", self._on_liveness_event)),
        ]

    def _resync_from_store(self) -> None:
        handlers = {
            m.Pod.TYPE: self._on_pod_event,
            m.Namespace.TYPE: self._on_namespace_event,
            m.Policy.TYPE: self._on_policy_event,
            m.Service.TYPE: self._on_service_event,
            m.Endpoints.TYPE: self._on_endpoints_event,
        }
        for obj_type, handler in handlers.items():
            prefix = KSR_PREFIX + m.key_prefix(obj_type)
            for key, value in self.store.list_values(prefix).items():
                handler(KVEvent(op=Op.PUT, key=key, value=value,
                                prev_value=None, rev=0))

    # --- node events (plugins/contiv/node_events.go:34,184-252) ---
    def _on_node_event(self, ev: KVEvent) -> None:
        try:
            node_id = int(ev.key[len(node_id_mod.ID_PREFIX):])
        except ValueError:
            return
        if node_id == self.node_id:
            return
        if ev.op == Op.PUT:
            self._apply_node(node_id, ev.value or {})
        else:
            self._remove_node(node_id)

    def _on_liveness_event(self, ev: KVEvent) -> None:
        """A peer's lease-attached liveness key changed. DELETE (lease
        expiry = crash/partition, or clean shutdown) tears down our
        routes toward it; PUT (node back) reinstalls them."""
        try:
            node_id = int(ev.key[len(node_id_mod.LIVENESS_PREFIX):])
        except ValueError:
            return
        if node_id == self.node_id:
            return
        if ev.op == Op.PUT:
            self._apply_node(node_id, ev.value or {})
        else:
            self._remove_node(node_id)

    def _apply_node(self, node_id: int, info: dict) -> None:
        """Install routes to another node's pod + vpp/host subnets over
        the uplink. Mesh mode (a resolver set): on-mesh peers route into
        the fabric (``node_id`` = the mesh row, next hop 0, so the host's
        VXLAN encap leaves them alone) and off-mesh peers get edge
        routes (``node_id`` -1); otherwise every peer is a VXLAN peer
        (the reference's full-mesh, node_events.go:184-250)."""
        if node_id == self.node_id or not isinstance(info, dict):
            return
        peer_vtep = int(self.ipam.vxlan_ip_address(node_id))
        if self._peer_routes.get(node_id) == peer_vtep:
            return  # already installed (IP update without vtep change)
        mesh_pos = -1
        if self.mesh_node_resolver is not None:
            mesh_pos = int(self.mesh_node_resolver(node_id))
        if mesh_pos >= 0:
            with_hop = dict(tx_if=self.uplink_if,
                            disposition=Disposition.REMOTE, next_hop=0,
                            node_id=mesh_pos)
        else:
            with_hop = dict(
                tx_if=self.uplink_if,
                disposition=Disposition.REMOTE,
                next_hop=peer_vtep,
                # edge peers are -1 on a mesh (an allocator id would
                # alias a fabric row); standalone, the allocator id as
                # observability metadata
                node_id=-1 if self.mesh_node_resolver is not None
                else node_id,
            )
        with self.dataplane.commit_lock:
            self.dataplane.builder.txn_label = f"node-event add {node_id}"
            self.dataplane.builder.add_route(
                str(self.ipam.other_node_pod_network(node_id)), **with_hop
            )
            self.dataplane.builder.add_route(
                str(self.ipam.other_node_vpp_host_network(node_id)), **with_hop
            )
            self.dataplane.swap()
        self._peer_routes[node_id] = peer_vtep
        log.info("node %d added: %s", node_id,
                 f"fabric row {mesh_pos}" if mesh_pos >= 0
                 else f"routes via vtep {peer_vtep}")

    def _remove_node(self, node_id: int) -> None:
        if self._peer_routes.pop(node_id, None) is None:
            return
        with self.dataplane.commit_lock:
            self.dataplane.builder.txn_label = f"node-event del {node_id}"
            self.dataplane.builder.del_route(
                str(self.ipam.other_node_pod_network(node_id))
            )
            self.dataplane.builder.del_route(
                str(self.ipam.other_node_vpp_host_network(node_id))
            )
            self.dataplane.swap()
        log.info("node %d removed", node_id)

    def _on_pod_event(self, ev: KVEvent) -> None:
        try:
            if ev.op == Op.PUT:
                self.policy_cache.update_pod(m.Pod.from_dict(ev.value))
            else:
                k = m.parse_key(_ksr_key(ev.key))
                self.policy_cache.delete_pod(
                    PodID(k.get("namespace", "default"), k["name"])
                )
        except Exception:
            log.exception("pod event failed: %s", ev.key)
            self._report_policy(PluginState.ERROR, f"pod event {ev.key}")

    def _on_policy_event(self, ev: KVEvent) -> None:
        try:
            if ev.op == Op.PUT:
                self.policy_cache.update_policy(m.Policy.from_dict(ev.value))
            else:
                k = m.parse_key(_ksr_key(ev.key))
                self.policy_cache.delete_policy(
                    k.get("namespace", "default"), k["name"]
                )
        except Exception:
            log.exception("policy event failed: %s", ev.key)
            self._report_policy(PluginState.ERROR, f"policy event {ev.key}")

    def _on_namespace_event(self, ev: KVEvent) -> None:
        try:
            if ev.op == Op.PUT:
                self.policy_cache.update_namespace(
                    m.Namespace.from_dict(ev.value)
                )
            else:
                k = m.parse_key(_ksr_key(ev.key))
                self.policy_cache.delete_namespace(k["name"])
        except Exception:
            log.exception("namespace event failed: %s", ev.key)
            self._report_policy(PluginState.ERROR, f"namespace event {ev.key}")

    def _on_service_event(self, ev: KVEvent) -> None:
        try:
            if ev.op == Op.PUT:
                self.service_processor.update_service(
                    m.Service.from_dict(ev.value)
                )
            else:
                k = m.parse_key(_ksr_key(ev.key))
                self.service_processor.delete_service(
                    k.get("namespace", "default"), k["name"]
                )
        except Exception:
            log.exception("service event failed: %s", ev.key)
            self._report_service(PluginState.ERROR, f"service event {ev.key}")

    def _on_endpoints_event(self, ev: KVEvent) -> None:
        try:
            if ev.op == Op.PUT:
                self.service_processor.update_endpoints(
                    m.Endpoints.from_dict(ev.value)
                )
            else:
                k = m.parse_key(_ksr_key(ev.key))
                self.service_processor.delete_endpoints(
                    k.get("namespace", "default"), k["name"]
                )
        except Exception:
            log.exception("endpoints event failed: %s", ev.key)
            self._report_service(PluginState.ERROR, f"endpoints event {ev.key}")


def main(argv=None) -> int:
    """contiv-agent main: config flag, event loop, SIGTERM close. The
    dataplane runs on the card (without one the agent raises) unless
    ``--device cpu`` asks for the CPU."""
    import argparse

    from vpp_tpu_torch.cmd.config import load_config

    parser = argparse.ArgumentParser(prog="vpp-tpu-torch-agent")
    parser.add_argument("--config", default=None, help="agent YAML config")
    parser.add_argument("--device", default=None,
                        help="torch device of the dataplane (default: the "
                             "card)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    agent = ContivAgent(load_config(args.config), device=args.device)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    agent.start()
    log.info("agent up: node %s id %d", agent.config.node_name, agent.node_id)
    stop.wait()
    log.info("shutting down")
    agent.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
