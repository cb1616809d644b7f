"""Agent configuration: the contiv.yaml analog.

Reference: the contiv plugin Config struct + per-plugin YAML config
flags (plugin_impl_contiv.go:87-118, 361-378) injected via ConfigMap
(k8s/contiv-vpp.yaml:19-70). One YAML file configures the whole agent;
every field has a sane default so an empty file boots a dev node.

The port's copy of ``vpp_tpu/cmd/config.py``: the same keys, defaults
and load-time validation, over the port's own ``DataplaneConfig`` and
validators. One default differs: ``cli_socket`` is "" (the reference's
is ``/run/vpp-tpu/cli.sock``): an agent binds its CLI socket only where
the deployment names one, so an agent booted with the defaults writes
nothing outside its own paths.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from vpp_tpu_torch.ipam.ipam import IpamConfig
from vpp_tpu_torch.pipeline.tables import DataplaneConfig


@dataclasses.dataclass
class IOConfig:
    """Packet-IO front-end (the VPP-process analog): the agent owns the
    shared-memory frame rings + pump; the vpp-tpu-io daemon attaches by
    shm name and owns the NIC/TAP endpoints."""

    enabled: bool = False
    shm_name: str = ""                       # "" = in-process rings (dev)
    n_slots: int = 64
    snap: int = 2048                         # payload bytes kept per packet
    # IO-daemon control socket: when set, the CNI server wires pods with
    # real veth pairs and attaches them to the daemon at runtime
    # (io/control.py; reference remote_cni_server.go:895-1250)
    control_socket: str = ""
    # pump tuning (io/pump.py): coalesced device batch cap, in-flight
    # batches before the dispatch stage backpressures, concurrent
    # result fetchers (None = auto: 8 on a remote device so fetch RPC
    # round trips overlap, 1 on the CPU backend where extra blocked
    # threads only churn the GIL). ``depth``/``workers`` are the
    # legacy aliases of ``max_inflight``/``fetch_workers`` — the new
    # names win when both are set.
    max_batch: int = 2048
    depth: int = 8
    workers: int | None = None
    max_inflight: int | None = None
    fetch_workers: int | None = None
    # adaptive chainer: backlog past one full max_batch bucket folds
    # into ONE process_packed_chain dispatch of up to chain_k stacked
    # buckets (one device round trip for K buckets of traffic — the
    # bounded-sync lever for small frames / remote transports).
    # 0 disables; values round down to a power of two.
    chain_k: int = 4
    # "dispatch" (pipelined ladder, peak throughput) or "persistent"
    # (device-resident descriptor rings: the host ships whole windows
    # of compacted 20 B/pkt descriptors with one transfer each and the
    # device while_loop drains them without any io_callback — the
    # latency-floor regime; docs/IO_PATH.md + docs/LATENCY.md lever
    # #2/#7). Persistent mode disables ICMP error generation (side
    # programs would serialize behind the ring windows).
    pump_mode: str = "dispatch"
    # Persistent-mode device-ring geometry (io/rings.py DeviceDescRing;
    # both are CONFIG-STATIC SHAPE — part of the window program's
    # jit-cache key like dataplane.sess_ways, validated powers of two):
    #   io_ring_slots    frames (VEC-packet descriptor slots) per ring
    #                    window — one host↔device exchange serves this
    #                    many frames, so it divides the per-frame
    #                    dispatch/fetch overhead by io_ring_slots
    #   io_ring_windows  staging windows cycled in ring order (>= 2:
    #                    the double buffer that overlaps window N's tx
    #                    writeback with window N+1's rx refill)
    io_ring_slots: int = 8
    io_ring_windows: int = 2
    # Tenant WFQ service quantum (ISSUE 14; io/pump.py): cap in
    # PACKETS on one tenant's weighted-fair take. 0 = a full
    # slot/batch (the throughput shape). A WFQ delay bound scales
    # with quantum x active lanes, so a small quantum bounds how long
    # a light tenant's frame sits behind another tenant's bulk in the
    # shared window pipeline — more window exchanges per packet in
    # trade (the tenant_isolation_bench dial). Only meaningful with
    # tenants configured.
    io_tenant_quantum: int = 0
    # degraded-mode escape hatch (ISSUE 8; io/pump.py): after this many
    # resident-ring deaths the persistent pump stops relaunching the
    # device ring and falls back to the dispatch ladder (slower but
    # alive; vpp_tpu_degraded{component="ring"} flips). 0 = never fall
    # back: relaunch forever, paced by a jittered backoff.
    io_ring_fault_limit: int = 3
    # Reflex-plane latency governor (ISSUE 13; io/governor.py): an
    # explicit wire-latency SLO in microseconds closes the loop on the
    # pump's window shaping — the governor adapts window fill,
    # coalescing and in-flight depth between the 1-slot lone-frame
    # floor and the full backlog fill, and in brownout sheds bulk
    # admission as attributed drops_overload. 0 disables (open-loop
    # pump, the pre-13 behavior). Host-side only: governing never
    # traces a new step variant.
    latency_slo_us: int = 0
    # control-loop cadence and anti-oscillation guards (docs/LATENCY.md
    # round 13 has the control-law math): hysteresis_pct widens the
    # dead band below the SLO (no adjustment while p99 sits inside
    # it); brownout_ticks = consecutive over-SLO ticks with no step
    # left before shedding engages; recover_ticks = consecutive
    # under-band ticks per recovery step (slow up, fast down).
    governor_tick_s: float = 0.05
    governor_hysteresis_pct: float = 30.0
    governor_brownout_ticks: int = 3
    governor_recover_ticks: int = 5
    # Priority lane (ISSUE 13; io/governor.py PriorityFilter): flows
    # matching any rule are reflex traffic — they form their own
    # coalesce groups, preempt bulk ring windows, and are never shed.
    # ports match sport OR dport; prefixes (IPv4 CIDR strings) match
    # src OR dst; protos are IP protocol numbers. Runtime code can
    # additionally mark (src, dst) host pairs via
    # PriorityFilter.mark_flow — the hook an ML-mirror consumer would
    # use (not auto-wired yet; ROADMAP item 4).
    priority_ports: list = dataclasses.field(default_factory=list)
    priority_prefixes: list = dataclasses.field(default_factory=list)
    priority_protos: list = dataclasses.field(default_factory=list)
    # node uplink (vpp-tpu-init bootstrap; reference contiv-init
    # vppcfg.go:74-559): kernel NIC the IO daemon binds as the uplink
    uplink_interface: str = ""
    uplink_ip: str = ""                      # static CIDR; "" = none/DHCP
    uplink_dhcp: bool = False
    proxy_arp: bool = False
    vni: int = 10
    # generate ICMP time-exceeded / net-unreachable for attributed
    # drops (VPP ip4-icmp-error analog; traceroute shows the vswitch hop)
    icmp_errors: bool = True
    # wire the VPP↔host-stack interconnect veth on start (requires
    # control_socket; reference host.go:105-200): the node's own Linux
    # stack reaches pod/service IPs through the data plane
    host_interconnect: bool = False
    # handshake file the agent writes once rings exist so vpp-tpu-init
    # can start the IO daemon with matching geometry ("" = don't write)
    plan_path: str = ""


@dataclasses.dataclass
class MeshConfig:
    """Multi-chip mesh mode (vpp-tpu-mesh-agent / parallel/runtime.py):
    one process drives N vswitch nodes over a (node, rule) device mesh
    with the all_to_all ICI fabric as the inter-node data plane."""

    enabled: bool = False   # explicit mesh switch (nodes/coordinator/
                            # rule_shards>1 also imply it — needed for
                            # the auto-size nodes=0 form)
    nodes: int = 0          # mesh rows; 0 = one node per available device
                            # group (devices // rule_shards)
    rule_shards: int = 1    # global-ACL rule-axis shards per node
    # multi-host (DCN): set all three to span processes/hosts —
    # ``nodes`` then counts the WHOLE cluster's mesh rows and each
    # process boots agents for the rows its local devices own
    # (parallel/multihost.MultiHostRuntime). Requires store_url.
    coordinator: str = ""   # distributed coordinator host:port
    num_processes: int = 0
    process_id: int = -1


@dataclasses.dataclass
class AgentConfig:
    node_name: str = "node-1"
    # data store: "" = in-process store (dev/tests); "tcp://host:port" =
    # shared KVServer (the deployed-etcd analog, k8s/contiv-vpp.yaml:72-114)
    store_url: str = ""
    persist_path: Optional[str] = None       # in-process store snapshot file
    # CNI
    cni_socket: str = "/run/vpp-tpu/cni.sock"
    # debug CLI socket (the vppctl transport; "" disables)
    cli_socket: str = ""
    # VCL admission socket for the LD_PRELOAD session shim
    # (libvclshim.so answers its connect()/accept() checks here against
    # the node's session rules; "" disables)
    vcl_socket: str = ""
    # config transaction trace (api-trace analog): JSONL journal of every
    # NB commit the live agent applies; "" disables recording
    txn_journal_path: str = ""
    # crash-consistent session snapshot/restore (ISSUE 8;
    # pipeline/snapshot.py): directory for the chunked snapshot files +
    # manifest ("" disables). On start the agent restores the last
    # published generation (established flows — and the fastpath hit
    # rate — survive a restart warm); the maintenance loop then drains
    # dirty chunks every ``snapshot_interval_s``. ``chunk_buckets``
    # bounds one device→host transfer (power of two buckets of all
    # session columns per chunk — the ~1.1 GB 10M-slot table never
    # ships in one piece); ``snapshot_pace_s`` sleeps between chunk
    # drains so a full drain never monopolizes the transport.
    snapshot_path: str = ""
    snapshot_interval_s: float = 30.0
    snapshot_chunk_buckets: int = 4096
    snapshot_pace_s: float = 0.0
    # per-packet ML scoring stage (ISSUE 10; vpp_tpu/ml/): path of the
    # versioned model artifact (vpp_tpu_torch.ml.train emits it). Loaded at
    # start and re-loaded by the maintenance loop whenever the file's
    # mtime moves; a corrupt/mis-versioned artifact is REFUSED cleanly
    # (counted outcome, vpp_tpu_degraded{component="ml"}) and the
    # previous model keeps serving. Requires dataplane.ml_stage to be
    # "score" or "enforce" — with the stage "off" the path is ignored
    # (the glb_ml_* tables carry placeholder shapes). "" disables.
    ml_model_path: str = ""
    # node liveness lease TTL (the etcd-lease analog; peers drop a
    # node's routes when it expires). Raise where long jit compiles or
    # heavy host contention can starve the keepalive thread.
    node_liveness_ttl_s: float = 15.0
    # observability / health
    stats_port: int = 9999
    health_port: int = 9191
    http_host: str = "127.0.0.1"
    serve_http: bool = True                  # False in unit tests
    # STN bootstrap
    stn_interface: str = ""                  # "" = no NIC stealing
    stn_persist_path: Optional[str] = None
    # commit the independent renderers (TPU ACL + VPPTCP session) from
    # worker threads (reference's optional parallel renderer commit,
    # configurator_impl.go:211-233 / plugin_impl_policy.go:161)
    parallel_renderer_commits: bool = False
    # device tables sizing + the two-tier fast-path knobs
    # (``dataplane.fastpath``: enable the classify-free established-flow
    # dispatch, default on; ``dataplane.fastpath_min_rules``: engage it
    # only once the global ACL table holds at least this many rules —
    # below that the classifier is cheap and the dispatch buys nothing)
    # + the global-classify implementation selection
    # (``dataplane.classifier: dense|mxu|bv|auto`` with
    # ``classifier_bv_min_rules`` / ``classifier_bv_mem_mb`` gating the
    # auto ladder — docs/CLASSIFIER.md; re-evaluated at every epoch swap)
    # + the session-table geometry (docs/SESSIONS.md):
    #   ``dataplane.sess_slots``     total reflective-session slots
    #                                (power of two; 1<<24 ≈ 16.7M slots
    #                                serves 10M+ concurrent sessions)
    #   ``dataplane.sess_ways``      ways per set-associative bucket
    #                                (power of two, default 4)
    #   ``dataplane.natsess_slots``  NAT-session slots (0 = sess_slots)
    #   ``dataplane.sess_sweep_stride`` buckets aged per fused step by
    #                                the amortized on-device sweep
    #                                (power of two; 0 disables)
    # All four are validated at load (powers of two, divisibility) so a
    # bad value fails HERE with a clear message, not deep inside a jit
    # trace.
    # + the per-packet ML stage (docs/ML_STAGE.md):
    #   ``dataplane.ml_stage``   off | score | enforce — score marks/
    #                            counts only, enforce folds the model's
    #                            drop/ratelimit verdicts into the
    #                            pipeline (deny > ml-drop > permit)
    #   ``dataplane.ml_hidden``  MLP hidden-width capacity (shape)
    #   ``dataplane.ml_trees``/``ml_depth``  forest capacity (shape)
    # + the device-resident telemetry plane (docs/OBSERVABILITY.md
    #   "device telemetry"; ops/telemetry.py):
    #   ``dataplane.telemetry``  off | latency | full — "latency"
    #                            histograms per-packet wire latency
    #                            (rx-enqueue stamp → device tx-append)
    #                            in on-device log2 bins, "full" adds
    #                            the count-min heavy-hitter flow
    #                            sketch + top-K table behind `show
    #                            top-flows`; "off" compiles the plane
    #                            out at zero cost (placeholder shapes)
    #   ``dataplane.telemetry_lat_buckets``  log2 µs bins (4..31)
    #   ``dataplane.telemetry_sketch_rows``/``_sketch_cols``  count-min
    #                            depth d / width w (w a power of two;
    #                            overestimate bound ~ e·N/w with
    #                            failure probability e^-d)
    #   ``dataplane.telemetry_topk``  heavy-hitter candidate slots
    # + the FIB lookup implementation (docs/ROUTING.md; ISSUE 15):
    #   ``dataplane.fib_impl``   dense | lpm | auto — auto engages the
    #                            per-length LPM planes at
    #                            ``fib_lpm_min_routes`` staged routes
    #                            (re-gated at every swap; an
    #                            ineligible table falls back to dense)
    #   ``dataplane.fib_lpm_plen_caps``  per-length plane capacities
    #                            (index = prefix length; empty = every
    #                            length sized to fib_slots — set the
    #                            feed's length histogram at BGP scale)
    #   ``dataplane.fib_lpm_mem_mb``     auto-allocation memory gate
    #   ``dataplane.fib_ecmp_groups``/``fib_ecmp_ways``  ECMP next-hop
    #                            group slots / member ways per group
    #                            (power of two — flow-hash member pick)
    # All validated at load with the session-table knobs.
    dataplane: DataplaneConfig = dataclasses.field(default_factory=DataplaneConfig)
    # multi-tenant gateway mode (ISSUE 14; vpp_tpu/tenancy/,
    # docs/TENANCY.md): with ``dataplane.tenancy: on``, each entry
    # registers one tenant —
    #   id            tenant id (0 = the default tenant; required)
    #   name          display name
    #   prefixes      IPv4 CIDRs owned by the tenant (the device
    #                 derivation map; disjoint across tenants —
    #                 overlap is refused at load)
    #   vni           VXLAN VNI → tenant for encapsulated ingress
    #   rate/burst    token bucket: rate tokens per clock tick
    #                 (0 = unlimited), burst = bucket capacity;
    #                 overage drops attributed
    #                 drops_total{reason="tenant_quota"}
    #   sess_buckets/nat_buckets  power-of-2 session/NAT capacity
    #                 slice (bucket counts; 0 = unsliced) — a full
    #                 slice fails/evicts only within its tenant
    #   weight        weighted-fair dequeue weight in the IO pump
    #   ml_mode/ml_thresh  per-tenant ML override
    #                 (inherit|off|score|enforce + flag threshold)
    # Validated at load (vpp_tpu/tenancy/sched.py): bad prefixes,
    # out-of-range ids/rates and oversubscribed slices fail HERE.
    tenants: list = dataclasses.field(default_factory=list)
    # IPAM subnets
    ipam: IpamConfig = dataclasses.field(default_factory=IpamConfig)
    # packet IO
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    # multi-chip mesh mode (ignored by the standalone vpp-tpu-agent)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # autotuned knob profile (ISSUE 16; tools/autotune.py): path of a
    # ``tuned/<backend>.json`` the sweep emitted. Loaded BEFORE section
    # build as per-key DEFAULTS — any knob the YAML sets explicitly
    # wins over the profile. The profile's measured ``floor_us`` is
    # the governor's achievable-latency floor: a configured
    # ``io.latency_slo_us`` below it is clamped UP at load (an SLO the
    # hardware cannot meet would pin the governor at the 1-slot floor
    # forever, shedding for nothing). "" disables.
    tuned_profile: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "AgentConfig":
        d = dict(d or {})
        profile = load_tuned_profile(d.get("tuned_profile") or "")
        if profile is not None:
            apply_tuned_profile(d, profile)

        def build_section(name: str, section_cls, fields) -> None:
            if name not in d:
                return
            section = dict(d[name] or {})
            unknown = set(section) - fields
            if unknown:
                raise ValueError(
                    f"unknown config keys in '{name}': {sorted(unknown)}"
                )
            d[name] = section_cls(**section)

        build_section("dataplane", DataplaneConfig, set(DataplaneConfig._fields))
        if "dataplane" in d:
            from vpp_tpu_torch.pipeline.tables import validate_dataplane_config

            validate_dataplane_config(d["dataplane"])
        if d.get("tenants"):
            # tenant entries validate against the dataplane geometry
            # at LOAD (vpp_tpu/tenancy/sched.py — jax-free): a bad
            # prefix or an oversubscribed slice is a config error,
            # not a first-commit surprise
            from vpp_tpu_torch.tenancy.sched import validate_tenancy_config

            dp_cfg = d.get("dataplane", DataplaneConfig())
            if getattr(dp_cfg, "tenancy", "off") == "off":
                raise ValueError(
                    "tenants: configured but dataplane.tenancy is off")
            d["tenants"] = validate_tenancy_config(dp_cfg, d["tenants"])
        build_section(
            "ipam", IpamConfig,
            {f.name for f in dataclasses.fields(IpamConfig)},
        )
        build_section(
            "io", IOConfig,
            {f.name for f in dataclasses.fields(IOConfig)},
        )
        if "io" in d:
            # fail at LOAD, not at the first persistent-mode pump
            # launch (io/rings.py; the validate_dataplane_config
            # pattern) — and diagnose the bad value even when
            # pump_mode is "dispatch" and the rings never build
            from vpp_tpu_torch.io.rings import validate_ring_geometry

            validate_ring_geometry(d["io"].io_ring_slots,
                                   d["io"].io_ring_windows)
            # governor/priority knobs fail at load too (ISSUE 13):
            # bad SLO bounds or an unparsable priority CIDR is a
            # config error, not a first-tick surprise
            from vpp_tpu_torch.io.governor import validate_governor_config

            validate_governor_config(d["io"])
            if int(d["io"].io_tenant_quantum) < 0:
                raise ValueError(
                    "io.io_tenant_quantum must be >= 0 (packets; "
                    "0 = a full slot/batch)")
        if profile is not None and "io" in d:
            # governor SLO floor (ISSUE 16): the tuned profile's
            # measured floor_us is the best latency the swept knobs
            # achieved on this backend — an SLO below it is
            # unreachable, so clamp up rather than let the governor
            # shed traffic chasing it
            floor = float(profile.get("floor_us") or 0.0)
            slo = int(getattr(d["io"], "latency_slo_us", 0))
            if floor > 0 and 0 < slo < floor:
                d["io"].latency_slo_us = int(-(-floor // 1))
        build_section(
            "mesh", MeshConfig,
            {f.name for f in dataclasses.fields(MeshConfig)},
        )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)


#: tuned-profile sections the autotuner may set knobs in — anything
#: else in "knobs" is refused at load (a profile is config, so a typo
#: fails HERE with a clear message, not as a silently ignored key).
#: "env" carries VPPT_* process knobs (e.g. VPPT_LPM_HINT_MIN — the
#: LPM stride-hint engage threshold has no YAML twin); applied via
#: os.environ.setdefault so an explicitly exported variable wins.
TUNED_PROFILE_SECTIONS = ("dataplane", "io", "env")


def load_tuned_profile(path: str) -> Optional[dict]:
    """Parse a ``tuned/<backend>.json`` autotuner profile (ISSUE 16).

    Returns None when ``path`` is empty. Raises ValueError on a
    malformed profile — shape problems are config errors, not
    first-boot surprises. Knob VALUES are validated downstream by the
    same section builders that validate YAML keys (from_dict), so a
    profile can never smuggle in a knob the YAML could not set.
    """
    if not path:
        return None
    import json

    try:
        with open(path) as f:
            profile = json.load(f)
    except OSError as e:
        raise ValueError(f"tuned_profile {path!r}: {e}") from e
    except json.JSONDecodeError as e:
        raise ValueError(f"tuned_profile {path!r}: bad JSON: {e}") from e
    if not isinstance(profile, dict):
        raise ValueError(f"tuned_profile {path!r}: not a JSON object")
    knobs = profile.get("knobs", {})
    if not isinstance(knobs, dict):
        raise ValueError(f"tuned_profile {path!r}: 'knobs' not an object")
    unknown = set(knobs) - set(TUNED_PROFILE_SECTIONS)
    if unknown:
        raise ValueError(
            f"tuned_profile {path!r}: unknown knob sections "
            f"{sorted(unknown)} (allowed: {list(TUNED_PROFILE_SECTIONS)})")
    for section, vals in knobs.items():
        if not isinstance(vals, dict):
            raise ValueError(
                f"tuned_profile {path!r}: knobs.{section} not an object")
    bad_env = [k for k in knobs.get("env", {})
               if not str(k).startswith("VPPT_")]
    if bad_env:
        raise ValueError(
            f"tuned_profile {path!r}: knobs.env keys must be VPPT_* "
            f"process knobs, got {sorted(bad_env)}")
    return profile


def apply_tuned_profile(d: dict, profile: dict) -> None:
    """Fold a tuned profile's knobs into a raw config dict as per-key
    DEFAULTS: a key the YAML sets explicitly always wins. Mutates
    ``d`` in place (called by AgentConfig.from_dict before the section
    builders, so profile keys go through exactly the same unknown-key
    and value validation as YAML keys). The "env" section applies to
    the process environment instead (setdefault — an exported variable
    wins over the profile, mirroring the per-key YAML precedence)."""
    import os

    for section, vals in profile.get("knobs", {}).items():
        if section == "env":
            for k, v in vals.items():
                os.environ.setdefault(str(k), str(v))
            continue
        raw = dict(d.get(section) or {})
        for k, v in vals.items():
            raw.setdefault(k, v)
        if raw:
            d[section] = raw


NODE_NAME_PLACEHOLDER = "${NODE_NAME}"


def resolve_node_name(data, env=None):
    """``data`` with every string value that is exactly ``${NODE_NAME}``
    replaced by the environment's ``NODE_NAME``, which the deployment's
    DaemonSet sets from the downward API (``spec.nodeName``). Raises
    ``ValueError`` naming the variable when it is unset or empty: a node
    must not boot under a name that every other node shares. The
    reference's ``load_config`` leaves the placeholder as it is."""
    env = os.environ if env is None else env

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if v == NODE_NAME_PLACEHOLDER:
            name = env.get("NODE_NAME", "")
            if not name:
                raise ValueError(
                    f"config value {NODE_NAME_PLACEHOLDER} needs the "
                    "environment variable NODE_NAME, which is unset")
            return name
        return v

    return walk(data)


def load_config(path: Optional[str]) -> AgentConfig:
    """The AgentConfig of a YAML file; a JSON one (JSON is YAML) reads
    without PyYAML, which a node need not have. A value of exactly
    ``${NODE_NAME}`` is the environment's ``NODE_NAME``
    (``resolve_node_name``)."""
    if not path:
        return AgentConfig()
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        import yaml

        data = yaml.safe_load(text)
    return AgentConfig.from_dict(resolve_node_name(data))
