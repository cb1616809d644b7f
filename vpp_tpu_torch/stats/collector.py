"""StatsCollector: pipeline counters → pod-labelled Prometheus gauges.

Reference analog: plugins/statscollector — consumes interface stats,
maps ifname→pod via contiv.API (here: the CNI ContainerIndex's
ifindex→pod axis), and exposes 12 gauges under /stats
(plugin_impl_statscollector.go:20-90, metric names :28-41). Interfaces
without a pod (uplink, host) are labelled by interface role instead, and
gauges for deleted pods are dropped like the reference's unregister path.

Six per-interface gauges (in/out packets, in/out bytes, drops, punts*)
plus six node-level ones (rx/tx totals, drop causes, active sessions).
*punts are node-level in the pipeline (disposition HOST), surfaced on
the host interface's row.

The port's copy of ``vpp_tpu/stats/collector.py``: every family keeps
the reference's name. Where the reference reads JAX:

* the active-session count is one reduction on the dataplane's device
  and one ``.item()``, taken under the dataplane's ``_lock``: the
  port's session tensors are written in place by every step, where the
  reference reduces an immutable epoch;
* ``vpp_tpu_jit_compiles_total{step=}`` counts the captured step
  programs (``pipeline/capture.capture_totals``), the port's compile
  unit;
* ``vpp_tpu_build_info`` carries ``torch`` and ``device`` labels (the
  torch version, the dataplane's device type) in place of ``jax`` and
  ``backend``.

The fleet and VCL sources (``set_fleet``, ``set_vcl``) export the
reference's ``vpp_tpu_fleet_*`` and ``vpp_tpu_vcl_*`` families from
their host counters. ``vpp_tpu_partition_info`` exports the partition
manifest (parallel/partition.py) on every node, the port's five derived
fields included; with a mesh attached (``set_cluster``) its shard count
and placements are the mesh's, and the per-shard session residency and
rule-plane bytes are read off the cluster's live tensors.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vpp_tpu_torch.cni.containeridx import ContainerIndex
from vpp_tpu_torch.io.governor import GOVERNOR_MODES
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.graph import StepStats
from vpp_tpu_torch.stats.prometheus import Gauge, Histogram, MetricsRegistry

STATS_PATH = "/stats"

# pump batch latencies live in the sub-millisecond..100ms regime
PUMP_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 1.0,
)

PER_IF_GAUGES = (
    ("vpp_tpu_if_in_packets", "packets received on the interface"),
    ("vpp_tpu_if_out_packets", "packets transmitted on the interface"),
    ("vpp_tpu_if_in_bytes", "bytes received on the interface"),
    ("vpp_tpu_if_out_bytes", "bytes transmitted on the interface"),
    ("vpp_tpu_if_drop_packets", "packets dropped that arrived on the interface"),
    ("vpp_tpu_if_punt_packets", "packets punted to the host stack"),
)

# pump.stats key -> (gauge name, help); one source of truth for both
# gauge registration and the publish() copy loop
PUMP_STAT_GAUGES = (
    ("frames", "vpp_tpu_pump_frames", "tx frames written by the IO pump"),
    ("pkts", "vpp_tpu_pump_packets", "packets moved by the IO pump"),
    ("batches", "vpp_tpu_pump_batches",
     "device batches dispatched by the pump"),
    ("tx_ring_full", "vpp_tpu_pump_tx_ring_full",
     "tx frames dropped: tx ring full"),
    ("batch_errors", "vpp_tpu_pump_batch_errors", "pump batches that failed"),
    ("icmp_errors", "vpp_tpu_pump_icmp_errors",
     "ICMP error packets generated"),
    ("fabric_pkts", "vpp_tpu_pump_fabric_packets",
     "packets delivered across the mesh fabric (cluster pump)"),
    # overlapped fetch ladder observability (io/pump.py module doc):
    # the live in-flight window and the adaptive chainer's activity
    ("inflight", "vpp_tpu_pump_inflight_depth",
     "device batches currently in flight (dispatched, not yet written)"),
    ("inflight_peak", "vpp_tpu_pump_inflight_peak",
     "high-water mark of in-flight device batches"),
    ("chain_batches", "vpp_tpu_pump_chained_dispatches",
     "dispatches that folded K packed buckets into one chained "
     "device program"),
    ("chain_k_peak", "vpp_tpu_pump_chain_k_peak",
     "largest chain fold depth K used"),
    # two-tier fast path (pipeline/graph.py pipeline_step_auto)
    ("fastpath_batches", "vpp_tpu_pump_fastpath_batches",
     "pump dispatches fully served by the classify-free "
     "established-flow kernel (chain folds count once)"),
    # session-table pressure (aux rows 3/4 of the packed boundary):
    # the set-associative table's congestion signals under packed IO
    ("sess_insert_fails", "vpp_tpu_pump_sess_insert_fails",
     "session inserts that lost the intra-batch way election "
     "(reflective + NAT tables; retried on the flow's next packet)"),
    ("sess_evictions", "vpp_tpu_pump_sess_evictions",
     "session ways reclaimed by insert-time eviction "
     "(expired + victim, both tables)"),
    # per-packet ML stage riders (aux rows 5..7, ISSUE 10): the
    # model's verdict counters as the PUMP sees them — the packed/
    # ring paths never fetch StepStats, so these ride the aux fetch
    ("ml_scored", "vpp_tpu_ml_pump_scored",
     "packets scored by the ML stage across pump dispatches"),
    ("ml_flagged", "vpp_tpu_ml_pump_flagged",
     "packets the ML stage flagged across pump dispatches"),
    ("ml_drops", "vpp_tpu_ml_pump_drops",
     "packets the ML enforce policy dropped across pump dispatches"),
    # device-telemetry riders (aux rows 8/9, ISSUE 11): wire-latency
    # samples the device histogrammed and packets folded into the
    # heavy-hitter flow sketch, as the pump's aux fetch saw them —
    # both 0 with dataplane.telemetry off
    ("tel_observed", "vpp_tpu_pump_wire_lat_observed",
     "packets whose wire latency the device telemetry plane "
     "histogrammed across pump dispatches"),
    ("tel_sketched", "vpp_tpu_pump_flow_sketched",
     "packets folded into the device heavy-hitter flow sketch "
     "across pump dispatches"),
    # device-resident descriptor rings (persistent mode, ISSUE 7):
    # host↔device window exchanges, frames staged through the ring,
    # live in-flight windows, tx-writeback lag (windows dispatched but
    # not yet written back) and host callbacks made by the device
    # program — zero in the ring steady state; a nonzero rate() here
    # IS the two-callbacks-per-frame regression coming back
    ("ring_windows", "vpp_tpu_pump_ring_windows",
     "device-ring windows exchanged (one transfer each way per window)"),
    ("ring_frames", "vpp_tpu_pump_ring_frames",
     "frames staged through the device descriptor rings"),
    ("ring_inflight", "vpp_tpu_pump_ring_inflight",
     "device-ring windows currently in flight (staged or awaiting "
     "tx writeback)"),
    ("ring_lag", "vpp_tpu_pump_ring_writeback_lag",
     "device-ring windows dispatched but not yet written back"),
    ("io_callbacks", "vpp_tpu_pump_io_callbacks",
     "host callback invocations made by the persistent device "
     "program (the ring steady state makes none)"),
    # priority lane (ISSUE 13; io/governor.py PriorityFilter): reflex
    # frames/packets classified into the lane, ring windows the
    # stager shipped early for one, and priority marks the
    # pump.priority_starve fault seam demoted to bulk
    ("priority_frames", "vpp_tpu_pump_priority_frames",
     "rx frames classified into the reflex priority lane"),
    ("priority_pkts", "vpp_tpu_pump_priority_packets",
     "packets classified into the reflex priority lane"),
    ("priority_preempts", "vpp_tpu_pump_priority_preempts",
     "device-ring windows shipped early because a priority slot "
     "landed (the lane's bounded-queueing mechanism)"),
    ("priority_starved", "vpp_tpu_pump_priority_starved",
     "priority classifications demoted to bulk by the "
     "pump.priority_starve fault seam (chaos testing; 0 in "
     "production)"),
    # tenancy (ISSUE 14; vpp_tpu/tenancy/): the aux-rider totals —
    # device token-bucket drops (also exported with the tenant_quota
    # reason on vpp_tpu_pump_drops_total), session-slice insert
    # failures, and tenant classifications the pump.tenant_starve
    # fault seam demoted to the default tenant
    ("drops_tenant_quota", "vpp_tpu_tenant_quota_drop_packets",
     "packets dropped by per-tenant token-bucket rate limits "
     "(device DROP_TENANT verdicts, summed across tenants)"),
    ("tenant_sess_quota_fails", "vpp_tpu_tenant_sess_quota_fails",
     "session/NAT inserts that failed inside a tenant's capacity "
     "slice (summed across tenants)"),
    ("tenant_starved", "vpp_tpu_tenant_starved",
     "tenant classifications demoted to the default tenant by the "
     "pump.tenant_starve fault seam (chaos testing; 0 in "
     "production)"),
)

# pump.stats drop-cause key -> `reason` label on the
# vpp_tpu_pump_drops_total counter family (ISSUE 7 satellite: the r5
# persistent goodput number hid WHERE loss happened). rx_full is
# counted by the IO daemon (io/daemon.py drops_rx_full — a separate
# process in deployment); attach its stats with set_io_daemon() and
# publish() folds them into the same reason.
PUMP_DROP_REASONS = (
    ("drops_rx_full", "rx_full"),
    ("drops_tx_stall", "tx_stall"),
    ("drops_shutdown", "shutdown"),
    ("drops_error", "error"),
    # overload = bulk admission the latency governor refused in
    # brownout (ISSUE 13) — explicit shedding, attributed, never
    # silent queue growth. Must stay in lockstep with
    # io/pump.py PUMP_DROP_KEYS (counters lint).
    ("drops_overload", "overload"),
    # tenant_quota = per-tenant token-bucket overage dropped ON
    # DEVICE (ISSUE 14; DROP_TENANT verdicts counted off the aux
    # rider) — a misbehaving tenant's overage is fully attributed
    # here, never absorbed silently or billed to other tenants
    ("drops_tenant_quota", "tenant_quota"),
)

# pump.stats stage-seconds key -> `stage` label of the
# vpp_tpu_pump_stage_seconds counter family. fetch_wait is the wait
# for a device result to become READY (overlapped across the in-flight
# window — not a serial path cost); fetch is the serial result copy.
PUMP_STAGE_SECONDS = (
    ("t_pack", "pack"),
    ("t_dispatch", "dispatch"),
    ("t_fetch_wait", "fetch_wait"),
    ("t_fetch", "fetch"),
    ("t_write", "write"),
)

# Global-classify implementations the vpp_tpu_acl_classifier info
# gauge enumerates (Dataplane.classifier_impl; ops/acl.py dense,
# ops/acl_mxu.py, ops/acl_bv.py, the fused Pallas BV rung — ISSUE 16).
CLASSIFIER_IMPLS = ("dense", "mxu", "bv", "pallas")

# Degraded-mode components the vpp_tpu_degraded gauge enumerates
# (ISSUE 8): kvstore = the cluster store is unreachable (the agent
# serves its last-adopted epoch; staleness exported next to it),
# ring = the persistent pump fell back from the device ring to the
# dispatch ladder, snapshot = the last snapshot attempt failed,
# ml = the last ML-model load was refused (the previous model keeps
# serving — vpp_tpu/ml/loader.py, ISSUE 10), governor = the latency
# governor's control loop is WEDGED (repeated tick failures; the pump
# keeps forwarding at the last-known window shape — ISSUE 13; note
# brownout is NOT degraded, it is the governor working). Every
# component always exports (0 = healthy) so an absent series is a
# wiring bug, not good news.
DEGRADED_COMPONENTS = ("kvstore", "ring", "snapshot", "ml", "governor")

# Gateway-fleet surface (ISSUE 18; vpp_tpu/fleet/). One declaration
# drives BOTH registration (__init__, unconditional — the registries.py
# full-registry build lints these without a fleet attached) and the
# --counters parity pass: every vpp_tpu_fleet_* family must appear
# here, and the drop-cause axis must equal the causes the steering
# tier (STEER_DROP_CAUSES) and the fleet pump (QUEUE_DROP_CAUSES)
# actually attribute — a cause added on either side without its
# observability twin fails lint, the PUMP_DROP_REASONS discipline.
FLEET_GAUGE_FAMILIES = (
    ("vpp_tpu_fleet_instances",
     "dataplane instances behind the fleet steering tier", "gauge"),
    ("vpp_tpu_fleet_ranges",
     "consistent-hash bucket ranges (the ownership/migration "
     "quantum)", "gauge"),
    ("vpp_tpu_fleet_fenced_ranges",
     "ranges currently fenced mid-migration (steered traffic for "
     "them drops, attributed cause=fenced)", "gauge"),
    ("vpp_tpu_fleet_epoch_max",
     "highest per-range ownership epoch observed (the fencing-token "
     "high-water mark; only advances)", "gauge"),
    ("vpp_tpu_fleet_rebalances_total",
     "completed rebalance waves (each migrates every moved range)",
     "counter"),
    ("vpp_tpu_fleet_migrated_ranges_total",
     "bucket ranges live-migrated between instances (including "
     "crash recoveries)", "counter"),
    ("vpp_tpu_fleet_migrated_sessions_total",
     "live sessions shipped by range migrations (drained, "
     "age-rebased, adopted)", "counter"),
    ("vpp_tpu_fleet_nat_coldstarts_total",
     "live NAT sessions left behind by range migrations (NAT state "
     "keys on the post-NAT pair and cannot migrate — ISSUE 19; the "
     "new owner re-establishes these flows from the mapping tables)",
     "counter"),
    ("vpp_tpu_fleet_steered_total",
     "packets steered to each instance (by instance label)",
     "counter"),
    ("vpp_tpu_fleet_drops_total",
     "packets the fleet tier dropped, by attributed cause "
     "(fenced/no_owner/queue — offered == steered + these, exactly)",
     "counter"),
    ("vpp_tpu_fleet_queue_depth",
     "packets buffered or queued toward each instance (by instance "
     "label)", "gauge"),
)
FLEET_DROP_CAUSES = ("fenced", "no_owner", "queue")

# Latency-governor surface (ISSUE 13; io/governor.py). The mode info
# gauge enumerates "off" (no governor attached) plus the state
# machine's modes; GOVERNOR_STAT_GAUGES maps the governor's numeric
# snapshot scalars (LatencyGovernor.SNAPSHOT_SCALARS) to one gauge
# each — the tools/lint.py --counters pass keeps the two in lockstep,
# so a control-loop scalar added without its observability twin fails
# tier-1.
GOVERNOR_MODE_LABELS = ("off",) + GOVERNOR_MODES

GOVERNOR_STAT_GAUGES = (
    ("slo_us", "vpp_tpu_governor_slo_us",
     "configured wire-latency SLO the governor closes its loop on"),
    ("level", "vpp_tpu_governor_level",
     "current rung on the window-shape ladder (0 = lone-frame "
     "floor)"),
    ("fill", "vpp_tpu_governor_fill_slots",
     "current window-fill cap the stager is held to (slots)"),
    ("inflight", "vpp_tpu_governor_inflight_limit",
     "current in-flight depth cap applied to the pump"),
    ("last_p99_us", "vpp_tpu_governor_latency_p99_us",
     "p99 wire latency the last control tick observed (device "
     "histogram delta, or the host batch window)"),
    ("queue_est_us", "vpp_tpu_governor_queue_est_us",
     "estimated queueing delay of the rx backlog at the EWMA "
     "service rate (the SLO-envelope term)"),
    ("fill_avg", "vpp_tpu_governor_fill_avg",
     "recent average slots per shipped ring window (the lone-window "
     "guard's occupancy input)"),
    ("ticks", "vpp_tpu_governor_ticks_total",
     "control-loop ticks executed"),
    ("tick_errors", "vpp_tpu_governor_tick_errors_total",
     "control-loop ticks that failed (WEDGE_LIMIT consecutive "
     "failures freeze the governor one-way)"),
)

# ML-stage modes the vpp_tpu_ml_stage info gauge enumerates (the LIVE
# compiled mode — Dataplane._ml_mode, re-gated at every swap; "off"
# while no model is staged even under a score/enforce knob)
ML_STAGE_MODES = ("off", "score", "enforce")

# FIB lookup implementations the vpp_tpu_fib_impl info gauge
# enumerates (Dataplane.fib_impl; ops/fib.py dense, ops/lpm.py —
# ISSUE 15 — and the fused Pallas length-plane kernel — ISSUE 16).
FIB_IMPLS = ("dense", "lpm", "pallas")

# Session-probe implementations (Dataplane.session_impl; ops/session.py
# gather rung vs the fused Pallas bucket probe — ISSUE 16).
SESSION_IMPLS = ("gather", "pallas")

# The vpp_tpu_kernel_impl info-gauge family (ISSUE 16): per hot op,
# the candidate implementation rungs its ladder can select — published
# from Dataplane.kernel_snapshot(), 1 on the live rung, 0 elsewhere.
# `sum by (op, impl)` across a fleet counts nodes per kernel path.
KERNEL_IMPL_OPS = {
    "classifier": CLASSIFIER_IMPLS,
    "fib": FIB_IMPLS,
    "session": SESSION_IMPLS,
}

PUMP_GAUGES = tuple(
    (name, help_) for _, name, help_ in PUMP_STAT_GAUGES
) + (
    ("vpp_tpu_pump_batch_latency_p50_us",
     "median dispatch-to-tx batch latency (recent window)"),
    ("vpp_tpu_pump_batch_latency_p99_us",
     "p99 dispatch-to-tx batch latency (recent window)"),
    ("vpp_tpu_pump_fastpath_hit_pct",
     "percentage of alive packets admitted via a live reflective "
     "session — the fast-path regime signal (100 = pure established "
     "return traffic)"),
)

VCL_GAUGES = (
    ("vpp_tpu_vcl_connect_checks",
     "ldpreload shim connect() admission checks served"),
    ("vpp_tpu_vcl_connect_denies",
     "ldpreload shim connect() verdicts denied by session rules"),
    ("vpp_tpu_vcl_accept_checks",
     "ldpreload shim accept() admission checks served"),
    ("vpp_tpu_vcl_accept_denies",
     "ldpreload shim accept() verdicts denied by session rules"),
    ("vpp_tpu_vcl_clients",
     "admission-socket connections currently open (one per app THREAD "
     "that has issued a filtered call — the shim keeps per-thread "
     "channels)"),
)

NODE_GAUGES = (
    ("vpp_tpu_node_rx_packets", "total valid packets processed"),
    ("vpp_tpu_node_tx_packets", "total packets forwarded"),
    ("vpp_tpu_node_drop_ip4", "ip4-input drops (TTL/length/bad interface)"),
    ("vpp_tpu_node_drop_acl", "policy (ACL) denies"),
    ("vpp_tpu_node_drop_no_route", "FIB lookup misses"),
    ("vpp_tpu_node_sessions_active", "live reflective-session entries"),
    ("vpp_tpu_node_drop_nat", "NAT fail-closed drops"),
    ("vpp_tpu_node_sess_insert_fail",
     "reflective-session inserts that found no free probe slot"),
    ("vpp_tpu_node_natsess_insert_fail",
     "NAT-session inserts that found no free probe slot"),
    ("vpp_tpu_node_sess_occupancy", "live (unexpired) reflective slots"),
    ("vpp_tpu_node_natsess_occupancy", "live (unexpired) NAT-session slots"),
    ("vpp_tpu_node_dnat_packets", "DNAT translations applied (forwarded)"),
    ("vpp_tpu_node_snat_packets", "SNAT translations applied (forwarded)"),
    ("vpp_tpu_node_nat_reversed_packets",
     "reply-path un-NAT translations applied (forwarded)"),
    # two-tier fast path: the vpp_tpu_pipeline_* namespace mirrors the
    # StepStats fields behind the tools/lint.py --counters parity pass
    ("vpp_tpu_pipeline_sess_hits",
     "packets admitted via a live reflective session"),
    ("vpp_tpu_pipeline_fastpath_steps",
     "pipeline steps served by the classify-free established-flow "
     "kernel"),
    # per-packet ML scoring stage (ISSUE 10; ops/mlscore.py): the
    # StepStats verdict counters of the unpacked path — mirrors of
    # the pump-side vpp_tpu_ml_pump_* aux riders
    ("vpp_tpu_ml_scored_packets",
     "packets scored by the per-packet ML stage"),
    ("vpp_tpu_ml_flagged_packets",
     "packets whose ML score crossed the model's flag threshold"),
    ("vpp_tpu_ml_dropped_packets",
     "packets dropped by the ML enforce policy (drop / rate-limit)"),
    # device-resident telemetry plane (ISSUE 11; ops/telemetry.py):
    # the StepStats mirror of the in-step flow-sketch fold
    ("vpp_tpu_flow_sketch_packets",
     "packets folded into the device count-min heavy-hitter flow "
     "sketch"),
    # multi-tenant gateway mode (ISSUE 14; vpp_tpu/tenancy/): the
    # StepStats mirrors of the unpacked path — per-tenant detail
    # lives on the labelled TENANT_GAUGES families
    ("vpp_tpu_node_tenant_limited_packets",
     "packets dropped by per-tenant token-bucket rate limits "
     "(DROP_TENANT, all tenants)"),
    ("vpp_tpu_node_tenant_quota_fail_packets",
     "session/NAT inserts that failed inside a tenant's capacity "
     "slice (all tenants)"),
    # device-resident VXLAN overlay (ISSUE 19; ops/vxlan.py): the
    # StepStats mirrors of the fused decap/encap stage pair
    ("vpp_tpu_node_overlay_decap_packets",
     "VXLAN frames decapsulated in-step (VNI validated, inner vector "
     "re-admitted at ip4-input)"),
    ("vpp_tpu_node_overlay_encap_packets",
     "forwarded packets VXLAN-encapsulated in-step (outer header "
     "resolved through the outer-FIB walk)"),
    ("vpp_tpu_node_drop_overlay",
     "overlay fail-closed drops: VXLAN-addressed frames with an "
     "unknown VNI, a bad outer header, or an unresolvable outer "
     "route (DROP_OVERLAY)"),
)

# Per-tenant labelled families (ISSUE 14), split by their feed — the
# publish loop SETS and stale-labelset-REMOVES each group by iterating
# these same tuples, so a family added here is automatically covered
# by both (no hand-maintained twin list to forget). All labelled
# ``tenant=<id>``.
# Device accounting planes + occupancy/quota: Dataplane.tenant_snapshot()
TENANT_PLANE_GAUGES = (
    ("vpp_tpu_tenant_rx_packets",
     "packets received per tenant (device accounting plane)"),
    ("vpp_tpu_tenant_goodput_packets",
     "packets forwarded per tenant (the isolation bench's goodput "
     "axis)"),
    ("vpp_tpu_tenant_rl_dropped_packets",
     "per-tenant token-bucket rate-limit drops (tenant_quota)"),
    ("vpp_tpu_tenant_quota_fail_packets",
     "per-tenant session-slice insert failures"),
    ("vpp_tpu_tenant_bucket_tokens",
     "current token-bucket fill level per tenant"),
    ("vpp_tpu_tenant_sess_occupancy",
     "live sessions resident in the tenant's capacity slice"),
    ("vpp_tpu_tenant_sess_quota_slots",
     "session-slot capacity of the tenant's slice (unsliced tenants "
     "report the whole table)"),
    ("vpp_tpu_tenant_weight",
     "weighted-fair dequeue weight of the tenant in the IO pump"),
)
# IO-side scheduling counters: DataplanePump.tenant_io_snapshot()
TENANT_IO_GAUGES = (
    ("vpp_tpu_tenant_io_frames",
     "rx frames the pump classified into the tenant's lane"),
    ("vpp_tpu_tenant_io_packets",
     "packets the pump classified into the tenant's lane"),
    ("vpp_tpu_tenant_shed_packets",
     "packets shed from the tenant's lane in governor brownout "
     "(per-tenant-weighted shedding; also attributed "
     "reason=overload)"),
)
TENANT_GAUGES = TENANT_PLANE_GAUGES + TENANT_IO_GAUGES

# StepStats field → the Prometheus family its value feeds. The single
# source of truth behind the tools/lint.py ``--counters`` parity pass:
# every StepStats field MUST appear here with a registered family, and
# every registered ``vpp_tpu_pipeline_*`` family must map back to a
# field — a counter added on either side without its twin fails tier-1.
STEPSTATS_FAMILIES = {
    "rx": "vpp_tpu_node_rx_packets",
    "tx": "vpp_tpu_node_tx_packets",
    "drop_ip4": "vpp_tpu_node_drop_ip4",
    "drop_acl": "vpp_tpu_node_drop_acl",
    "drop_no_route": "vpp_tpu_node_drop_no_route",
    "punt": "vpp_tpu_if_punt_packets",
    "dnat": "vpp_tpu_node_dnat_packets",
    "snat": "vpp_tpu_node_snat_packets",
    "nat_reversed": "vpp_tpu_node_nat_reversed_packets",
    "drop_nat": "vpp_tpu_node_drop_nat",
    "sess_insert_fail": "vpp_tpu_node_sess_insert_fail",
    "natsess_insert_fail": "vpp_tpu_node_natsess_insert_fail",
    "sess_occupancy": "vpp_tpu_node_sess_occupancy",
    "natsess_occupancy": "vpp_tpu_node_natsess_occupancy",
    "if_rx": "vpp_tpu_if_in_packets",
    "if_tx": "vpp_tpu_if_out_packets",
    "if_rx_bytes": "vpp_tpu_if_in_bytes",
    "if_tx_bytes": "vpp_tpu_if_out_bytes",
    "if_drops": "vpp_tpu_if_drop_packets",
    "sess_hits": "vpp_tpu_pipeline_sess_hits",
    "fastpath": "vpp_tpu_pipeline_fastpath_steps",
    # set-associative session-table reclamation (ops/session.py): all
    # four feed ONE labelled counter family,
    # vpp_tpu_session_evictions_total{table=,reason=}
    "sess_evict_expired": "vpp_tpu_session_evictions_total",
    "sess_evict_victim": "vpp_tpu_session_evictions_total",
    "natsess_evict_expired": "vpp_tpu_session_evictions_total",
    "natsess_evict_victim": "vpp_tpu_session_evictions_total",
    # per-packet ML stage (ISSUE 10)
    "ml_scored": "vpp_tpu_ml_scored_packets",
    "ml_flagged": "vpp_tpu_ml_flagged_packets",
    "ml_drops": "vpp_tpu_ml_dropped_packets",
    # device telemetry plane (ISSUE 11)
    "tel_sketched": "vpp_tpu_flow_sketch_packets",
    # multi-tenant gateway mode (ISSUE 14)
    "tnt_limited": "vpp_tpu_node_tenant_limited_packets",
    "tnt_qfail": "vpp_tpu_node_tenant_quota_fail_packets",
    # device-resident VXLAN overlay (ISSUE 19)
    "ovl_decap": "vpp_tpu_node_overlay_decap_packets",
    "ovl_encap": "vpp_tpu_node_overlay_encap_packets",
    "drop_overlay": "vpp_tpu_node_drop_overlay",
}

# Packed-aux rider row (pipeline/dataplane.py PACKED_AUX_SCHEMA, rows
# 3+) -> the pump stats key it accumulates into. Rows 0-2 are the
# fastpath trio consumed positionally by _account_fastpath. The
# tools/lint.py --counters pass enforces BOTH directions: every schema
# row maps here, and every mapped key exports via PUMP_STAT_GAUGES —
# widening the rider without its observability twin fails tier-1
# (the STEPSTATS parity idea extended to the aux boundary, ISSUE 11).
AUX_RIDER_STATS = {
    "insert_fails": "sess_insert_fails",
    "evictions": "sess_evictions",
    "ml_scored": "ml_scored",
    "ml_flagged": "ml_flagged",
    "ml_drops": "ml_drops",
    "tel_observed": "tel_observed",
    "tel_sketched": "tel_sketched",
    # tenancy rows (ISSUE 14): the rate-limit row doubles as the
    # tenant_quota reason on vpp_tpu_pump_drops_total
    "tnt_limited": "drops_tenant_quota",
    "tnt_qfail": "tenant_sess_quota_fails",
}

# Telemetry-plane modes the vpp_tpu_telemetry info gauge enumerates
# (the trace-time-static DataplaneConfig.telemetry knob)
TELEMETRY_MODES = ("off", "latency", "full")

# StepStats eviction field → its (table, reason) label pair on the
# vpp_tpu_session_evictions_total family.
EVICTION_LABELS = {
    "sess_evict_expired": ("sess", "expired"),
    "sess_evict_victim": ("sess", "victim"),
    "natsess_evict_expired": ("natsess", "expired"),
    "natsess_evict_victim": ("natsess", "victim"),
}


class StatsCollector:
    def __init__(
        self,
        dataplane: Dataplane,
        index: Optional[ContainerIndex] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.dp = dataplane
        self.index = index
        self.registry = registry or MetricsRegistry()
        self._lock = threading.Lock()
        n_if = dataplane.config.max_ifaces
        self._acc: Dict[str, np.ndarray] = {
            "if_rx": np.zeros(n_if, np.int64),
            "if_tx": np.zeros(n_if, np.int64),
            "if_rx_bytes": np.zeros(n_if, np.int64),
            "if_tx_bytes": np.zeros(n_if, np.int64),
            "if_drops": np.zeros(n_if, np.int64),
        }
        self._totals: Dict[str, int] = {
            k: 0 for k in ("rx", "tx", "drop_ip4", "drop_acl",
                           "drop_no_route", "punt", "drop_nat",
                           "sess_insert_fail", "natsess_insert_fail",
                           "dnat", "snat", "nat_reversed",
                           "sess_hits", "fastpath",
                           "sess_evict_expired", "sess_evict_victim",
                           "natsess_evict_expired",
                           "natsess_evict_victim",
                           "ml_scored", "ml_flagged", "ml_drops",
                           "tel_sketched", "tnt_limited", "tnt_qfail",
                           "ovl_decap", "ovl_encap", "drop_overlay")
        }
        # gauges, not counters: last-step snapshots
        self._last: Dict[str, int] = {
            "sess_occupancy": 0, "natsess_occupancy": 0,
        }
        self.if_gauges = {
            name: self.registry.register(STATS_PATH, Gauge(name, help_))
            for name, help_ in PER_IF_GAUGES
        }
        self.node_gauges = {
            name: self.registry.register(STATS_PATH, Gauge(name, help_))
            for name, help_ in NODE_GAUGES
        }
        self.pump = None  # set_pump(): IO pump counters -> gauges
        self.pump_gauges = {
            name: self.registry.register(STATS_PATH, Gauge(name, help_))
            for name, help_ in PUMP_GAUGES
        }
        # multi-tenant gateway families (ISSUE 14): per-tenant
        # labelled gauges fed by Dataplane.tenant_snapshot() (device
        # planes, [T] ints) + DataplanePump.tenant_io_snapshot()
        # (host-side lane counters)
        self.tenant_gauges = {
            name: self.registry.register(STATS_PATH, Gauge(name, help_))
            for name, help_ in TENANT_GAUGES
        }
        # labelsets exported on the previous publish, per family group:
        # a deleted tenant's series must be REMOVED (the build_info
        # stale-labelset discipline), or dashboards show a ghost
        # tenant frozen at its last values forever
        self._tenant_pub_tids: set = set()
        self._tenant_io_pub_tids: set = set()
        # the real distribution behind the p50/p99 gauges (kept for
        # compatibility): the pump observes every batch's dispatch→tx
        # latency directly, so histogram_quantile() aggregates across
        # nodes where a pre-computed quantile gauge cannot
        self.pump_batch_hist = self.registry.register(
            STATS_PATH,
            Histogram(
                "vpp_tpu_pump_batch_seconds",
                "dispatch-to-tx batch latency of the IO pump",
                buckets=PUMP_LATENCY_BUCKETS,
            ),
        )
        # the fast-tier slice of the distribution above: only batches
        # the classify-free kernel served observe here, so the two
        # histograms side by side ARE the measured two-tier split
        self.fastpath_batch_hist = self.registry.register(
            STATS_PATH,
            Histogram(
                "vpp_tpu_fastpath_batch_seconds",
                "dispatch-to-tx latency of batches served by the "
                "classify-free established-flow fast path",
                buckets=PUMP_LATENCY_BUCKETS,
            ),
        )
        # one labelled counter family for the per-stage cumulative
        # seconds: stage="pack|dispatch|fetch_wait|fetch|write" — a
        # counter so rate() yields per-second stage occupancy, which
        # is how the overlap is OBSERVED (fetch_wait >> fetch with the
        # ladder healthy; fetch_wait collapsing into the writer's
        # critical path shows up as pump latency instead)
        self.pump_stage_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_pump_stage_seconds",
                  "cumulative seconds spent per pump pipeline stage",
                  kind="counter"),
        )
        # info-style selection gauge: 1 on the impl the live epoch
        # classifies with (Dataplane._refresh_selection at every swap),
        # 0 on the others — `sum by (impl)` across a fleet counts the
        # nodes on each path
        self.classifier_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_acl_classifier",
                  "selected global ACL classifier implementation "
                  "(info-style: impl label, 1 = active)"),
        )
        # set-associative session-table pressure (ISSUE 6): the insert
        # failure and eviction counters the operator watches to size
        # sess_slots/sess_ways. ``..._insert_failed_total`` carries the
        # true-congestion signal per table; ``..._evictions_total``
        # splits reclamation by {table, reason=expired|victim} — a
        # rising victim rate means live sessions are being pushed out
        # (grow the table), a rising expired rate is benign idle churn.
        self.sess_insert_failed_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_session_insert_failed_total",
                  "session inserts that found no slot this batch "
                  "(intra-batch way-election loss; the flow retries "
                  "on its next packet), by table",
                  kind="counter"),
        )
        self.sess_evictions_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_session_evictions_total",
                  "session ways reclaimed by insert-time eviction, "
                  "by table and reason (expired = idle timeout, "
                  "victim = full bucket evicted its oldest entry)",
                  kind="counter"),
        )
        # runtime capture guard (pipeline/capture.py, the reference's
        # jit-compile guard): step programs captured per part label,
        # labelled step=. The capture-once contract makes the healthy
        # steady state a flat 1 per live label; rate() > 0 after warmup
        # is a recapture happening in production.
        self.jit_compiles_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_jit_compiles_total",
                  "pipeline-step program captures per step variant "
                  "(process-wide; >1 per variant+shape means the "
                  "compile-once contract broke)",
                  kind="counter"),
        )
        # runtime device-transfer guard (pipeline/dataplane.py
        # _TRANSFER_BYTES, ISSUE 20): device->host bytes fetched per
        # approved site, labelled site=. The serving-path sites
        # (pump.fetch.*, ring.window) must grow rider/descriptor-sized
        # per window; a table-column-scale rate() here is the PR-6/8/12
        # "aggregate on host" regression class happening live.
        self.transfer_bytes_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_device_transfer_bytes_total",
                  "device->host bytes fetched per approved transfer "
                  "site (process-wide; the static --transfers pass "
                  "pins WHERE, this counts HOW MUCH)",
                  kind="counter"),
        )
        # drops by cause (packets): the pump contributes tx_stall +
        # shutdown, the IO daemon rx_full (set_io_daemon) — together
        # they attribute every persistent-path loss the r5 goodput
        # number hid
        self.pump_drops_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_pump_drops_total",
                  "packets dropped on the IO path, by cause "
                  "(rx_full = rx-ring overflow at the daemon, "
                  "tx_stall = tx-ring full at the writer, "
                  "shutdown = abandoned mid-flight by stop(), "
                  "error = dispatched but the device result never "
                  "came back)",
                  kind="counter"),
        )
        # resilience surface (ISSUE 8): degraded components, kvstore
        # staleness, snapshot age/progress/restore outcomes
        self.degraded_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_degraded",
                  "degraded-mode flags by component (1 = degraded: "
                  "kvstore = store unreachable, serving the "
                  "last-adopted epoch; ring = persistent pump fell "
                  "back to dispatch mode; snapshot = last snapshot "
                  "attempt failed)"),
        )
        self.kv_staleness_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_kvstore_staleness_seconds",
                  "seconds the served config may lag the cluster "
                  "store (0 while connected; time since disconnect "
                  "while degraded)"),
        )
        self.snapshot_age_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_snapshot_age_seconds",
                  "age of the last durable session-snapshot "
                  "generation (-1 = none published yet)"),
        )
        self.snapshot_chunk_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_snapshot_chunk_seconds",
                  "cumulative seconds spent draining + writing "
                  "session snapshot chunks (off the hot path)",
                  kind="counter"),
        )
        self.snapshot_gen_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_snapshot_generation",
                  "last durable session-snapshot generation number"),
        )
        self.snapshot_restore_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_snapshot_restore_total",
                  "session restore attempts by outcome (restored = "
                  "warm start; every refusal reason is its own label "
                  "and cold-starts cleanly)",
                  kind="counter"),  # _total => counter exposition
        )
        # per-packet ML stage (ISSUE 10): live mode (info-style, like
        # the classifier gauge), the staged model's version, and the
        # loader's refusal ledger — a refused artifact is a counted
        # outcome + the ml degraded component, never a silent keep
        self.ml_stage_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_ml_stage",
                  "live ML-stage mode (info-style: mode label, 1 = "
                  "active; off while no model is staged)"),
        )
        self.ml_model_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_ml_model_version",
                  "version of the ML model the live epoch scores "
                  "with (0 = none staged)"),
        )
        self.ml_load_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_ml_load_total",
                  "ML model load attempts by outcome (loaded = "
                  "published; every refusal reason is its own label "
                  "and keeps the previous model serving)",
                  kind="counter"),
        )
        # reflex-plane latency governor (ISSUE 13; io/governor.py):
        # one gauge per control-loop scalar (the GOVERNOR_STAT_GAUGES
        # map — counters lint keeps it in lockstep with the
        # governor's snapshot), the mode info gauge (off with no
        # governor attached), and the labelled adjustment/transition
        # counters. The wedged flag rides vpp_tpu_degraded.
        self.governor_gauges = {
            name: self.registry.register(
                STATS_PATH,
                Gauge(name, help_,
                      kind=("counter" if name.endswith("_total")
                            else "gauge")))
            for _key, name, help_ in GOVERNOR_STAT_GAUGES
        }
        self.governor_mode_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_governor_mode",
                  "latency-governor operating mode (info-style: mode "
                  "label, 1 = active; off = no governor attached; "
                  "brownout = shedding bulk admission)"),
        )
        self.governor_adjust_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_governor_adjustments_total",
                  "window-shape ladder steps taken by the governor, "
                  "by direction (down = toward the lone-frame floor)",
                  kind="counter"),
        )
        self.governor_transitions_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_governor_transitions_total",
                  "governor state-machine transitions, by mode "
                  "entered (normal/brownout/recovery)",
                  kind="counter"),
        )
        # device-resident telemetry plane (ISSUE 11; ops/telemetry.py):
        # the wire-latency native histogram (exact log2 bucket
        # boundaries of the device bins — the last device bin is the
        # saturating overflow and maps to +Inf), the quantile gauges
        # derived from the bins at collect, the heavy-hitter candidate
        # counts, and the mode info gauge. The family registers at the
        # CONFIG's bucket geometry even while the knob is off (a
        # TYPE-only family until the first snapshot), so scrapers see
        # a stable surface.
        from vpp_tpu_torch.ops.telemetry import bucket_bounds_seconds
        from vpp_tpu_torch.stats.prometheus import DeviceHistogram

        nb = int(getattr(dataplane.config, "telemetry_lat_buckets", 24))
        self._tel_nb = nb
        self.wire_latency_hist = self.registry.register(
            STATS_PATH,
            DeviceHistogram(
                "vpp_tpu_wire_latency_seconds",
                "per-packet wire latency (rx-enqueue stamp to device "
                "tx-append) measured INSIDE the fused step by the "
                "device telemetry plane; exact log2 bucket boundaries "
                "of the on-device bins",
                bounds=bucket_bounds_seconds(nb),
            ),
        )
        self.wire_latency_gauges = {
            q: self.registry.register(
                STATS_PATH,
                Gauge(f"vpp_tpu_wire_latency_{q}_us",
                      f"{q} per-packet wire latency (µs), derived "
                      f"from the device log2 bins at collect time"))
            for q in ("p50", "p99", "p999")
        }
        self.flow_top_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_flow_sketch_top_count",
                  "estimated packet count of each heavy-hitter "
                  "candidate slot (count-min estimate; rank label is "
                  "the slot index, not a sorted order)"),
        )
        self.flow_sketched_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_flow_sketch_updates_total",
                  "packets folded into the device count-min flow "
                  "sketch since start (cumulative device scalar)",
                  kind="counter"),
        )
        self.telemetry_mode_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_telemetry",
                  "device-telemetry plane mode (info-style: mode "
                  "label, 1 = active; off compiles the plane out)"),
        )
        # FIB routing surface (ISSUE 15; ops/lpm.py, ops/fib.py): the
        # impl info gauge (the classifier-gauge twin), route/scale
        # gauges, the route-churn commit-cost histogram (observed by
        # Dataplane.swap whenever a swap actually re-shipped FIB
        # state) and the per-member ECMP accounting family
        # (group=/member= labels; a deleted group's labelsets are
        # removed on the next publish — the tenant discipline).
        self.fib_impl_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_fib_impl",
                  "selected ip4-lookup implementation (info-style: "
                  "impl label, 1 = active; lpm = per-length "
                  "binary-search planes)"),
        )
        # per-op kernel rung selection (ISSUE 16): one info family for
        # all three gather-bound hot ops, labelled op=/impl= — the
        # pallas rows flip to 1 only on a TPU backend whose structure
        # gates pass (Dataplane.kernel_snapshot)
        self.kernel_impl_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_kernel_impl",
                  "selected kernel implementation per hot op "
                  "(info-style: op and impl labels, 1 = active; "
                  "pallas = the fused TPU kernel rung)"),
        )
        self.fib_routes_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_fib_routes",
                  "live routes staged in the FIB"),
        )
        self.fib_lengths_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_fib_populated_lengths",
                  "prefix lengths with at least one live route (the "
                  "LPM lookup walks populated lengths only)"),
        )
        self.fib_groups_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_fib_ecmp_groups",
                  "ECMP next-hop groups staged"),
        )
        self.fib_plane_bytes_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_fib_plane_bytes",
                  "device bytes allocated to the LPM per-length "
                  "prefix planes"),
        )
        self.fib_ecmp_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_fib_ecmp_packets",
                  "packets forwarded per ECMP group member (device "
                  "accounting plane, by group and member next-hop)",
                  kind="counter"),
        )
        self.fib_churn_hist = self.registry.register(
            STATS_PATH,
            Histogram(
                "vpp_tpu_fib_churn_commit_seconds",
                "host+upload cost of FIB-group commits that re-shipped "
                "route state (a flap should ship one length plane + a "
                "slot blob, bounded ms)",
                buckets=(0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0),
            ),
        )
        dataplane.fib_churn_hist = self.fib_churn_hist
        self._fib_pub_members: set = set()
        # sanity anchor for every scrape-side consumer: a constant-1
        # info gauge carrying the build/runtime identity labels
        # (ISSUE 11 satellite). Published per collect so the
        # classifier label tracks the live selection.
        self.build_info_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_build_info",
                  "build/runtime identity (info-style: constant 1 "
                  "with version/torch/device/classifier labels)"),
        )
        self._build_labels: Optional[Dict[str, str]] = None
        # partition-rule layer (ISSUE 12): the resolved placement of
        # every DataplaneTables field (info-style; the axis label says
        # which mesh axis shards it — "replicated" for the
        # replicated-by-design ledger) + per-shard capacity/occupancy
        # when a cluster handle is attached (set_cluster)
        self.partition_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_partition_info",
                  "partition-rule placement of each dataplane table "
                  "field (info-style: field/axis/shards labels, "
                  "constant 1)"),
        )
        self.shard_sessions_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_shard_sessions_resident",
                  "live reflective sessions resident in each rule "
                  "shard's bucket range (summed across nodes)"),
        )
        self.shard_rule_bytes_gauge = self.registry.register(
            STATS_PATH,
            Gauge("vpp_tpu_shard_rule_plane_bytes",
                  "device bytes of rule-axis-sharded classifier/ML "
                  "planes held per rule shard (summed across nodes)"),
        )
        self._cluster = None  # set_cluster: the mesh this node is in
        # degraded-state sources: the cluster store (set_store), the
        # snapshotter (set_snapshotter) and the ML model source
        # (set_ml); the pump is already attached via set_pump
        self._store = None
        self._snapshotter = None
        self._ml_source = None
        # optional IO-daemon stats source (a callable returning the
        # daemon's stats dict, or the IODaemon itself when it runs
        # in-process): feeds the rx_full drop cause. The fetched value
        # is cached with a failure backoff so a wedged daemon can't
        # stall every Prometheus scrape for its RPC timeout.
        self._io_daemon_stats = None
        self._daemon_drops_cache = 0
        self._daemon_retry_at = 0.0
        self.vcl = None  # set_vcl(): admission counters -> gauges
        self.vcl_gauges = {
            name: self.registry.register(STATS_PATH, Gauge(name, help_))
            for name, help_ in VCL_GAUGES
        }
        # gateway fleet (ISSUE 18): registered unconditionally from
        # the ONE declaration the --counters parity pass checks
        self.fleet_gauges = {
            name: self.registry.register(
                STATS_PATH, Gauge(name, help_, kind=kind))
            for name, help_, kind in FLEET_GAUGE_FAMILIES
        }
        self._fleet = None
        self._fleet_pump = None
        self._fleet_pub_insts: set = set()
        self._known_labels: Dict[int, Dict[str, str]] = {}
        self._publish_lock = threading.Lock()
        # zero accumulators when an interface slot is freed, so a later
        # pod reusing the slot doesn't inherit the old pod's counters
        dataplane.on_if_freed.append(self.reset_interface)

    def set_pump(self, pump) -> None:
        """Attach the IO pump (DataplanePump or the mesh ClusterPump —
        same stats contract) so publish() exports its counters, and
        point its per-batch latency observer at our histogram."""
        self.pump = pump
        try:
            pump.latency_hist = self.pump_batch_hist
            pump.fastpath_hist = self.fastpath_batch_hist
        except AttributeError:
            pass  # exotic pump stand-ins (slotted fakes) keep gauges only

    def set_io_daemon(self, daemon_or_fn) -> None:
        """Attach an IO-daemon stats source (the in-process IODaemon,
        or a callable returning its stats dict — e.g. an IO-control
        client's ``stats``) so publish() exports the daemon-side
        rx_full drop cause on ``vpp_tpu_pump_drops_total``."""
        if callable(daemon_or_fn):
            self._io_daemon_stats = daemon_or_fn
        else:
            self._io_daemon_stats = lambda: dict(daemon_or_fn.stats)

    def set_store(self, store) -> None:
        """Attach the cluster store so publish() exports its
        reachability (``vpp_tpu_degraded{component="kvstore"}``) and
        staleness. In-process stores have neither attribute and read
        as always healthy."""
        self._store = store

    def set_snapshotter(self, snapshotter) -> None:
        """Attach the SessionSnapshotter (pipeline/snapshot.py) so
        publish() exports snapshot age, generation, chunk time and
        restore outcomes."""
        self._snapshotter = snapshotter

    def set_ml(self, source) -> None:
        """Attach the MlModelSource (vpp_tpu/ml/loader.py) so
        publish() exports load outcomes and the ml degraded
        component. The stage/version gauges publish from the
        dataplane regardless — in-process model staging (tests, the
        bench) is visible without a loader."""
        self._ml_source = source

    def set_vcl(self, server) -> None:
        """Attach the VclAdmissionServer so publish() exports its
        admission counters."""
        self.vcl = server

    def set_cluster(self, cluster) -> None:
        """Attach the ClusterDataplane (vpp_tpu_torch/parallel/cluster.py)
        so publish() exports the per-shard session residency and
        rule-plane bytes of the mesh this node is part of; the partition
        info gauge then reports the mesh's shard count instead of 1."""
        self._cluster = cluster

    def set_fleet(self, steering, pump=None) -> None:
        """Attach the fleet steering tier (vpp_tpu_torch/fleet/steering.py)
        and optionally its FleetPump so publish() exports the
        steering/migration surface: instance and range counts, fenced
        ranges, the epoch high-water, migration counters, per-instance
        steered packets and queue depth, and the attributed drop-cause
        family the conservation identity rests on."""
        self._fleet = steering
        self._fleet_pump = pump

    def reset_interface(self, if_idx: int) -> None:
        with self._lock:
            for arr in self._acc.values():
                arr[if_idx] = 0

    # --- ingestion (called after each processed frame) ---
    def update(self, stats: StepStats) -> None:
        # the counters to the host once, outside the lock
        host = {}
        for k in (*self._acc, *self._totals, *self._last):
            v = getattr(stats, k)
            host[k] = np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                 else v, np.int64)
        with self._lock:
            for k in self._acc:
                self._acc[k] += host[k]
            for k in self._totals:
                self._totals[k] += int(host[k])
            for k in self._last:
                self._last[k] = int(host[k])

    def totals_snapshot(self) -> Dict[str, int]:
        """Consistent copy of the node-level counters (CLI/debug use)."""
        with self._lock:
            return dict(self._totals)

    # --- label resolution ---
    def _labels_for(self, if_idx: int) -> Optional[Dict[str, str]]:
        if self.index is not None:
            cfg = self.index.lookup_if(if_idx)
            if cfg is not None:
                return {
                    "podName": cfg.pod_name,
                    "podNamespace": cfg.pod_namespace,
                    "interfaceName": cfg.if_name,
                }
        pod = self.dp.if_pod.get(if_idx)
        if pod is not None:
            return {
                "podName": pod[1], "podNamespace": pod[0],
                "interfaceName": f"if{if_idx}",
            }
        if if_idx == self.dp.uplink_if:
            return {"podName": "", "podNamespace": "",
                    "interfaceName": "uplink"}
        if if_idx == self.dp.host_if:
            return {"podName": "", "podNamespace": "", "interfaceName": "host"}
        return None

    # --- publication (periodic, or before scrape; serialized) ---
    def publish(self) -> None:
        with self._publish_lock:
            self._publish_locked()

    def _publish_locked(self) -> None:
        with self._lock:
            acc = {k: v.copy() for k, v in self._acc.items()}
            totals = dict(self._totals)
        live: Dict[int, Dict[str, str]] = {}
        for if_idx in range(acc["if_rx"].shape[0]):
            labels = self._labels_for(if_idx)
            if labels is None:
                continue
            live[if_idx] = labels
            self.if_gauges["vpp_tpu_if_in_packets"].set(
                int(acc["if_rx"][if_idx]), **labels)
            self.if_gauges["vpp_tpu_if_out_packets"].set(
                int(acc["if_tx"][if_idx]), **labels)
            self.if_gauges["vpp_tpu_if_in_bytes"].set(
                int(acc["if_rx_bytes"][if_idx]), **labels)
            self.if_gauges["vpp_tpu_if_out_bytes"].set(
                int(acc["if_tx_bytes"][if_idx]), **labels)
            self.if_gauges["vpp_tpu_if_drop_packets"].set(
                int(acc["if_drops"][if_idx]), **labels)
            if if_idx == self.dp.host_if:
                self.if_gauges["vpp_tpu_if_punt_packets"].set(
                    totals["punt"], **labels)
        # drop gauges of interfaces whose pod went away
        for if_idx, labels in self._known_labels.items():
            if if_idx not in live or live[if_idx] != labels:
                for g in self.if_gauges.values():
                    g.remove(**labels)
        self._known_labels = live

        self.node_gauges["vpp_tpu_node_rx_packets"].set(totals["rx"])
        self.node_gauges["vpp_tpu_node_tx_packets"].set(totals["tx"])
        self.node_gauges["vpp_tpu_node_drop_ip4"].set(totals["drop_ip4"])
        self.node_gauges["vpp_tpu_node_drop_acl"].set(totals["drop_acl"])
        self.node_gauges["vpp_tpu_node_drop_no_route"].set(totals["drop_no_route"])
        self.node_gauges["vpp_tpu_node_drop_nat"].set(totals["drop_nat"])
        self.node_gauges["vpp_tpu_node_sess_insert_fail"].set(
            totals["sess_insert_fail"])
        self.node_gauges["vpp_tpu_node_natsess_insert_fail"].set(
            totals["natsess_insert_fail"])
        self.node_gauges["vpp_tpu_node_dnat_packets"].set(totals["dnat"])
        self.node_gauges["vpp_tpu_node_snat_packets"].set(totals["snat"])
        self.node_gauges["vpp_tpu_node_nat_reversed_packets"].set(
            totals["nat_reversed"])
        self.node_gauges["vpp_tpu_pipeline_sess_hits"].set(
            totals["sess_hits"])
        self.node_gauges["vpp_tpu_pipeline_fastpath_steps"].set(
            totals["fastpath"])
        self.node_gauges["vpp_tpu_ml_scored_packets"].set(
            totals["ml_scored"])
        self.node_gauges["vpp_tpu_ml_flagged_packets"].set(
            totals["ml_flagged"])
        self.node_gauges["vpp_tpu_ml_dropped_packets"].set(
            totals["ml_drops"])
        self.node_gauges["vpp_tpu_flow_sketch_packets"].set(
            totals["tel_sketched"])
        self.node_gauges["vpp_tpu_node_tenant_limited_packets"].set(
            totals["tnt_limited"])
        self.node_gauges["vpp_tpu_node_tenant_quota_fail_packets"].set(
            totals["tnt_qfail"])
        self.node_gauges["vpp_tpu_node_overlay_decap_packets"].set(
            totals["ovl_decap"])
        self.node_gauges["vpp_tpu_node_overlay_encap_packets"].set(
            totals["ovl_encap"])
        self.node_gauges["vpp_tpu_node_drop_overlay"].set(
            totals["drop_overlay"])
        self.sess_insert_failed_gauge.set(
            totals["sess_insert_fail"], table="sess")
        self.sess_insert_failed_gauge.set(
            totals["natsess_insert_fail"], table="natsess")
        for field, (table, reason) in EVICTION_LABELS.items():
            self.sess_evictions_gauge.set(
                totals[field], table=table, reason=reason)
        with self._lock:
            last = dict(self._last)
        self.node_gauges["vpp_tpu_node_sess_occupancy"].set(
            last["sess_occupancy"])
        self.node_gauges["vpp_tpu_node_natsess_occupancy"].set(
            last["natsess_occupancy"])
        if self.dp.tables is not None:
            # reduce ON device: sess_valid is [n_buckets, W] and ~67 MB
            # at the 10M-slot config — a periodic scrape must fetch one
            # scalar, not the column. Under the dataplane's lock: every
            # step writes the session tensors in place, so the count is
            # one whole step's state, never a step's half-written planes
            with self.dp._lock:
                # transfer-ok: one device reduction, one .item() per scrape
                active = int(self.dp.tables.sess_valid.sum().item())
            self.node_gauges["vpp_tpu_node_sessions_active"].set(active)
        impl = getattr(self.dp, "classifier_impl", "dense")
        for name in CLASSIFIER_IMPLS:
            self.classifier_gauge.set(
                1.0 if name == impl else 0.0, impl=name)
        # per-op kernel rung selection (ISSUE 16): host scalars from
        # the selection ladder state, no device sync
        kern_fn = getattr(self.dp, "kernel_snapshot", None)
        kern = kern_fn() if callable(kern_fn) else None
        if kern is not None:
            for op, impls in KERNEL_IMPL_OPS.items():
                live = (kern.get(op) or {}).get("impl")
                for name in impls:
                    self.kernel_impl_gauge.set(
                        1.0 if name == live else 0.0, op=op, impl=name)
        # FIB routing surface (ISSUE 15): selection, scale, per-member
        # ECMP accounting — host scalars + one small [G, W] fetch
        fib_fn = getattr(self.dp, "fib_snapshot", None)
        fib = fib_fn() if callable(fib_fn) else None
        if fib is not None:
            from vpp_tpu_torch.pipeline.vector import ip4_str

            for name in FIB_IMPLS:
                self.fib_impl_gauge.set(
                    1.0 if name == fib["impl"] else 0.0, impl=name)
            self.fib_routes_gauge.set(float(fib["routes"]))
            self.fib_lengths_gauge.set(float(len(fib["by_length"])))
            self.fib_groups_gauge.set(float(len(fib["ecmp_groups"])))
            self.fib_plane_bytes_gauge.set(float(fib["plane_bytes"]))
            pub = set()
            for gid, members in fib["ecmp_groups"].items():
                for m in members:
                    # the FULL member identity labels the series —
                    # two members sharing (ip, if) but not node must
                    # not collapse into one labelset
                    labels = (str(gid),
                              f"{ip4_str(m['nh'])}:if{m['tx_if']}"
                              f":n{m['node']}")
                    pub.add(labels)
                    self.fib_ecmp_gauge.set(
                        float(m["pkts"]),
                        group=labels[0], member=labels[1])
            # a withdrawn group/member's series must disappear, not
            # freeze at its last count (the tenant/build_info rule)
            for group, member in self._fib_pub_members - pub:
                self.fib_ecmp_gauge.remove(group=group, member=member)
            self._fib_pub_members = pub
        # partition-rule layer: field placements from the ONE manifest;
        # per-shard residency and bytes only with a live cluster
        # attached (scalars cross to the host, never columns)
        from vpp_tpu_torch.parallel.partition import RULE_AXIS, spec_manifest

        cluster = self._cluster
        shards = int(getattr(cluster, "rule_shards", 1) or 1)
        for f, entry in spec_manifest().items():
            # the mesh's effective spec: a BV word axis that cannot
            # shard, an ML stage that is off, replicate those planes
            spec = (getattr(cluster.specs, f) if cluster is not None
                    else entry.spec)
            self.partition_gauge.set(
                1.0, field=f,
                axis=RULE_AXIS if RULE_AXIS in tuple(spec) else "replicated",
                shards=str(shards))
        if cluster is not None and cluster.tables is not None:
            resident = cluster.shard_sessions_resident()
            plane_bytes = cluster.shard_rule_plane_bytes()
            for s in range(shards):
                self.shard_sessions_gauge.set(float(resident[s]),
                                              shard=str(s))
                self.shard_rule_bytes_gauge.set(float(plane_bytes[s]),
                                                shard=str(s))
        # ML stage (ISSUE 10): live mode + the LIVE epoch's model
        # version (read off the published tables ref — immutable, so
        # no race with a load staging a model the swap hasn't
        # published yet; the builder's staging state is NOT consulted
        # here for exactly that reason); load ledger + degraded flag
        # from the loader
        ml_mode = getattr(self.dp, "_ml_mode", "off")
        for name in ML_STAGE_MODES:
            self.ml_stage_gauge.set(
                1.0 if name == ml_mode else 0.0, mode=name)
        tables = self.dp.tables
        self.ml_model_gauge.set(
            # transfer-ok: glb_ml_version is a device SCALAR, not a column
            float(int(tables.glb_ml_version))
            if tables is not None and ml_mode != "off" else 0.0)
        ml_src = self._ml_source
        self.degraded_gauge.set(
            1.0 if getattr(ml_src, "degraded", False) else 0.0,
            component="ml")
        if ml_src is not None:
            for outcome, n in ml_src.stats_snapshot()["outcomes"].items():
                self.ml_load_gauge.set(float(n), outcome=outcome)
        from vpp_tpu_torch.pipeline.capture import capture_totals
        from vpp_tpu_torch.pipeline.transfer import device_transfer_totals

        # the captured step programs stand for the reference's jit
        # compiles (one capture per variant and shape is the contract)
        for label, n in capture_totals().items():
            self.jit_compiles_gauge.set(float(n), step=label)
        for site, n in device_transfer_totals().items():
            self.transfer_bytes_gauge.set(float(n), site=site)
        # build-info anchor (ISSUE 11 satellite): constant 1, identity
        # labels. The classifier label follows the live selection —
        # on a change the previous label set is removed so exactly one
        # series ever reads 1.
        from vpp_tpu_torch import __version__ as _version
        build_labels = {
            "version": _version,
            "torch": torch.__version__,
            "device": self.dp.device.type,
            "classifier": impl,
        }
        if self._build_labels is not None \
                and self._build_labels != build_labels:
            self.build_info_gauge.remove(**self._build_labels)
        self.build_info_gauge.set(1.0, **build_labels)
        self._build_labels = build_labels
        # device telemetry plane (ISSUE 11): mode info gauge always;
        # bins/quantiles/top-K only once a snapshot exists. Persistent
        # pumps serve the ring-rider snapshot (no device transfer at
        # collect); otherwise the dataplane fetches its small planes.
        tel_mode = getattr(self.dp, "_tel_mode", "off")
        for name in TELEMETRY_MODES:
            self.telemetry_mode_gauge.set(
                1.0 if name == tel_mode else 0.0, mode=name)
        tel = None
        tel_fn = getattr(self.pump, "tel_snapshot", None)
        if callable(tel_fn):
            tel = tel_fn()
        if tel is None:
            tel_fn = getattr(self.dp, "telemetry_snapshot", None)
            tel = tel_fn() if callable(tel_fn) else None
        if tel is not None:
            from vpp_tpu_torch.ops.telemetry import (
                approx_sum_us,
                quantiles_from_bins,
            )

            bins = tel["bins"]
            if len(bins) == self._tel_nb:
                self.wire_latency_hist.set_bins(
                    bins, approx_sum_us(bins) / 1e6)
            p50, p99, p999 = quantiles_from_bins(bins)
            self.wire_latency_gauges["p50"].set(p50)
            self.wire_latency_gauges["p99"].set(p99)
            self.wire_latency_gauges["p999"].set(p999)
            self.flow_sketched_gauge.set(float(tel["sketched"]))
            for rank, cnt in enumerate(tel["top_cnt"]):
                self.flow_top_gauge.set(float(cnt), rank=str(rank))
        # multi-tenant gateway mode (ISSUE 14): per-tenant device
        # planes (accounting, bucket fill, slice occupancy/quota) +
        # the pump's lane counters — only tenants the registry names
        # export, so the label space stays bounded
        tnt_fn = getattr(self.dp, "tenant_snapshot", None)
        tnt = tnt_fn() if callable(tnt_fn) else None
        if tnt is not None:
            g = self.tenant_gauges
            # tenant 0 always exports: the implicit default sink for
            # unmatched traffic — often the dominant share — must not
            # vanish from dashboards the moment real tenants register
            for tid in sorted(set(tnt["tenants"]) | {0}):
                lbl = {"tenant": str(tid)}
                g["vpp_tpu_tenant_rx_packets"].set(
                    float(tnt["rx"][tid]), **lbl)
                g["vpp_tpu_tenant_goodput_packets"].set(
                    float(tnt["tx"][tid]), **lbl)
                g["vpp_tpu_tenant_rl_dropped_packets"].set(
                    float(tnt["rl_drops"][tid]), **lbl)
                g["vpp_tpu_tenant_quota_fail_packets"].set(
                    float(tnt["quota_fails"][tid]), **lbl)
                g["vpp_tpu_tenant_bucket_tokens"].set(
                    float(tnt["tokens"][tid]), **lbl)
                g["vpp_tpu_tenant_sess_occupancy"].set(
                    float(tnt["occupancy"][tid]), **lbl)
                g["vpp_tpu_tenant_sess_quota_slots"].set(
                    float(tnt["sess_quota_slots"][tid]), **lbl)
                g["vpp_tpu_tenant_weight"].set(
                    float(tnt["tenants"].get(tid, {}).get("weight", 1)),
                    **lbl)
            cur = set(tnt["tenants"]) | {0}
            for tid in self._tenant_pub_tids - cur:
                lbl = {"tenant": str(tid)}
                for name, _h in TENANT_PLANE_GAUGES:
                    g[name].remove(**lbl)
            self._tenant_pub_tids = cur
        io_fn = getattr(self.pump, "tenant_io_snapshot", None)
        if callable(io_fn):
            tio = io_fn()
            g = self.tenant_gauges
            for tid, io in sorted(tio["io"].items()):
                lbl = {"tenant": str(tid)}
                g["vpp_tpu_tenant_io_frames"].set(
                    float(io["frames"]), **lbl)
                g["vpp_tpu_tenant_io_packets"].set(
                    float(io["pkts"]), **lbl)
                g["vpp_tpu_tenant_shed_packets"].set(
                    float(io["shed_pkts"]), **lbl)
            cur = set(tio["io"])
            for tid in self._tenant_io_pub_tids - cur:
                lbl = {"tenant": str(tid)}
                for name, _h in TENANT_IO_GAUGES:
                    g[name].remove(**lbl)
            self._tenant_io_pub_tids = cur
        # resilience surface (ISSUE 8): every component exports every
        # publish (0 = healthy) so dashboards alert on value, never on
        # series absence
        store = self._store
        kv_degraded = bool(getattr(store, "degraded", False))
        self.degraded_gauge.set(
            1.0 if kv_degraded else 0.0, component="kvstore")
        stale_fn = getattr(store, "staleness_s", None)
        self.kv_staleness_gauge.set(
            float(stale_fn()) if callable(stale_fn) else 0.0)
        self.degraded_gauge.set(
            1.0 if getattr(self.pump, "degraded_ring", False) else 0.0,
            component="ring")
        # latency governor (ISSUE 13): mode info gauge always (off
        # with no governor attached); scalars + labelled counters
        # when one is. Degraded ONLY when the control loop is wedged
        # — brownout is the governor WORKING, not failing.
        gov = getattr(self.pump, "governor", None)
        gov_mode = "off"
        gov_wedged = False
        if gov is not None:
            gs = gov.snapshot()
            gov_mode = gs["mode"]
            gov_wedged = bool(gs["wedged"])
            for key, name, _h in GOVERNOR_STAT_GAUGES:
                self.governor_gauges[name].set(float(gs[key]))
            for direction in ("up", "down"):
                self.governor_adjust_gauge.set(
                    float(gs[f"adjust_{direction}"]),
                    direction=direction)
            for m, n in gs["transitions"].items():
                self.governor_transitions_gauge.set(float(n), mode=m)
        for name in GOVERNOR_MODE_LABELS:
            self.governor_mode_gauge.set(
                1.0 if name == gov_mode else 0.0, mode=name)
        self.degraded_gauge.set(1.0 if gov_wedged else 0.0,
                                component="governor")
        snap = self._snapshotter
        self.degraded_gauge.set(
            1.0 if getattr(snap, "degraded", False) else 0.0,
            component="snapshot")
        if snap is not None:
            s = snap.stats_snapshot()
            self.snapshot_age_gauge.set(float(s["age_s"]))
            self.snapshot_chunk_gauge.set(float(s["chunk_seconds"]))
            self.snapshot_gen_gauge.set(float(s["generation"]))
            for outcome, n in s["restores"].items():
                self.snapshot_restore_gauge.set(
                    float(n), outcome=outcome)
        # classify-stage occupancy in the pump stage family: cumulative
        # seconds of the isolated classify probe
        # (Dataplane.time_classifier — the bench and operators drive
        # it; 0 until the first probe). Dataplane-owned, so published
        # even without a pump attached.
        self.pump_stage_gauge.set(
            float(getattr(self.dp, "classify_seconds", 0.0)),
            stage="classify")
        pump = self.pump
        # the drops-by-cause family publishes whenever EITHER source
        # exists: a mesh-mode agent attaches only the daemon stats
        # (set_pump goes to one designated collector cluster-wide),
        # and its rx_full overflow must still be visible
        if pump is not None or self._io_daemon_stats is not None:
            if self._io_daemon_stats is not None:
                import time as _t

                now = _t.monotonic()
                if now >= self._daemon_retry_at:
                    try:
                        self._daemon_drops_cache = int(
                            self._io_daemon_stats().get(
                                "drops_rx_full", 0))
                    except Exception:  # noqa: BLE001 — daemon may be
                        # down or wedged: serve the cached value and
                        # back off, so the scrape path pays the RPC
                        # timeout once per backoff window, not per
                        # scrape
                        self._daemon_retry_at = now + 30.0
            daemon_drops = self._daemon_drops_cache
            ps = pump.stats if pump is not None else {}
            for stat_key, reason in PUMP_DROP_REASONS:
                n = int(ps.get(stat_key, 0))
                if reason == "rx_full":
                    n += daemon_drops
                self.pump_drops_gauge.set(n, reason=reason)
        if pump is not None:
            ps = pump.stats
            for stat_key, gauge_name, _ in PUMP_STAT_GAUGES:
                self.pump_gauges[gauge_name].set(int(ps.get(stat_key, 0)))
            # full precision: rounding to 6 decimals quantized rate()
            # over short scrape windows (a 1 s window sees deltas well
            # below 1 µs per stage at light load)
            for stat_key, stage in PUMP_STAGE_SECONDS:
                self.pump_stage_gauge.set(
                    float(ps.get(stat_key, 0.0)), stage=stage)
            lat = pump.latency_us()
            self.pump_gauges["vpp_tpu_pump_batch_latency_p50_us"].set(
                lat["p50"])
            self.pump_gauges["vpp_tpu_pump_batch_latency_p99_us"].set(
                lat["p99"])
            # derived, not raw: percentage of alive packets riding
            # established sessions (0 when the pump hasn't seen traffic)
            alive = int(ps.get("fastpath_alive", 0))
            hits = int(ps.get("fastpath_hits", 0))
            self.pump_gauges["vpp_tpu_pump_fastpath_hit_pct"].set(
                100.0 * hits / alive if alive else 0.0)
        vcl = self.vcl
        if vcl is not None:
            vs = dict(vcl.stats)
            for key in ("connect_checks", "connect_denies",
                        "accept_checks", "accept_denies", "clients"):
                self.vcl_gauges[f"vpp_tpu_vcl_{key}"].set(
                    int(vs.get(key, 0)))
        # gateway fleet (ISSUE 18): steering/migration surface from
        # the attached tier's host counters — no device traffic
        fleet = self._fleet
        if fleet is not None:
            self._publish_fleet(fleet.stats_snapshot())

    def _publish_fleet(self, fs) -> None:
        g = self.fleet_gauges
        for name, key in (
                ("instances", "instances"), ("ranges", "ranges"),
                ("fenced_ranges", "fenced_ranges"),
                ("epoch_max", "epoch_max"),
                ("rebalances_total", "rebalances"),
                ("migrated_ranges_total", "migrated_ranges"),
                ("migrated_sessions_total", "migrated_sessions"),
                ("nat_coldstarts_total", "nat_coldstarts")):
            g[f"vpp_tpu_fleet_{name}"].set(float(fs[key]))
        fpump = self._fleet_pump
        psnap = fpump.stats_snapshot() if fpump is not None else None
        queue_drops = (sum(psnap["queue_drops"].values())
                       if psnap is not None else 0)
        pub = set()
        for inst, n in fs["steered"].items():
            pub.add(inst)
            g["vpp_tpu_fleet_steered_total"].set(float(n), instance=inst)
            depth = 0
            if psnap is not None:
                depth = (psnap["submitted"].get(inst, 0)
                         - psnap["delivered"].get(inst, 0)
                         + psnap["buffered"].get(inst, 0))
            g["vpp_tpu_fleet_queue_depth"].set(float(depth), instance=inst)
        # a departed instance's series must disappear, not freeze at its
        # last count (the tenant/ECMP rule)
        for inst in self._fleet_pub_insts - pub:
            g["vpp_tpu_fleet_steered_total"].remove(instance=inst)
            g["vpp_tpu_fleet_queue_depth"].remove(instance=inst)
        self._fleet_pub_insts = pub
        for cause, n in (("fenced", fs["fenced_drops"]),
                         ("no_owner", fs["no_owner_drops"]),
                         ("queue", queue_drops)):
            g["vpp_tpu_fleet_drops_total"].set(float(n), cause=cause)


def register_control_plane_metrics(
    registry: MetricsRegistry, path: str = STATS_PATH
) -> Dict[str, Histogram]:
    """The control-plane latency histogram families (ISSUE 2 tentpole):

    * ``vpp_tpu_config_propagation_seconds`` — the config-propagation
      SLO: K8s/CNI event wall-clock → epoch-swap complete, labelled by
      the originating stage (``source="ksr"|"cni"|..."``). Observed by
      ``Dataplane.swap()`` whenever a swap publishes under an active
      span trace (trace/spans.py).
    * ``vpp_tpu_txn_commit_seconds`` — every epoch swap's publish
      duration (stage + device upload + journal record).
    * ``vpp_tpu_cni_request_seconds`` — CNI Add/Delete handling,
      labelled ``op="add"|"del"``.

    Returns the histograms keyed by short name; the agent attaches them
    to the dataplane / CNI server."""
    hists = {
        "config_propagation": Histogram(
            "vpp_tpu_config_propagation_seconds",
            "config propagation latency: NB event to epoch-swap "
            "complete, labelled by originating stage",
        ),
        "txn_commit": Histogram(
            "vpp_tpu_txn_commit_seconds",
            "config transaction commit (epoch swap publish) duration",
        ),
        "cni_request": Histogram(
            "vpp_tpu_cni_request_seconds",
            "CNI request handling duration by op (add/del)",
        ),
    }
    for h in hists.values():
        registry.register(path, h)
    return hists


def register_ksr_gauges(
    registry: MetricsRegistry, ksr_registry, path: str = "/metrics"
) -> Tuple[Dict[str, Gauge], callable]:
    """KSR per-reflector gauges (ksr_statscollector.go:109-160): one gauge
    per counter, labelled by reflector name. Returns (gauges, publish);
    call publish() to refresh from the live reflector stats."""
    gauges = {
        name: registry.register(
            path, Gauge(f"vpp_tpu_ksr_{name}", f"KSR reflector {name} count")
        )
        for name in (
            "adds", "updates", "deletes", "resyncs",
            "add_errors", "upd_errors", "del_errors", "arg_errors",
        )
    }

    def publish():
        for refl_name, stats in ksr_registry.stats().items():
            for counter, value in stats.items():
                if counter in gauges:
                    gauges[counter].set(value, reflector=refl_name)

    return gauges, publish
