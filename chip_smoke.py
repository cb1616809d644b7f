#!/usr/bin/env python3
"""Drive vpp_tpu_torch on one CUDA card: build, check, run, time.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout on a machine with one NVIDIA Hopper
card (H100), the CUDA toolkit (``nvcc``) and PyTorch built for CUDA. It
imports torch, numpy and vpp_tpu_torch only, and exits nonzero without
a result line when no CUDA device is present. Its phases, each of which
raises on failure:

1. the card: torch's device name, and nvidia-smi's name and power limit;
2. build: every ``vpp_tpu_torch/csrc/*.cu`` compiled for sm_90a, one
   ``nvcc`` per source, all started together, into ``csrc/build/``;
3. each kernel against its plain PyTorch version on the card, bit-exact,
   at edge shapes and at the slice's shapes on random data
   (``sess_probe_ways`` on header columns with high addresses and
   address ties, both bucket hashes, W = 1, 2, 4, 16, columns off a
   16-byte boundary and the slice's 2^18-bucket table at P = 256, 4,095
   and 4,096; ``bv_first_set`` on header columns at, next to and off
   the boundaries of tables with partial live counts, the global
   20,482 x 320 shape and 16 local 258 x 4 tables with interfaces that
   have none; ``mxu_first_match`` on header columns and tables compiled from
   random exact-port rules, an all-miss table and tables where many
   rules match each packet, at P and R' on and off its 128-packet and
   128-rule tiles; ``lpm_fused_lookup`` also on stacks whose live set
   is exactly its shared-memory budget, one entry over it, and far over
   it, so that both sides of the kernel's on-device choice run;
   ``ml_score`` (the ML stage, ``mlscore.ml_stage``) on random weights,
   all-zero weights, a single-feature model, the flag threshold at
   INT32_MIN / INT32_MAX, wrapping biases and shifts past 31, each of
   the four actions, MLP and forest, at P = 1, 33, 256, 4,095, 4,096,
   and a model past 48 KB of shared memory); and the tenant forms:
   ``sess_probe_ways`` with each packet's key tenant slicing its bucket
   (mixed slices, an unsliced residual, key tenants 0 and T - 1, keys
   of differing tenants, both hashes, W = 1, 2, 4, 16, P = 1, 4,095,
   4,096) and ``ml_score`` with a tenant id per packet (each per-tenant
   ML mode, the inherit sentinel and threshold overrides);
4. the main path: the slice's full-size ``Dataplane`` on the card
   (10,240 global rules, 8 pods on 128-rule local tables, 2^20 session
   slots, ~4,000 routes, a 100-backend ClusterIP; the ``pallas`` rungs,
   fast path off), its steps replayed from captured CUDA graphs (the
   step program cache, pipeline/capture.py), runs forward vectors of
   256 and 4,096 packets (the
   bench traffic mix, 1/8 to the VIP), each followed by two reply
   vectors through ``Dataplane.process``: the replies of the packets it
   forwarded (established flows) and those of the packets it dropped
   (fresh flows from the pods, which SNAT). The kernels' launch counters
   are zeroed just before and read just after; each of the path's must
   be > 0. The same staging and packets then run through
   ``Dataplane(device="cpu")``, which takes the plain versions: every
   StepResult field, every StepStats counter and the final session / NAT
   state must be equal. DNAT, reverse NAT, SNAT, session hits and ACL
   drops must each have fired. The first forward vector's ACL verdicts
   must equal the rule oracle (``ir.rule.rule_matches``) on its first
   packets;
4b. the MXU path at the same width: ``classifier: mxu`` with the fast
   path on (the two-tier dispatcher), driven with the same vectors.
   ``mxu_first_match``, ``sess_probe_ways`` and ``lpm_fused_lookup``
   must launch, ``bv_first_set`` must not; every reply to forwarded
   packets must ride the fast tier (``stats.fastpath`` 1), every
   forward vector and every reply to dropped packets the full chain
   (0); the CPU replay must be bit-exact, and every result field and
   the final state must equal phase 4's (the verdicts do not depend on
   the classifier) but for ``stats.fastpath``;
4c. eager against captured, on each path: two fresh dataplanes, one
   stepping eagerly (``graphs=False``) and one replaying its captured
   programs, take the same vectors at P = 256 through ``process``,
   ``process_packed`` and ``process_packed_chain`` (K = 8), with a swap
   that changes no shape and an ``expire_sessions`` between two rounds:
   every result, every aux row and the final state must be equal, and
   the swap and the expiry must keep every live table tensor. Then every
   key of the run must have been captured exactly once, and every
   graph's dump (``CUDAGraph.debug_dump``) must hold a node of each
   kernel its capture launched, the graphs of a path together every
   kernel of the path;
4d. the ML stage and telemetry, on each path: the slice with
   ``ml_stage: enforce`` (16 hidden, 4 trees x depth 3) and
   ``telemetry: full`` (24 buckets, a 2 x 1,024 sketch, top-8), staged
   with bench.py ``ml_stage_bench``'s trained MLP, on the card captured
   and eager and on the CPU. The run sequence: the MLP; a forest swapped
   in (a new program key must be captured); its action swapped to
   ratelimit with ``rl_shift`` 1 (table values: nothing may be
   captured). Each drives, at P = 256 and 4,096, the three vectors of a
   round through ``process``, packed batches stamped ``now_us`` minus
   latencies across the bucket edges (and an unstamped one and a
   negative latency) through ``process_packed``, and a stamped K = 4
   ``process_packed_chain``. ``ml_score`` must launch with the path's
   kernels; every call's result (StepResult, counters, packed and aux
   rows), the final session / NAT / ECMP / telemetry planes and
   ``telemetry_snapshot`` must be equal captured, eager and on the CPU;
   ML flags and drops must occur on every tier the path runs; the
   sketched count must equal the alive packets; the histogram must
   equal the known latencies' buckets; a ``probe`` and a
   ``process_packed(commit=False)`` must move no live plane;
4e. tenancy, the VXLAN overlay, service VIPs and ECMP groups, on each
   path: phase 4d's configuration with ``tenancy: on`` (8 tenants, 64
   prefix slots: four tenants over disjoint /16s of the bench sources,
   tenant 4 rate-limited below its offered load, tenant 2 with session
   and NAT slices, tenant 3 scoring only, tenant 1 with a threshold
   override), ``overlay: vxlan`` (the VTEP set, 16 remote /24s behind 8
   peer VTEPs, a quarter of each forward vector arriving as VXLAN frames
   with their inner sidecar, tenants' VNIs and an unknown one),
   ``svc_vips: 64`` (48 VIPs x 4 backends behind a pod route, 1/8 of
   the forward packets) and ``fib_ecmp_groups: 8`` (the remote pods'
   /24s through one 8-member group, 1/8 of the forward packets), on
   the card captured and eager and on the CPU: a round at P = 256 and
   4,096, a flood of tenant 2's that fills its slice, a
   ``set_tenant_ml`` swap (nothing may be captured), a round at P =
   256. Every call's result (the overlay's outer headers included), the
   session / NAT / ECMP / tenancy / telemetry planes,
   ``tenant_snapshot`` and ``fib_snapshot`` must be equal captured,
   eager and on the CPU; ``sess_probe_ways`` (tenant form) and
   ``ml_score`` (tid form) must launch on every tier the path runs and
   ``lpm_fused_lookup`` twice a step; DROP_TENANT, DROP_OVERLAY, service
   DNAT, encaps and more than one ECMP member must each fire; the flood
   must leave every session and NAT row outside tenant 2's slices as it
   was; the packed forms must raise the reference's ValueError; a
   ``probe`` must move no live plane;
4f. incremental uploads and session snapshots, on the MXU path: phase
   4e's configuration (every upload group populated) on the card and on
   a CPU twin, nine churns in turn, each a swap and a round at P = 256:
   (a) one global rule's ``dest_port`` at index 5,000, (b) the same rule
   objects again, (c) a pod add (interface, local table, /32), (d) a /24
   flap, (e) a backend roll on one VIP, (f) a tenant's rate, (g) the
   seeded forest, (h) a rule inserted at index 0, (i) 1,000 /32s through
   ``add_routes_np``. After each: every result and state plane equal the
   twin's, no table tensor replaced, no program captured but for (g)'s
   new ML variant, only the churn's upload groups moved bytes, and
   (a)-(e) and (i) took the reference's block path ((h) the whole
   upload). Then the live tables must equal a fresh card dataplane's
   staged to the final state and its full upload; a full and an
   incremental snapshot of the 2^20-slot tables (128 chunks; the second
   re-ships exactly the chunks a P = 1 step touched) with chunk CRCs
   equal to the twin's; a restore into a fresh card dataplane after its
   warm-up round, capturing nothing, whose replies to the last forwarded
   packets ride the fast tier, every one a session hit, equal to the
   uninterrupted dataplane's; and a 4,096-bucket drain / adopt / release
   between the two, the moved rows equal with ages rebased;
4g. the IO pump and the device rings (``vpp_tpu_torch/io``,
   pipeline/persistent.py), frames pushed into an in-process
   ``IORingPair`` as VEC-packet ring frames: (i) phase 4e's
   configuration with the overlay off on the MXU auto path through
   ``DataplanePump(mode="persistent")`` (8-slot windows, two staging
   windows, 16 frames in flight) and four dispatch-mode pumps (max
   batch 2,048, chain_k 8; fetch workers 8, 1, 1, 8 in turns), each
   driving the main path (a forward vector of 256 and of 4,096 packets,
   each followed by its two reply vectors built from the tx ring), a
   swap that changes no shape between the persistent pump's two rounds
   (the ring restarts with no capture) and, persistent, a
   ``sync_sessions`` that must land the ring's session columns in the
   dataplane; (ii) phase 4's pallas full chain through persistent pumps
   of 8 and 16 frames in flight; the dataplane's clock and the
   telemetry clock pinned, so a CPU twin replays every step the pumps
   sent (recorded with the frames each carried) at the same clocks and
   every tx frame must carry its verdict, every frame once and in
   order; every loss attributed (none expected), each path's kernels
   launched through the pumps, the ring never degraded, never fell back,
   never made a host callback; (iii) ``PersistentPump`` driven directly
   with an explicit clock and stamp per frame against the CPU twin's
   ``process_packed``: every tx row, aux row, the telemetry rider and
   the final state bit-exact (the two start equal: the pumps' grafts
   and the twin's replay agree on every plane). Then, after each
   path's twin checks, a steady window per mode: a new pump on the same
   dataplane, capturing nothing, drains 2,048 frames of fresh forward
   flows pushed as fast as the rx ring takes them (seconds of backlog),
   every frame once and in order, then 256 more under the profiler.
   Printed per cell: for the rounds Mpps, batch latency, windows and
   fill, H2D and D2H bytes per window, the stager's host ms per window
   and host reads per window (counted where the flag is read); for the
   steady window Mpps, frame latency p50 / p99 over every frame
   (dispatch to tx, and ring to ring), windows, fill and host reads,
   from the device clock of that unprofiled run the share of its span
   the stream sat empty and the share outside the step graphs, from
   the one profiled trace the device's busy ms over the trace's span;
   fetch workers 1 against 8 on the steady windows;
4h. Kubernetes state down to the card: the slice (128 NAT mappings: 64
   cluster IPs and 16 node ports need 80) staged from Kubernetes objects
   through the ported control plane — 58 pods in 6 namespaces (their
   interfaces and /32s as the CNI stages them, 3,744 remote node /24s),
   48 NetworkPolicies (pod selectors across namespaces by label, and
   ipBlocks with excepts that grow the renderer's global table past
   4,096 rules), 64 services of 2-8 local and remote endpoints (every
   4th a NodePort, every 8th ``externalTrafficPolicy: Local``) — on a
   ``pallas`` card dataplane (its own control plane, journal on from the
   start), an ``mxu`` card dataplane (fast path on) and a CPU twin; then
   eight churn rounds of two events each (policy add, policy port
   change, policy delete, pod add, pod delete, namespace label change,
   endpoints update, service delete) and a full resync of both
   pipelines. After the start and each round, an uplink vector (cluster
   IPs, node ports, pods) and a pod-to-pod vector of 4,096 packets
   through ``process_packed`` and the replies of each through
   ``process``: every packed and aux row, reply StepResult and StepStats
   (but the auto path's ``fastpath``) and the session / NAT state of
   both card dataplanes equal the twin's, and every pod-to-pod verdict
   and every verdict of an uplink packet addressed straight to a pod
   (its source against the ipBlocks) the ingress NetworkPolicy
   oracle's. ``sess_probe_ways``,
   ``bv_first_set``, ``lpm_fused_lookup`` and ``mxu_first_match`` must
   launch; ``kernel_snapshot`` must resolve every ladder to its kernel
   rung (the classifier to ``mxu`` on the second). The journal then
   replays onto a fresh card dataplane: every table tensor equal to the
   live one's and, both on empty session tables, a round of verdicts.
   Printed: the rules and slots staged, each churn kind's commit time
   (the ``epoch-swap`` spans and the enclosing ``render`` span, median
   and max over its events), the journal's entries, ops and bytes, and
   ``time_classifier`` ns/packet at P = 256 and 4,096 on both;
5. timing with CUDA events: ms per ``process`` step and Mpps (valid
   packets per device second) at P = 256 and 4,096, captured and eager,
   and a ``torch.profiler`` window per size (device operations, graph
   launches, host syncs and idle share per step; for the eager steps
   host and device ms per layer) — for phase 4's path on forward
   vectors alternating with the replies to all their packets (0 host
   syncs per step) and, split by tier, for the MXU path (fast tier on
   replies to forwarded packets, full chain on forward vectors; 1 host
   sync per step, the dispatch flag); the capture ms and the memory of
   each graph's private pool; the device ms of each graph's replay alone
   and the host ms of its launch; each
   kernel at the main path's own inputs beside its plain version and
   its bound (``mxu_first_match`` also beside two yardsticks the port
   never calls: a bare bf16 ``torch.matmul`` of the exploded bits and
   the coefficients, ``matmul_ms``, and ``torch._int_mm`` of the same
   as int8, ``int8_matmul_ms``; ``ml_score`` beside ``torch._int_mm``
   of its layer-1 product padded to [P, 24] x [24, 16],
   ``library_ms``; the tenant forms of ``sess_probe_ways`` and
   ``ml_score`` at phase 4e's inputs); the ML stage's and telemetry's
   cost: ms and device operations per step of phase 4d's dataplanes
   against phase 4 / 4b's on the same vectors, in turns; and the cost of
   tenancy, the overlay, service VIPs and ECMP: phase 4e's dataplanes
   against phase 4d's, in turns (the overlay side takes the framed
   vector and its sidecar, the other side the inner headers); and phase
   4f's swap of each churn (host ms, the span between CUDA events
   around it, host-to-device bytes by upload group, the fields shipped
   whole), snapshot, restore and migration times.

Every comparison is between integers: the tolerance is exact equality.
The line before the last is the kernels JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import ipaddress
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from vpp_tpu_torch.ir.rule import (  # noqa: E402
    Action,
    ContivRule,
    Protocol,
    rule_matches,
)
from vpp_tpu_torch.ml.model import (  # noqa: E402
    MlModel,
    packet_features,
    score_oracle,
)
from vpp_tpu_torch.ml.train import train_and_pack  # noqa: E402
from vpp_tpu_torch.interop import tables_to_numpy  # noqa: E402
from vpp_tpu_torch.io import DataplanePump, IORingPair  # noqa: E402
from vpp_tpu_torch.io.pump import PUMP_DROP_KEYS  # noqa: E402
from vpp_tpu_torch.native.pktio import PacketCodec  # noqa: E402
from vpp_tpu_torch.native.ring import RING_COLUMNS  # noqa: E402
from vpp_tpu_torch.ops import (  # noqa: E402
    _cuda,
    acl_bv,
    acl_mxu,
    lpm,
    mlscore,
    nat44,
    session,
)
from vpp_tpu_torch.ops.telemetry import lat_bucket_np  # noqa: E402
from vpp_tpu_torch.ops.acl import first_true  # noqa: E402
from vpp_tpu_torch.pipeline.dataplane import (  # noqa: E402
    Dataplane,
    pack_packet_columns,
    packed_input_zeros,
    unpack_packet_result,
)
from vpp_tpu_torch.pipeline import capture, graph  # noqa: E402
from vpp_tpu_torch.pipeline import snapshot as snapshot_mod  # noqa: E402
from vpp_tpu_torch.pipeline import dataplane as dataplane_mod  # noqa: E402
from vpp_tpu_torch.pipeline import persistent as persistent_mod  # noqa: E402
from vpp_tpu_torch.ops import telemetry as telemetry_mod  # noqa: E402
from vpp_tpu_torch.pipeline.graph import DROP_ACL  # noqa: E402
from vpp_tpu_torch.pipeline.tables import (  # noqa: E402
    DERIVED_FIELDS,
    HOST_FIELDS,
    SESSION_FIELDS,
    TABLE_FIELDS,
    TELEMETRY_FIELDS,
    TENANCY_STATE_FIELDS,
    DataplaneConfig,
    tensor_of,
)
from vpp_tpu_torch.pipeline.tables import derive as derive_tables  # noqa: E402
from vpp_tpu_torch.pipeline.transfer import (  # noqa: E402
    device_transfer_totals,
)
from vpp_tpu_torch.ir.rule import PodID  # noqa: E402
from vpp_tpu_torch.ksr import model as km  # noqa: E402
from vpp_tpu_torch.pipeline.tables import zero_sessions  # noqa: E402
from vpp_tpu_torch.pipeline.txn import TxnJournal  # noqa: E402
from vpp_tpu_torch.policy import (  # noqa: E402
    PolicyCache,
    PolicyConfigurator,
    PolicyProcessor,
)
from vpp_tpu_torch.renderer.tpu import TpuRenderer  # noqa: E402
from vpp_tpu_torch.service import (  # noqa: E402
    ServiceConfigurator,
    ServiceProcessor,
)
from vpp_tpu_torch.tenancy import derive  # noqa: E402
from vpp_tpu_torch.trace import spans  # noqa: E402
from vpp_tpu_torch.tenancy.derive import key_tenant, tenant_ids  # noqa: E402
from vpp_tpu_torch.pipeline.vector import (  # noqa: E402
    FLAG_VALID,
    VEC,
    Disposition,
    PacketVector,
    bias,
    gather_index,
    ip4,
    ip4_str,
    packet_vector_from_numpy,
    to_i32,
    u32,
)

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, the
# non-tensor-core FP32 rate, used as the ceiling of the kernels' integer
# compare / logic work (Hopper's INT32 lanes are no more than its FP32
# lanes, so this bound is never above the true one), and the dense bf16
# and int8 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
TC_BF16_FLOPS = 989e12
TC_INT8_OPS = 1979e12

BIG_VEC = 4096
ROUNDS = 4            # (forward, 2 replies) rounds per size: 24 main-path steps
TIMED_STEPS = 30      # timed process steps (and eager calls) per size
PROFILED_STEPS = 10   # profiled process steps per size
VIP = "10.96.0.10"
N_PODS = 8
N_BACKENDS = 100
# phase 4e (bench.py overlay_bench and tenant_isolation_bench): the node's
# VTEP, 8 peer VTEPs, 48 service VIPs x 4 backends, and four tenants over
# disjoint /16s of the bench traffic's sources, each with its own VNI
VTEP = ip4("192.168.16.1")
PEER_VTEPS = tuple(ip4(f"192.168.16.{2 + k}") for k in range(8))
N_VIPS, N_SVC_BACKENDS = 48, 4
SVC_BACKEND_NET = "10.200.0.0/16"
TENANT_NETS = {t: f"172.{15 + t}.0.0/16" for t in (1, 2, 3, 4)}
UNKNOWN_VNI = 999

KERNELS = {
    "sess_probe_ways": dict(
        source="vpp_tpu_torch/csrc/sess_probe.cu",
        replaces="vpp_tpu/ops/session.py:1032"),
    "bv_first_set": dict(
        source="vpp_tpu_torch/csrc/bv_first_set.cu",
        replaces="vpp_tpu/ops/acl_bv.py:449"),
    "lpm_fused_lookup": dict(
        source="vpp_tpu_torch/csrc/lpm_lookup.cu",
        replaces="vpp_tpu/ops/lpm.py:372"),
    "mxu_first_match": dict(
        source="vpp_tpu_torch/csrc/mxu_first_match.cu",
        replaces="vpp_tpu/ops/acl_mxu.py:246"),
    # no Pallas counterpart: the reference's stage is plain jnp
    # (ml_score and ml_policy)
    "ml_score": dict(
        source="vpp_tpu_torch/csrc/ml_score.cu",
        replaces="vpp_tpu/ops/mlscore.py:167"),
}
WRAPPERS = {"sess_probe_ways": session.sess_probe_ways,
            "bv_first_set": acl_bv.bv_first_set,
            "lpm_fused_lookup": lpm.lpm_fused_lookup,
            "mxu_first_match": acl_mxu.mxu_first_match,
            "ml_score": mlscore.ml_stage}
NAME_OF = {w: k for k, w in WRAPPERS.items()}
# the kernels each main path runs (phase 4: pallas rungs; 4b: mxu; 4d:
# the same with the ML stage and telemetry on)
PATH_KERNELS = {"pallas": ("sess_probe_ways", "bv_first_set",
                           "lpm_fused_lookup"),
                "mxu": ("sess_probe_ways", "mxu_first_match",
                        "lpm_fused_lookup")}
PATH_KERNELS.update({f"{p}+ml": k + ("ml_score",)
                     for p, k in list(PATH_KERNELS.items())})
# each kernel's __global__ function, as a captured graph's nodes name it
KERNEL_SYMBOLS = {"sess_probe_ways": "sess_probe_kernel",
                  "bv_first_set": "bv_first_set_kernel",
                  "lpm_fused_lookup": "lpm_kernel",
                  "mxu_first_match": "mxu_first_match_kernel",
                  "ml_score": "ml_score_kernel"}
PATH_KERNELS.update({f"{p}+tnt": k + ("ml_score",)
                     for p, k in list(PATH_KERNELS.items())
                     if "+" not in p})
CHAIN_K = 8           # sub-batches of phase 4c's process_packed_chain

RESULT_FIELDS = ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
                 "established", "dnat_applied", "snat_applied",
                 "ml_flagged", "ml_scores")
STATE_FIELDS = tuple(SESSION_FIELDS) + ("fib_ecmp_c",)
OVL_FIELDS = ("ovl_encap", "ovl_vni")


def say(*parts) -> None:
    print(*parts, flush=True)


# --- the slice's configuration ------------------------------------------


def slice_config(n_rules: int = 10240, sess_slots: int = 1 << 20,
                 fib_slots: int = 4096) -> DataplaneConfig:
    """One Kubernetes node at the scale the reference targets, every
    ladder on its fused-kernel rung."""
    return DataplaneConfig(
        max_tables=16, max_rules=128, max_global_rules=n_rules,
        max_ifaces=64, fib_slots=fib_slots, fib_impl="pallas",
        sess_slots=sess_slots, sess_ways=4, session_impl="pallas",
        nat_mappings=64, nat_backends=512, fastpath=False,
        classifier="pallas")


def global_rules(n: int, svc: bool = False):
    """The gen-policy.py shape (bench.py ``build_rules``): /24 CIDR
    blocks x ports with every 6th rule a deny, then a permit of the
    service backends' port (with ``svc`` also of the service-VIP
    backends', as overlay_bench permits its VIP traffic) and the
    terminal deny-all; ``n`` rules."""
    rules = []
    i = 0
    while len(rules) < n - 2 - svc:
        block = i % 1000
        port = 8000 + (i // 1000) % 20
        net = ipaddress.ip_network(
            f"172.{16 + block // 256}.{block % 256}.0/24")
        rules.append(ContivRule(
            action=Action.DENY if i % 6 == 5 else Action.PERMIT,
            src_network=net, protocol=Protocol.TCP, dest_port=port))
        i += 1
    rules.append(ContivRule(
        action=Action.PERMIT, protocol=Protocol.TCP, dest_port=80,
        dest_network=ipaddress.ip_network("10.1.1.0/24")))
    if svc:
        rules.append(ContivRule(
            action=Action.PERMIT, protocol=Protocol.TCP, dest_port=80,
            dest_network=ipaddress.ip_network(SVC_BACKEND_NET)))
    rules.append(ContivRule(action=Action.DENY))
    return rules


def local_rules(pod: int, n: int):
    """A pod's egress policy of ``n`` rules: TCP from its service ports
    to client /24 blocks (every 5th a deny), DNS, then deny-all."""
    rules = []
    for k in range(n - 2):
        block = (37 * pod + 11 * k) % 1000
        rules.append(ContivRule(
            action=Action.DENY if k % 5 == 4 else Action.PERMIT,
            dest_network=ipaddress.ip_network(
                f"172.{16 + block // 256}.{block % 256}.0/24"),
            protocol=Protocol.TCP, src_port=8000 + k % 20))
    rules.append(ContivRule(action=Action.PERMIT, protocol=Protocol.UDP,
                            dest_port=53))
    rules.append(ContivRule(action=Action.DENY))
    return rules


def pod_of(host: np.ndarray) -> np.ndarray:
    """Index into the pod list of the pod owning 10.1.1.<host>."""
    return host % N_PODS


def stage(dp: Dataplane, n_rules: int, n_nodes: int, ecmp: bool = False,
          svc: bool = False):
    """Stage the slice on ``dp`` and swap it in. Returns (uplink, pods).
    Routes: the pod /24, 250 pod /32s, ``n_nodes`` per-node /24s and an
    SNAT default route; one ClusterIP VIP with 100 weighted backends.
    ``ecmp``: the per-node /24s resolve through ECMP group 0 of the 8
    peer VTEPs (bench.py's 8-member group); ``svc``: the global table
    also permits the service-VIP backends (``global_rules``)."""
    up = dp.add_uplink()
    dp.add_host_interface()
    pods = [dp.add_pod_interface(("default", f"pod{i}"))
            for i in range(N_PODS)]
    b = dp.builder
    for i in range(N_PODS):
        table = f"pod{i}-policy"
        slot = dp.alloc_table_slot(table)
        b.set_local_table(slot, local_rules(i, dp.config.max_rules))
        dp.assign_pod_table(("default", f"pod{i}"), table)
    b.set_global_table(global_rules(n_rules, svc))
    b.add_route("10.1.1.0/24", pods[0], Disposition.LOCAL)
    for h in range(1, 251):
        b.add_route(f"10.1.1.{h}/32", pods[int(pod_of(np.int64(h)))],
                    Disposition.LOCAL)
    if ecmp:
        b.set_nh_group(0, [(v, up, 2 + k) for k, v in enumerate(PEER_VTEPS)])
    for n in range(n_nodes):
        b.add_route(f"10.{2 + n // 256}.{n % 256}.0/24", up,
                    Disposition.REMOTE, next_hop=ip4("192.168.0.0") + n,
                    node_id=n + 2, group=0 if ecmp else None)
    b.add_route("0.0.0.0/0", up, Disposition.REMOTE,
                next_hop=ip4("192.168.255.254"), snat=True)
    b.set_nat_mapping(
        0, ip4(VIP), 80, 6,
        [(ip4("10.1.1.2") + i, 80, 1 + i % 2) for i in range(N_BACKENDS)],
        boff=0)
    b.set_snat_ip(ip4("192.168.16.1"))
    dp.swap()
    return up, pods


def forward_traffic(n: int, uplink: int, seed: int) -> dict:
    """bench.py ``build_traffic``: TCP from the rule-space CIDR blocks
    toward the pod subnet, 1/8 of it to the ClusterIP VIP."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 1000, n)
    src = ((172 << 24) | ((16 + block // 256) << 16)
           | ((block % 256) << 8) | rng.integers(1, 255, n)).astype(np.uint32)
    dst = (ip4("10.1.1.0") + rng.integers(2, 250, n)).astype(np.uint32)
    vip = rng.random(n) < 0.125
    dst = np.where(vip, np.uint32(ip4(VIP)), dst)
    dport = np.where(vip, 80, 8000 + rng.integers(0, 20, n)).astype(np.int32)
    sport = rng.integers(1024, 65535, n).astype(np.int32)
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    return dict(src_ip=src, dst_ip=dst, proto=full(6), sport=sport,
                dport=dport, ttl=full(64), pkt_len=full(512),
                rx_if=full(uplink), flags=full(FLAG_VALID))


def reply_traffic(snap: dict, pods, to: str = "all") -> dict:
    """The reply of a processed forward vector: its post-NAT endpoints
    swapped, received on the pod interface that owns the reply's
    source. ``to`` picks the packets that get a reply (the other slots
    are invalid): ``forwarded`` (established flows, all of which hit a
    session), ``dropped`` (fresh flows from the pods, which take the
    full chain and SNAT) or ``all``."""
    src = snap["pkts.dst_ip"].view(np.uint32)
    n = src.shape[0]
    pod_ifs = np.asarray(pods, np.int32)
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    dropped = snap["disp"] == int(Disposition.DROP)
    keep = {"all": np.ones(n, bool), "forwarded": ~dropped,
            "dropped": dropped}[to]
    return dict(src_ip=src.copy(),
                dst_ip=snap["pkts.src_ip"].view(np.uint32).copy(),
                proto=full(6), sport=snap["pkts.dport"].copy(),
                dport=snap["pkts.sport"].copy(), ttl=full(64),
                pkt_len=full(512),
                rx_if=pod_ifs[pod_of(src.astype(np.int64) & 0xFF)],
                flags=np.where(keep, FLAG_VALID, 0).astype(np.int32))


def snapshot(res) -> dict:
    """Every StepResult field and StepStats counter as numpy (with the
    overlay on, its outer headers, encap mask and wire VNI too)."""
    out = {f"pkts.{f}": getattr(res.pkts, f).cpu().numpy()
           for f in PacketVector._fields}
    out.update({f: getattr(res, f).cpu().numpy() for f in RESULT_FIELDS})
    out.update({f"stats.{f}": getattr(res.stats, f).cpu().numpy()
                for f in res.stats._fields})
    if res.ovl_outer is not None:
        out.update({f"ovl_outer.{f}": getattr(res.ovl_outer, f).cpu().numpy()
                    for f in PacketVector._fields})
        out.update({f: getattr(res, f).cpu().numpy() for f in OVL_FIELDS})
    return out


def state_of(dp: Dataplane) -> dict:
    return {f: getattr(dp.tables, f).cpu().numpy() for f in STATE_FIELDS}


def drive(dp: Dataplane, up: int, pods, rounds: int, seed: int,
          sizes=(VEC, BIG_VEC), now0: int = 100):
    """The main path: ``rounds`` x (forward, reply to the forwarded
    packets, reply to the dropped ones) at each size through
    ``dp.process``. Returns the input vectors (numpy) and the results."""
    inputs, snaps = [], []
    now = now0

    def step(vec):
        nonlocal now
        res = dp.process(packet_vector_from_numpy(vec, dp.device), now=now)
        inputs.append((vec, now))
        snaps.append(snapshot(res))
        now += 1
        return snaps[-1]

    for r in range(rounds):
        for n in sizes:
            first = step(forward_traffic(n, up, seed + 7919 * r + n))
            for to in ("forwarded", "dropped"):
                step(reply_traffic(first, pods, to))
    return inputs, snaps


def replay(dp: Dataplane, inputs):
    return [snapshot(dp.process(packet_vector_from_numpy(vec, dp.device),
                                now=now)) for vec, now in inputs]


def assert_equal(a: dict, b: dict, what: str) -> None:
    for k in a:
        if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
            bad = int(np.sum(a[k] != b[k])) if a[k].shape == b[k].shape \
                else "shape"
            raise AssertionError(f"{what}: {k} differs ({bad})")


def oracle_check(rules, snap: dict, n: int) -> int:
    """The first ``n`` packets of a fresh forward vector (no session,
    no local table on the uplink): ACL-dropped iff the first rule of the
    global list that matches the post-DNAT header denies. Returns the
    number of denied packets."""
    denied = 0
    for i in range(n):
        hdr = (ip4_str(int(snap["pkts.src_ip"][i])),
               ip4_str(int(snap["pkts.dst_ip"][i])), Protocol.TCP,
               int(snap["pkts.sport"][i]), int(snap["pkts.dport"][i]))
        rule = next((r for r in rules if rule_matches(r, *hdr)), None)
        deny = rule is not None and rule.action == Action.DENY
        got = int(snap["drop_cause"][i]) == DROP_ACL
        if deny != got:
            raise AssertionError(f"packet {i} {hdr}: oracle deny={deny}, "
                                 f"dataplane deny={got}")
        denied += deny
    return denied


# --- kernel checks --------------------------------------------------------


def _t(a: np.ndarray, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
    return torch.from_numpy(a).to(dev)


class Errors:
    """Largest |kernel - plain| seen per kernel (as int64)."""

    def __init__(self):
        self.max = {k: 0 for k in KERNELS}

    def hold(self, name: str, got, want, what: str) -> None:
        for g, w in zip(got, want):
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
                if g.numel() else 0
            if g.shape != w.shape:
                raise AssertionError(f"{name} {what}: shape {tuple(g.shape)}"
                                     f" != {tuple(w.shape)}")
            self.max[name] = max(self.max[name], err)
            if err:
                raise AssertionError(f"{name} {what}: kernel differs from "
                                     f"its plain version (max |err| {err})")


def sess_case(rng, p: int, nb: int, w: int, dev, misalign: bool = False,
              tnt=None):
    """Header columns (addresses with the top bit set, a quarter of the
    packets with src == dst, half of those with sport > dport) and
    random [nb, w] session columns with the reply key of every third
    packet planted in its home bucket under both bucket hashes (half of
    the plants stale at now = 1000, max_age = 200). ``misalign``: the
    columns start 4 bytes off a 16-byte boundary. ``tnt``: (kt, base,
    mask) CPU tensors; the home buckets are then the key tenants'
    slices."""
    u = lambda n: rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(  # noqa
        np.uint32)
    src, dst = u(p) | np.uint32(1 << 31), u(p)
    tie = np.arange(p) % 4 == 1
    dst[tie] = src[tie]
    sport = rng.integers(0, 65536, p).astype(np.int32)
    dport = rng.integers(0, 65536, p).astype(np.int32)
    proto = rng.choice([1, 6, 17, 255], p).astype(np.int32)
    hdr = [_t(x, torch.device("cpu")) for x in (src, dst, proto, sport,
                                                 dport)]
    keys = [k.numpy() for k in session._reverse_keys(*hdr)]
    valid = (rng.random((nb, w)) < 0.5).astype(np.int32)
    cols = [u((nb, w)).view(np.int32) for _ in range(3)]
    sproto = rng.integers(0, 256, (nb, w)).astype(np.int32)
    tm = rng.integers(0, 1000, (nb, w)).astype(np.int32)
    for sym in (False, True):
        b = session._reverse_bucket(*hdr, session._reverse_keys(*hdr), nb,
                                    sym, tnt).numpy()
        for i in range(int(sym), p, 6):
            ww, bb = int(rng.integers(0, w)), b[i]
            valid[bb, ww] = 1
            for c, k in zip(cols + [sproto], keys):
                c[bb, ww] = k[i]
            tm[bb, ww] = 100 if i % 4 < 2 else 950
    out = []
    for x in (valid, *cols, sproto, tm):
        flat = torch.empty(x.size + int(misalign), dtype=torch.int32,
                           device=dev)
        col = flat[int(misalign):].view(nb, w)
        col.copy_(torch.from_numpy(x))
        out.append(col)
    return [h.to(dev) for h in hdr] + out


def tnt_slices(rng, p: int, nb: int, n_t: int = 8):
    """(kt [p], base [T], mask [T]) CPU tensors of T tenants' session
    slices, allocated as the builder allocates them: tenants 1, 2, 5
    and 6 sliced from the top (nb/8, nb/16, one bucket, nb/32 where each
    fits), the rest sharing the unsliced residual's largest power of
    two. Each packet's key tenant at random, the first packet's 0 and
    the last's T - 1."""
    base = np.zeros(n_t, np.int32)
    mask = np.zeros(n_t, np.int32)
    cursor, sliced = nb, set()
    for tid, size in zip((1, 2, 5, 6), (nb >> 3, nb >> 4, 1, nb >> 5)):
        if size and cursor - size > 0:
            cursor -= size
            base[tid], mask[tid] = cursor, size - 1
            sliced.add(tid)
    residual = (1 << (cursor.bit_length() - 1)) - 1
    for tid in set(range(n_t)) - sliced:
        mask[tid] = residual
    kt = rng.integers(0, n_t, p).astype(np.int32)
    kt[0], kt[-1] = 0, n_t - 1
    return tuple(torch.from_numpy(a) for a in (kt, base, mask))


def _boundaries(rng, size: int, n: int, signed: bool) -> np.ndarray:
    """One dimension's boundary row as ``compile_bv`` lays it out: ``n``
    sorted distinct live values from 0, pads above them."""
    top = 1 << 16 if signed else 1 << 32
    vals = np.unique(rng.integers(1, top, 2 * n + 2, dtype=np.uint64))
    vals = np.sort(rng.permutation(vals)[:max(n - 1, 0)])
    out = np.full(size, 0x7FFFFFFF if signed else 0xFFFFFFFF, np.uint64)
    out[0] = 0
    out[1:1 + len(vals)] = vals
    return out.astype(np.uint32).view(np.int32)


def bv_case(rng, p: int, n_int: int, words: int, tables, dev,
            misalign: bool = False):
    """``bv_first_set``'s arguments: header columns, one table
    (``tables`` None) or ``tables`` per-interface tables with
    ``rx_if`` / ``if_local_table`` (a third of the interfaces without a
    table; rx_if also -1 and past the end). Live counts below the padded
    length but one full table; a third of the header values on a
    boundary, a third one off it, the extremes 0 and 2^32 - 1 / 65535.
    ``misalign``: the planes start 4 bytes off a 16-byte boundary."""
    n_t = tables or 1
    bnd = np.zeros((4, n_t, n_int), np.int32)
    nbnd = np.zeros((n_t, 4), np.int32)
    for t in range(n_t):
        for k in range(4):
            n = n_int if t == n_t - 1 and k == 0 else int(
                rng.integers(1, n_int + 1))
            bnd[k, t] = _boundaries(rng, n_int, n, signed=k >= 2)
            nbnd[t, k] = n
    # bit density 1/2, or 1/8 for wide rows, so both hits and misses
    # occur at every width
    dense = 1 if words < 16 else 3
    planes = []
    for rows in (n_int,) * 4 + (acl_bv.PROTO_ROWS,):
        pl = rng.integers(0, 1 << 32, (n_t, rows, words), dtype=np.uint64)
        for _ in range(dense - 1):
            pl &= rng.integers(0, 1 << 32, (n_t, rows, words),
                               dtype=np.uint64)
        planes.append(pl.astype(np.uint32).view(np.int32))
    t_of = rng.integers(0, n_t, p)
    hdr = []
    for k, top in ((0, 0xFFFFFFFF), (1, 0xFFFFFFFF), (None, 255),
                   (2, 65535), (3, 65535)):
        v = rng.integers(0, top + 1, p, dtype=np.int64)
        if k is not None:
            live = bnd[k, t_of, (rng.random(p) * nbnd[t_of, k]).astype(
                np.int64)].astype(np.int64) & 0xFFFFFFFF
            kind = np.arange(p) % 3
            v = np.where(kind == 0, live, v)
            v = np.where(kind == 1, np.clip(live + rng.choice([-1, 1], p), 0,
                                            top), v)
            v[:2] = np.array([0, top])[:p]
        hdr.append(v.astype(np.uint32).view(np.int32))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = [to(x) for x in hdr]
    squeeze = (lambda a: a[0]) if tables is None else (lambda a: a)
    args += [to(squeeze(bnd[k])) for k in range(4)] + [to(squeeze(nbnd))]
    for pl in planes:
        flat = torch.empty(pl.size + int(misalign), dtype=torch.int32,
                           device=dev)
        dest = flat[int(misalign):].view(pl.shape)
        dest.copy_(torch.from_numpy(pl))
        args.append(squeeze(dest))
    if tables is not None:
        n_if = 24
        table = rng.integers(0, tables, n_if).astype(np.int32)
        table[::3] = -1
        # the interface of each packet: one whose table is t_of, or one
        # without a table, or an index that wraps or clamps
        rx = np.array([int(rng.choice(np.flatnonzero(table == t)))
                       if np.any(table == t) else 0 for t in t_of])
        rx[::5] = 0
        rx[1::17], rx[2::17] = -1, n_if + 3
        args += [to(rx.astype(np.int32)), to(table)]
    return args


def lpm_case(rng, p: int, lens, npad: int, dev, fill=False):
    """A random biased stack over ``lens`` (longest first) with half the
    packets inside a staged prefix; ``fill``: every length draws ``npad``
    distinct prefixes (fewer where it has fewer distinct values)."""
    n_len = len(lens)
    pfx = np.full((n_len, npad), 0x7FFFFFFF, np.int32)
    slot = np.zeros((n_len, npad), np.int32)
    cnt = np.zeros(n_len, np.int32)
    for r, ln in enumerate(lens):
        mask = ((0xFFFFFFFF << (32 - ln)) & 0xFFFFFFFF) if ln else 0
        n = (npad if fill else int(rng.integers(0, npad + 1))) if ln else 1
        vals = np.unique(rng.integers(0, 1 << 32, 2 * n, dtype=np.uint64)
                         & mask)
        vals = np.sort(rng.permutation(vals)[:n])
        n = len(vals)
        pfx[r, :n] = (vals ^ 0x80000000).astype(np.uint32).view(np.int32)
        slot[r, :n] = rng.integers(0, 4096, n)
        cnt[r] = n
    dst = rng.integers(0, 1 << 32, p, dtype=np.uint32)
    for i in range(0, p, 2):
        r = int(rng.integers(0, max(n_len, 1)))
        if n_len and cnt[r]:
            v = (int(pfx[r, int(rng.integers(0, cnt[r]))]) & 0xFFFFFFFF) \
                ^ 0x80000000
            host = (1 << (32 - lens[r])) - 1
            dst[i] = v | (int(dst[i]) & host)
    return [_t(dst, dev), _t(np.asarray(lens, np.int32), dev), _t(cnt, dev),
            _t(pfx, dev), _t(slot, dev)]


def _prefix_masks(lens: np.ndarray) -> np.ndarray:
    return np.where(lens == 0, 0, (0xFFFFFFFF << (32 - lens)) & 0xFFFFFFFF
                    ).astype(np.uint64)


def mxu_case(rng, p: int, r: int, dev, kind: str = "random"):
    """(src_ip, dst_ip, proto, sport, dport, op): the header columns of
    ``p`` packets, half of them drawn from the rules so that matches
    happen, and the ``mxu_operand`` of ``r`` rules compiled by the port's
    ``compile_bitplanes`` and cut to R' = r columns.
    ``random``: prefixes /0../32, proto any/TCP/UDP, exact or any ports.
    ``miss``: TCP-only rules, UDP packets. ``multi``: nested dst
    prefixes of one /8, each exact on one of 64 ports, so every packet
    matches about R'/64 rules and the lowest must win."""
    u = lambda a: a.astype(np.uint32)  # noqa: E731
    src_len = rng.integers(0, 33, r)
    dst_len = rng.integers(0, 33, r)
    proto = rng.choice([-1, 6, 17], r).astype(np.int32)
    dport = np.where(rng.random(r) < 0.7, rng.integers(0, 65536, r), -1)
    sport = np.where(rng.random(r) < 0.2, rng.integers(0, 65536, r), -1)
    base = rng.integers(0, 1 << 32, r, dtype=np.uint64)
    if kind == "miss":
        proto[:] = 6
    if kind == "multi":
        src_len[:] = 0
        dst_len = rng.integers(0, 9, r)
        base[:] = 0x0A000000
        proto[:] = -1
        sport[:] = -1
        dport = rng.integers(1, 65, r)
    packed = dict(
        src_net=u(base & _prefix_masks(src_len)),
        src_mask=u(_prefix_masks(src_len)),
        dst_net=u(base & _prefix_masks(dst_len)),
        dst_mask=u(_prefix_masks(dst_len)), proto=proto,
        sport_lo=np.where(sport < 0, 0, sport).astype(np.int32),
        sport_hi=np.where(sport < 0, 65535, sport).astype(np.int32),
        dport_lo=np.where(dport < 0, 0, dport).astype(np.int32),
        dport_hi=np.where(dport < 0, 65535, dport).astype(np.int32),
        action=rng.integers(0, 2, r).astype(np.int32))
    table = acl_mxu.compile_bitplanes(packed, r)
    cols = dict(src_ip=rng.integers(0, 1 << 32, p, dtype=np.uint64),
                dst_ip=rng.integers(0, 1 << 32, p, dtype=np.uint64),
                proto=rng.choice([1, 6, 17], p).astype(np.int32),
                sport=rng.integers(0, 65536, p).astype(np.int32),
                dport=rng.integers(0, 65536, p).astype(np.int32))
    drawn = np.arange(p) % 2 == 0
    j = rng.integers(0, r, p)
    for f, net, mask in (("src_ip", "src_net", "src_mask"),
                         ("dst_ip", "dst_net", "dst_mask")):
        m = packed[mask][j].astype(np.uint64)
        inside = packed[net][j].astype(np.uint64) | (cols[f] & ~m
                                                    & 0xFFFFFFFF)
        cols[f] = u(np.where(drawn, inside, cols[f]))
    cols["proto"] = np.where(drawn & (proto[j] >= 0), proto[j],
                             cols["proto"]).astype(np.int32)
    for f, ports in (("sport", sport), ("dport", dport)):
        cols[f] = np.where(drawn & (ports[j] >= 0), ports[j],
                           cols[f]).astype(np.int32)
    if kind == "miss":
        cols["proto"][:] = 17
    if kind == "multi":
        cols["dst_ip"] = u(0x0A000000 | rng.integers(0, 1 << 16, p))
        cols["dport"] = rng.integers(1, 65, p).astype(np.int32)
    full = lambda v: np.full(p, v, np.int32)  # noqa: E731
    pkts = packet_vector_from_numpy(dict(
        cols, ttl=full(64), pkt_len=full(64), rx_if=full(0),
        flags=full(FLAG_VALID)), dev)
    op = acl_mxu.mxu_operand({
        "glb_mxu_coeff": torch.from_numpy(
            np.ascontiguousarray(table.coeff[:, :r])).to(dev),
        "glb_mxu_k": torch.from_numpy(table.k[:r].copy()).to(dev)})
    return (pkts.src_ip, pkts.dst_ip, pkts.proto, pkts.sport, pkts.dport,
            op["glb_mxu_op"])


ML_VARIANTS = ("random", "zero", "single", "thresh-min", "thresh-max",
               "wrap", "mark", "drop", "ratelimit", "mirror")
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


# per-tenant ML modes and thresholds of ``ml_case``'s tenant form: each
# mode (inherit, off, score, enforce) with the inherit sentinel and with
# overrides at both ends of int32
TNT_ML_MODES = (0, 1, 2, 3, 0, 3, 2, 1)
TNT_ML_THRESH = (mlscore.ML_TNT_THRESH_INHERIT, mlscore.ML_TNT_THRESH_INHERIT,
                 -50, mlscore.ML_TNT_THRESH_INHERIT, 0, 100,
                 (1 << 31) - 1, -(1 << 31) + 1)


def ml_case(rng, p: int, dev, kind: str = "mlp", variant: str = "random",
            hidden: int = 16, trees: int = 4, depth: int = 3,
            tenants: bool = False):
    """``ml_stage``'s arguments: model planes (a namespace of the
    ``glb_ml_*`` tensors), header columns with every edge the features
    see (addresses with the top bit set, ports past 16 bits, negative
    lengths, flags past 255), alive, established and the session age.
    ``variant``: ``random`` weights (drop action); ``zero`` weights;
    ``single``: one feature (the length bucket) through one hidden unit;
    ``thresh-min`` / ``thresh-max``: the flag threshold at INT32_MIN /
    INT32_MAX; ``wrap``: full-range int32 biases and leaf votes (the sums
    wrap), shifts of -1, 31, 32 and feature indices off the vector;
    ``mark`` / ``drop`` / ``ratelimit`` / ``mirror``: that action, with
    ``rl_shift`` 1 (ratelimit also 31 and 32 by seed). ``tenants``: the
    planes also hold the per-tenant vectors of ``TNT_ML_MODES`` /
    ``TNT_ML_THRESH``, and a sixth value is the [P] tenant ids (the
    first 0, the last T - 1)."""
    full = (I32_MIN, I32_MAX + 1)
    w = dict(
        glb_ml_w1=rng.integers(-128, 128, (18, hidden)).astype(np.int8),
        glb_ml_b1=rng.integers(-(1 << 16), 1 << 16, hidden).astype(
            np.int32),
        glb_ml_s1=np.int32(rng.integers(0, 12)),
        glb_ml_w2=rng.integers(-128, 128, hidden).astype(np.int8),
        glb_ml_b2=np.int32(rng.integers(-1000, 1000)),
        glb_ml_f_feat=rng.integers(0, 18, (trees, depth)).astype(np.int32),
        glb_ml_f_thresh=rng.integers(0, 256, (trees, depth)).astype(
            np.int32),
        glb_ml_f_leaf=rng.integers(-500, 500, (trees, 1 << depth)).astype(
            np.int32),
        glb_ml_thresh=np.int32(0), glb_ml_action=np.int32(1),
        glb_ml_rl_shift=np.int32(0))
    if variant == "zero":
        for f in ("glb_ml_w1", "glb_ml_b1", "glb_ml_w2", "glb_ml_f_leaf"):
            w[f] = np.zeros_like(w[f])
        w["glb_ml_b2"] = np.int32(0)
    elif variant == "single":
        w["glb_ml_w1"] = np.zeros_like(w["glb_ml_w1"])
        w["glb_ml_w1"][13, 0] = 2
        w["glb_ml_w2"] = np.zeros_like(w["glb_ml_w2"])
        w["glb_ml_w2"][0] = 3
        w["glb_ml_b1"][0] = 256 - 10
        w["glb_ml_s1"] = np.int32(1)
        w["glb_ml_thresh"] = np.int32(50)
    elif variant in ("thresh-min", "thresh-max"):
        w["glb_ml_thresh"] = np.int32(I32_MIN if variant == "thresh-min"
                                      else I32_MAX)
    elif variant == "wrap":
        w["glb_ml_b1"] = rng.integers(*full, hidden, dtype=np.int64).astype(
            np.int32)
        w["glb_ml_b2"] = np.int32(rng.integers(*full, dtype=np.int64))
        w["glb_ml_s1"] = np.int32(rng.choice([-1, 31, 32]))
        w["glb_ml_f_feat"] = rng.integers(-2, 21, (trees, depth)).astype(
            np.int32)
        w["glb_ml_f_thresh"] = rng.choice(
            [I32_MIN, -1, 0, 127, 128, 255, I32_MAX], (trees, depth)).astype(
            np.int32)
        w["glb_ml_f_leaf"] = rng.integers(*full, (trees, 1 << depth),
                                          dtype=np.int64).astype(np.int32)
        w["glb_ml_thresh"] = np.int32(rng.integers(*full, dtype=np.int64))
        w["glb_ml_action"] = np.int32(2)
        w["glb_ml_rl_shift"] = np.int32(rng.choice([-1, 0, 31, 32]))
    elif variant in ("mark", "drop", "ratelimit", "mirror"):
        w["glb_ml_action"] = np.int32(("mark", "drop", "ratelimit",
                                       "mirror").index(variant))
        w["glb_ml_rl_shift"] = np.int32(rng.choice([1, 31, 32])
                                        if variant == "ratelimit" else 1)
        w["glb_ml_thresh"] = np.int32(rng.integers(-200, 200))
    if tenants:
        w["glb_ml_tnt_mode"] = np.array(TNT_ML_MODES, np.int32)
        w["glb_ml_tnt_thresh"] = np.array(TNT_ML_THRESH, np.int32)
    planes = type("MlPlanes", (), {f: torch.from_numpy(np.array(a)).to(dev)
                                   for f, a in w.items()})
    u = lambda: rng.integers(0, 1 << 32, p, dtype=np.uint64).astype(  # noqa
        np.uint32)
    cols = dict(src_ip=u() | np.uint32(1 << 31), dst_ip=u(),
                proto=rng.integers(-300, 300, p).astype(np.int32),
                sport=rng.integers(-70000, 70000, p).astype(np.int32),
                dport=rng.integers(0, 65536, p).astype(np.int32),
                ttl=np.full(p, 64, np.int32),
                pkt_len=rng.integers(-5000, 9000, p).astype(np.int32),
                rx_if=np.zeros(p, np.int32),
                flags=rng.integers(0, 1024, p).astype(np.int32))
    est = rng.random(p) < 0.4
    age = np.where(est, rng.integers(-20, 400, p), 0).astype(np.int32)
    alive = rng.random(p) < 0.9
    out = (planes, packet_vector_from_numpy(cols, dev),
           torch.from_numpy(alive).to(dev), torch.from_numpy(est).to(dev),
           torch.from_numpy(age).to(dev))
    if not tenants:
        return out
    tid = rng.integers(0, len(TNT_ML_MODES), p).astype(np.int32)
    tid[0], tid[-1] = 0, len(TNT_ML_MODES) - 1
    return out + (torch.from_numpy(tid).to(dev),)


def check_ml_kernel(dev, errors: Errors, seed: int) -> None:
    """``ml_stage`` (csrc/ml_score.cu) against ``ml_stage_plain`` on the
    card: every variant of ``ml_case`` for both kinds at P = 1, 33, 256,
    4,095 and 4,096, a forest of 16 trees x depth 8, and an MLP wide
    enough (H = 700) that its staged model passes 48 KB of shared
    memory."""
    rng = np.random.default_rng(seed + 17)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cases = [(p, kind, v, {}) for p in (1, 33, VEC, BIG_VEC - 1, BIG_VEC)
             for kind in ("mlp", "forest") for v in ML_VARIANTS]
    cases += [(VEC, "forest", "random", dict(trees=16, depth=8)),
              (VEC, "mlp", "random", dict(hidden=700))]
    for p, kind, variant, geo in cases:
        args = ml_case(rng, p, dev, kind, variant, **geo)
        got = mlscore.ml_stage(*args, kind=kind)
        want = mlscore.ml_stage_plain(*args, kind=kind)
        sync()
        what = f"P={p} {kind} {variant}{' ' + str(geo) if geo else ''}"
        errors.hold("ml_score", got, want, what)
        if p == BIG_VEC or geo:
            say(f"check ml_score {what}: exact, {int(want[1].sum())} "
                f"flagged, {int(want[2].sum())} drop requests")
    say(f"check ml_score: {len(cases)} cases exact")


def check_tenant_kernels(dev, errors: Errors, seed: int,
                         sess_buckets: int) -> None:
    """The tenant forms on the card against their plain versions:
    ``sess_probe_ways`` with the key tenants' slices (``tnt_slices``:
    mixed slices, the unsliced residual, kt 0 and T - 1, keys of
    differing tenants) on both hashes at W = 1, 2, 4, 16 and P = 1, 33,
    256, 4,095 and 4,096 (the slice's 2^18 buckets at the last three),
    the 16-byte path and the scalar one; and ``ml_score`` with a tenant
    id per packet (every mode, the inherit sentinel, overrides) for both
    kinds at P = 1, 33, 256, 4,095 and 4,096."""
    rng = np.random.default_rng(seed + 29)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n_cases = 0
    for p, nb, w, misalign in (
            (1, 1, 1, False), (33, 32, 2, False), (100, 64, 4, True),
            (64, 16, 16, False), (VEC, sess_buckets, 4, False),
            (BIG_VEC - 1, sess_buckets, 4, False),
            (BIG_VEC, sess_buckets, 4, False)):
        tnt = tnt_slices(rng, p, nb)
        args = sess_case(rng, p, nb, w, dev, misalign, tnt)
        dtnt = tuple(t.to(dev) for t in tnt)
        for sym in (False, True):
            now = torch.tensor(1000, dtype=torch.int32, device=dev)
            age = torch.tensor(200, dtype=torch.int32, device=dev)
            got = session.sess_probe_ways(*args, now, age, sym=sym,
                                          tnt=dtnt)
            want = session.sess_probe_reverse_plain(*args, 1000, 200,
                                                    sym=sym, tnt=dtnt)
            sync()
            what = (f"tenant form P={p} NB={nb} W={w}"
                    f"{' misaligned' * misalign} sym={int(sym)}")
            errors.hold("sess_probe_ways", got, want, what)
            n_cases += 1
            say(f"check sess_probe_ways {what}: exact, "
                f"{int(want[0].sum())} hits, "
                f"{len(set(tnt[0].tolist()))} key tenants")
    for p in (1, 33, VEC, BIG_VEC - 1, BIG_VEC):
        for kind in ("mlp", "forest"):
            for variant in ("random", "thresh-min", "drop", "ratelimit"):
                *args, tid = ml_case(rng, p, dev, kind, variant,
                                     tenants=True)
                got = mlscore.ml_stage(*args, kind=kind, tid=tid)
                want = mlscore.ml_stage_plain(*args, kind=kind, tid=tid)
                sync()
                errors.hold("ml_score", got, want,
                            f"tid form P={p} {kind} {variant}")
                n_cases += 1
        say(f"check ml_score tid form P={p}: exact ({int(want[1].sum())} "
            f"flagged, {int(want[2].sum())} drop requests, last case)")
    say(f"check tenant forms: {n_cases} cases exact")


def check_kernels(dev, errors: Errors, seed: int, n_rules: int,
                  sess_buckets: int, npad: int) -> None:
    """Phase 3: each kernel against its plain version, edge shapes and
    the slice's shapes, synchronising after each."""
    rng = np.random.default_rng(seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for p, nb, w, misalign in (
            (1, 1, 1, False), (33, 32, 2, False), (100, 16, 1, False),
            (64, 8, 16, False), (33, 64, 4, True),
            (VEC, sess_buckets, 4, False), (BIG_VEC - 1, sess_buckets, 4,
                                            False),
            (BIG_VEC, sess_buckets, 4, False)):
        args = sess_case(rng, p, nb, w, dev, misalign)
        for sym in (False, True):
            for now, age in ((1000, 200), (0, 0x7FFFFFFF)):
                # the device scalars (a captured step's clock and age
                # limit), then the ints the no-age lookup passes
                max_age, now_arg = (
                    (torch.tensor(age, dtype=torch.int32, device=dev),
                     torch.tensor(now, dtype=torch.int32, device=dev))
                    if now else (age, now))
                got = session.sess_probe_ways(*args, now_arg, max_age,
                                              sym=sym)
                want = session.sess_probe_reverse_plain(*args, now, age,
                                                        sym=sym)
                sync()
                what = (f"P={p} NB={nb} W={w}{' misaligned' * misalign} "
                        f"sym={int(sym)} now={now}")
                errors.hold("sess_probe_ways", got, want, what)
                say(f"check sess_probe_ways {what}: exact, "
                    f"{int(want[0].sum())} hits")
    words = (n_rules + 31) // 32
    n_int = 2 * n_rules + 2
    for p, rows, w, tables, misalign in (
            (1, 4, 1, None, False), (5, 7, 3, None, False),
            (300, 50, 20, None, False), (300, 50, 20, None, True),
            (65, 90, 33, None, False), (70, 300, 36, None, False),
            (VEC, n_int, words, None, False),
            (BIG_VEC - 1, n_int, words, None, False),
            (BIG_VEC, n_int, words, None, False),
            (1, 258, 4, 16, False), (33, 258, 4, 16, False),
            (VEC, 258, 4, 16, False), (BIG_VEC, 258, 4, 16, False)):
        args = bv_case(rng, p, rows, w, tables, dev, misalign)
        got = acl_bv.bv_first_set(*args)
        want = acl_bv.bv_search_first_set_plain(*args)
        sync()
        got = got if tables else (got,)
        want = want if tables else (want,)
        what = (f"P={p} I={rows} W={w} T={tables}"
                f"{' misaligned' * misalign}")
        errors.hold("bv_first_set", got, want, what)
        say(f"check bv_first_set {what}: exact, "
            f"{int((want[-1] != acl_bv.BV_ENC_MISS).sum())} matched"
            + (f", {int((want[0] < 0).sum())} without a table"
               if tables else ""))
    # the last four: live sets (each length rounded up to 4 entries)
    # exactly at the kernel's shared-memory budget, one length over it,
    # and all 33 lengths full (far over it): the kernel searches device
    # memory for the last three
    at_budget = [32, 28, 24, 20][:lpm.LPM_SMEM_ENTRIES // npad]
    all_lens = list(range(32, -1, -1))
    for p, lens, npad_, fill in (
            (7, [32, 24, 0], 16, False), (5, [], 1, False),
            (33, [0], 1, False), (64, [32], 8, False), (65, [32, 0], 6, False),
            (VEC, all_lens, npad, False), (BIG_VEC, all_lens, npad, False),
            (BIG_VEC, at_budget, npad, True),
            (BIG_VEC, at_budget + [8], npad, True),
            (VEC, all_lens, npad, True), (BIG_VEC, all_lens, npad, True)):
        args = lpm_case(rng, p, lens, npad_, dev, fill)
        got = lpm.lpm_fused_lookup(*args)
        want = lpm.lpm_fused_lookup_plain(*args)
        sync()
        errors.hold("lpm_fused_lookup", got, want,
                    f"P={p} L={len(lens)} Npad={npad_}")
        live = int(((args[2] + 3) // 4 * 4).sum())
        where = ("shared memory" if npad_ % 4 == 0
                 and live <= lpm.LPM_SMEM_ENTRIES else "device memory")
        say(f"check lpm_fused_lookup P={p} L={len(lens)} Npad={npad_} "
            f"live {live} ({where}): exact, {int(want[0].sum())} found")
    r_cap = acl_mxu.mxu_rule_capacity(n_rules)
    for p, r, kind in ((1, 1, "random"), (7, 8, "random"),
                       (70, 100, "random"), (255, 1023, "random"),
                       (VEC, 1024, "random"), (VEC, 1025, "random"),
                       (65, 4000, "random"), (129, 1100, "random"),
                       (BIG_VEC - 1, r_cap - 40, "random"),
                       (VEC, r_cap, "random"), (BIG_VEC, r_cap, "random"),
                       (VEC, r_cap, "miss"), (VEC, 1025, "multi"),
                       (BIG_VEC - 1, 1000, "multi"),
                       (BIG_VEC, r_cap, "multi")):
        args = mxu_case(rng, p, r, dev, kind)
        got = acl_mxu.mxu_first_match(*args)
        want = acl_mxu.mxu_first_match_plain(*args)
        sync()
        errors.hold("mxu_first_match", (got,), (want,),
                    f"P={p} R'={r} {kind}")
        hits = int((want != int(acl_mxu.ENC_MISS)).sum())
        if (hits == 0) != (kind == "miss"):
            raise AssertionError(f"mxu_first_match case P={p} R'={r} "
                                 f"{kind}: {hits} matched")
        say(f"check mxu_first_match P={p} R'={r} {kind}: exact, {hits} "
            f"matched, {torch.unique(want).numel()} distinct columns")
    check_ml_kernel(dev, errors, seed)
    check_tenant_kernels(dev, errors, seed, sess_buckets)


# --- the kernels' inputs on the main path, and their bounds -------------


def main_path_inputs(dp: Dataplane, fwd: dict, rep: dict, now: int):
    """Each kernel's arguments as ``process`` builds them from the live
    tables: the session lookup and the local classify on a reply
    vector, the global classify and the FIB walk on a forward vector."""
    t = dp.tables
    fpk = packet_vector_from_numpy(fwd, dp.device)
    rpk = packet_vector_from_numpy(rep, dp.device)
    sess = (*rpk.five_tuple, *session._columns(t), now,
            t.sess_max_age)
    glb = (*fpk.five_tuple, *acl_bv._glb_args(t))
    loc = (*rpk.five_tuple, *acl_bv._acl_args(t), rpk.rx_if,
           t.if_local_table)
    fib = (fpk.dst_ip, *lpm._stack(t))
    return dict(sess=sess, glb=glb, loc=loc, fib=fib)


def bound(nbytes: float, ops: float, tc_ops: float = 0.0,
          tc_rate: float = TC_BF16_FLOPS):
    """(ms, what bounds it): the largest of bytes over HBM bandwidth,
    ALU operations over the ALU peak and tensor-core operations over the
    tensor-core peak of their type (``tc_rate``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ALU_OPS_PER_S, tc_ops / tc_rate) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mxu_bound(*args, tc_rate: float = TC_INT8_OPS):
    """Five header columns and the int8 operand (k folded in) in, the
    encodes out; 2 * P * 128 * R' tensor-core operations (int8 by
    default, ``TC_BF16_FLOPS`` for the bf16 figure) and ~2 ALU
    operations per (packet, rule) in the epilogue (compare with 0,
    select)."""
    p, r = args[0].shape[0], args[5].shape[0]
    nbytes = p * 5 * 4 + r * acl_mxu.PLANES + p * 4
    return bound(nbytes, 2.0 * p * r, 2.0 * p * acl_mxu.PLANES * r,
                 tc_rate)


def sess_bound(args, tnt=None):
    """Header columns in, the distinct home buckets' W ways of six
    columns and max_age, found (1 B) and slot (4 B) out; ~20 integer
    operations a packet for the key and the hash, ~12 a way. ``tnt``
    (the tenant form): the key tenants in too, the base and mask entries
    of the tenants present, the sliced buckets, ~4 operations more a
    packet."""
    hdr, cols = args[:5], args[5:11]
    nb, ways = cols[0].shape
    p = hdr[0].shape[0]
    b = session._reverse_bucket(*hdr, session._reverse_keys(*hdr), nb,
                                False, tnt)
    buckets = torch.unique(b).numel()
    extra_bytes = extra_ops = 0
    if tnt is not None:
        extra_bytes = p * 4 + torch.unique(tnt[0]).numel() * 8
        extra_ops = p * 4
    return bound(p * 5 * 4 + buckets * ways * 6 * 4 + 4 + p * 5
                 + extra_bytes, p * (20 + 12 * ways) + extra_ops)


def _bisect_visits(bnd, t, n, vals, signed: bool):
    """(the distinct flat entries of ``bnd`` [T, I] that a bisection of
    each packet's value over its table's live prefix [0, n) visits, the
    probes it makes in all)."""
    size = bnd.shape[1]
    key = (lambda x: x.to(torch.int64)) if signed else u32
    v = key(vals)
    base = t.to(torch.int64) * size
    lo = torch.zeros_like(v)
    hi = torch.clamp(n.to(torch.int64), 0, size)
    seen, probes = [], 0
    while bool((lo < hi).any()):
        act = lo < hi
        mid = (lo + hi) // 2
        flat = base + torch.clamp(mid, max=size - 1)
        seen.append(flat[act])
        probes += int(act.sum())
        le = key(bnd.reshape(-1)[flat]) <= v
        lo = torch.where(act & le, mid + 1, lo)
        hi = torch.where(act & ~le, mid, hi)
    visited = torch.unique(torch.cat(seen)).numel() if seen else 0
    return visited, probes


def bv_bound(args):
    """Header columns in (and for a local classify rx_if, the interface
    table entries and the counts rows it reads), the distinct boundary
    entries a bisection of these packets visits, the distinct bitmap
    rows (W words each), and enc (and tid) out; ~4 integer operations a
    bisection probe and ~8 a packet word."""
    hdr, bnds, nbnd, planes = args[:5], args[5:9], args[9], args[10:15]
    local = len(args) > 15
    p = hdr[0].shape[0]
    words = planes[0].shape[-1]
    if local:
        rx_if, table = args[15:17]
        tid = table[gather_index(rx_if, table.shape[0])]
        t = torch.clamp(tid, min=0)
        nbytes = p * 6 * 4 + p * 8 + 4 * (
            torch.unique(rx_if).numel() + torch.unique(t).numel() * 4)
    else:
        bnds = [b[None] for b in bnds]
        planes = [pl[None] for pl in planes]
        nbnd = nbnd[None]
        t = torch.zeros_like(hdr[0])
        nbytes = p * 5 * 4 + p * 4 + 16
    probes = 0
    for k, (b, v) in enumerate(zip(bnds, (hdr[0], hdr[1], hdr[3], hdr[4]))):
        visited, pr = _bisect_visits(b, t, nbnd[t.long(), k], v, k >= 2)
        nbytes += visited * 4
        probes += pr
    # the segment rows, as the plain version finds them
    if local:
        _, _, rows = acl_bv._local_rows(*hdr, *args[15:17], *args[5:10],
                                        planes[4].shape[1])
    else:
        rows = acl_bv._global_rows(*hdr, *args[5:10], planes[4].shape[1])
    for pl, r in zip(planes, rows):
        key = t.long() * pl.shape[-2] + r.long()
        nbytes += torch.unique(key).numel() * words * 4
    return bound(nbytes, probes * 4 + p * words * 8)


def lpm_bound(dst, lens, cnt, pfx, slot):
    """Destinations in, the live plane entries (prefix and slot), and
    found/slot out; the operations of the walk this data needs: each
    packet bisects the lengths down to its first hit (~5 operations a
    probe, ~8 a length)."""
    p, n_len = dst.shape[0], lens.shape[0]
    nbytes = p * 4 + n_len * 8 + int(cnt.sum()) * 8 + p * 8
    if n_len == 0:
        return bound(nbytes, 0)
    m = bias(to_i32(u32(dst)[None, :] & lpm._len_masks(lens)[:, None]))
    i = torch.searchsorted(pfx, m.contiguous())
    ic = torch.clamp(i, max=pfx.shape[1] - 1)
    hit = (torch.gather(pfx, 1, ic) == m) & (i < cnt[:, None])
    walked = torch.where(hit.any(dim=0), first_true(hit.t()) + 1, n_len)
    steps = torch.ceil(torch.log2(cnt.double() + 1))          # [L]
    per_len = torch.cumsum(steps * 5 + 8, 0)                  # [L]
    ops = float(per_len[walked.long() - 1].sum())
    return bound(nbytes, ops)


# --- timing -----------------------------------------------------------------


def time_eager(fn, iters: int) -> float:
    """Median device ms of ``fn()`` called eagerly, each call between
    its own pair of CUDA events (host launch overhead included where
    the device waits on it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def time_graph(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device ms of one ``fn()`` launch: ``per_graph`` launches captured
    in a CUDA graph, replayed back to back between CUDA events, so no
    host launch overhead is counted."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * per_graph)


def _process(dp: Dataplane, vec, now: int):
    """``dp.process`` of a PacketVector, or of a (PacketVector, sidecar
    kwargs) pair (the overlay's inner header and VNI)."""
    if isinstance(vec, PacketVector):
        return dp.process(vec, now=now)
    return dp.process(vec[0], now=now, **vec[1])


def time_process(dp: Dataplane, vecs, steps: int, now: int, tier=None):
    """Median device ms (CUDA events around each call) and median host
    wall ms per synchronised ``process`` step, cycling through ``vecs``
    (each a PacketVector or a pair with its sidecar, ``_process``); with
    ``tier``, every timed step must ride it (1: the fast tier, 0: the
    full chain)."""
    for k in range(4):
        _process(dp, vecs[k % len(vecs)], now)
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for k in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        res = _process(dp, vecs[k % len(vecs)], now + 1 + k)
        b.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
        if tier is not None and int(res.stats.fastpath) != tier:
            raise AssertionError(f"a timed step left tier {tier}")
    return float(np.median(dev_ms)), float(np.median(wall_ms))


def time_steps(dp: Dataplane, up: int, pods, n: int, steps: int,
               seed: int, now: int):
    """``time_process`` over a forward vector of ``n`` packets
    alternating with the replies to all its packets; also returns the
    two vectors (numpy)."""
    fwd = forward_traffic(n, up, seed)
    first = dp.process(packet_vector_from_numpy(fwd, dp.device), now=now)
    rep = reply_traffic(snapshot(first), pods)
    vecs = [packet_vector_from_numpy(v, dp.device) for v in (fwd, rep)]
    return (*time_process(dp, vecs, steps, now), fwd, rep)


# the step's layers, as the functions pipeline_step calls (with the
# stages of phase 4e: the decap, the tenant stage and its key tenants,
# the token bucket, the service lookup, the encap, the accounting)
STAGES = ((graph, ("_ingress", "session_lookup_reverse_idx",
                   "session_batch_summary", "nat44_dnat_match",
                   "session_touch", "nat44_reverse", "nat44_touch",
                   "nat44_dnat", "nat44_snat", "session_insert",
                   "nat44_record", "_finish_step", "acl_classify_local",
                   "vxlan_decap_step", "_tenant_eval", "tenant_limit",
                   "vxlan_encap", "tnt_account", "ml_stage",
                   "tel_flow_update", "session_sweep")),
          (acl_bv, ("acl_classify_global_pallas",
                    "acl_classify_local_pallas")),
          (acl_mxu, ("acl_classify_global_mxu",)),
          (lpm, ("fib_lookup_lpm_fused",)),
          (derive, ("key_tenant",)),
          (nat44, ("_svc_lookup",)))


@contextlib.contextmanager
def stage_spans():
    """Wrap every layer of the step in a ``record_function`` span named
    ``stage:<function>`` (for the profile only; restored after)."""
    from torch.profiler import record_function

    def spanned(name, fn):
        def run(*a, **kw):
            with record_function(f"stage:{name}"):
                return fn(*a, **kw)
        return run

    saved = [(mod, name, getattr(mod, name))
             for mod, names in STAGES for name in names]
    for mod, name, fn in saved:
        setattr(mod, name, spanned(name, fn))
    graph.make_pipeline_step.cache_clear()
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        graph.make_pipeline_step.cache_clear()


def profile_steps(dp: Dataplane, vecs, steps: int, now: int,
                  spans: bool = True) -> dict:
    """``torch.profiler`` over ``steps`` process steps: device operations,
    graph launches and host syncs per step, their summed device time per
    step, the window's wall time, the device's idle share (one stream:
    operations do not overlap, so busy = the sum), host and device ms
    per step of each layer (``spans``: eager steps only, a graph replay
    has no layers on the host), and the costliest host-side ops."""
    from torch.profiler import ProfilerActivity, profile

    with stage_spans() if spans else contextlib.nullcontext():
        for k in range(4):
            _process(dp, vecs[k % 2], now)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(steps):
                _process(dp, vecs[k % 2], now + 1 + k)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # device work: kernels, copies and fills (not the device-side
    # copies of the stage spans)
    work = [e for e in prof.events() if e.device_type == cuda
            and not e.name.startswith("stage:")]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    table = prof.key_averages()
    stages = [e for e in table
              if e.key.startswith("stage:") and e.device_type == cpu]
    syncs = sum(e.count for e in table if e.key == "cudaStreamSynchronize")
    launches = sum(e.count for e in table if e.key == "cudaGraphLaunch")
    ops = sorted((e for e in table if e.device_type == cpu
                  and not e.key.startswith("stage:")),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    return dict(
        device_ops_per_step=len(work) / steps,
        graph_launches_per_step=launches / steps,
        host_syncs_per_step=syncs / steps,
        device_busy_ms_per_step=busy_ms / steps,
        wall_ms_per_step=wall_ms / steps,
        device_idle_share=1.0 - busy_ms / wall_ms,
        host_ms_per_step_by_layer={
            e.key[6:]: e.cpu_time_total / 1e3 / steps for e in stages},
        device_ms_per_step_by_layer={
            e.key[6:]: e.device_time_total / 1e3 / steps for e in stages},
        top_host_ops={e.key: [e.count / steps,
                              e.self_cpu_time_total / 1e3 / steps]
                      for e in ops})


def graph_times(dp: Dataplane, n: int, replays: int = 20) -> dict:
    """Per captured part of ``dp``'s P = ``n`` step program: the device
    ms of one replay (CUDA events around ``replays`` back-to-back
    replays) and the host ms one ``CUDAGraph.replay`` call takes
    (median). The replays step the live state again with the last
    batch; they are not main-path launches and count nowhere."""
    prog = next(p for p in dp.programs() if p.shape == (9, n))
    out = {}
    for part in (p for p in prog.parts() if p.graph is not None):
        torch.cuda.synchronize()
        host = []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            t0 = time.perf_counter()
            part.graph.replay()
            host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        torch.cuda.synchronize()
        out[part.label.split(":")[-1] if ":" in part.label else "full"] = \
            dict(ms=a.elapsed_time(b) / replays,
                 launch_host_ms=float(np.median(host)))
    return out


# the model planes and policy scalars csrc/ml_score.cu reads, by kind
ML_READS = {
    "mlp": ("glb_ml_w1", "glb_ml_b1", "glb_ml_s1", "glb_ml_w2", "glb_ml_b2",
            "glb_ml_thresh", "glb_ml_action", "glb_ml_rl_shift"),
    "forest": ("glb_ml_b2", "glb_ml_f_feat", "glb_ml_f_thresh",
               "glb_ml_f_leaf", "glb_ml_thresh", "glb_ml_action",
               "glb_ml_rl_shift"),
}


def ml_bound(p: int, kind: str, planes, tid=None):
    """Header columns (7 int32), established and alive (1 B each) and
    the age (int32) in; the model planes and scalars the kind reads, at
    their own element sizes (int8 W1 and w2); scores (int32), flagged
    and drop (1 B each) out. Operations: 2 per multiply-add (P x (18 H
    + H) for the MLP; the forest's P x T x D selects of 18 compares
    each), and ~60 a packet for the features, the hash and the
    policy. ``tid`` (the tid form): the tenant ids in too, the mode and
    threshold of the tenants present, ~6 operations more a packet."""
    model = sum(getattr(planes, f).numel() * getattr(planes, f).element_size()
                for f in ML_READS[kind])
    if tid is not None:
        model += p * 4 + torch.unique(tid).numel() * 8
    hidden = planes.glb_ml_w1.shape[1]
    trees, depth = planes.glb_ml_f_feat.shape
    nbytes = p * (7 * 4 + 1 + 4 + 1) + model + p * (4 + 1 + 1)
    per = (2 * (18 * hidden + hidden) if kind == "mlp"
           else trees * depth * (2 * 18 + 4) + trees)
    return bound(nbytes, p * (per + 60 + (6 if tid is not None else 0)))


def ml_kernel_times(dp: Dataplane, cols: dict, n: int, errors: Errors,
                    seed: int):
    """``ml_stage`` at the main path's shapes: the header of one of its
    reply vectors, the session hit as ``established`` and a spread of
    ages, through the trained MLP (planes staged as phase 4d stages
    them) and the seeded forest; kernel ms (graph replay), the eager
    call, the plain version, and ``torch._int_mm`` of the layer-1
    product padded to [P, 24] x [24, 16] (the port never calls it)."""
    from vpp_tpu_torch.pipeline.tables import _fold_ml

    dev = dp.device
    pk = packet_vector_from_numpy(cols, dev)
    alive = pk.valid
    age = (torch.arange(n, device=dev, dtype=torch.int32) * 7) % 300
    models = dict(ml_models(seed))
    out = {}
    for kind in ("mlp", "forest"):
        folded, _ = _fold_ml(models[kind], dp.config)
        planes = type("MlPlanes", (), {
            f: torch.from_numpy(np.array(a)).to(dev)
            for f, a in folded.items()})
        args = (planes, pk, alive, alive, age)

        def kern(a=args, k=kind):
            return mlscore.ml_stage(*a, kind=k)

        def plain(a=args, k=kind):
            return mlscore.ml_stage_plain(*a, kind=k)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        errors.hold("ml_score", got, want, f"{kind} main-path P={n}")
        b_ms, b_by = ml_bound(n, kind, planes)
        row = dict(ms=time_graph(kern), call_ms=time_eager(kern, TIMED_STEPS),
                   plain_ms=time_eager(plain, TIMED_STEPS), bound_ms=b_ms,
                   bound_by=b_by)
        if kind == "mlp":
            xc = mlscore._centered(mlscore.ml_features(pk, alive, age))
            xpad = torch.nn.functional.pad(xc, (0, 6))
            # the second operand column-major, as cuBLASLt takes it
            wpad = torch.nn.functional.pad(
                planes.glb_ml_w1, (0, 0, 0, 6)).t().contiguous().t()
            row["library_ms"] = time_graph(
                lambda a=xpad, b=wpad: torch._int_mm(a, b))
        out[("ml_score" if kind == "mlp" else "ml_score.forest", n)] = row
        say(f"kernel ml_score {kind} P={n}: {row['ms']:.5f} ms (graph "
            f"replay), {row['call_ms']:.5f} ms per eager call, plain "
            f"{row['plain_ms']:.5f} ms, bound {b_ms:.6f} ms ({b_by})"
            + (f", torch._int_mm [{n}, 24] x [24, 16] "
               f"{row['library_ms']:.5f} ms" if kind == "mlp" else "")
            + ", bit-exact")
    return out


def tnt_kernel_times(dp: Dataplane, rep: dict, n: int, errors: Errors,
                     now: int):
    """The tenant forms at phase 4e's inputs: ``sess_probe_ways`` on a
    reply vector's header with its key tenants and the live slice
    planes, and ``ml_score`` (the trained MLP, as staged) with the
    vector's billing tenants and the live per-tenant vectors, each
    against its plain version: kernel ms (graph replay), the eager call,
    the plain version, the bound (``sess_bound`` / ``ml_bound`` with the
    tenant inputs)."""
    t = dp.tables
    dev = dp.device
    pk = packet_vector_from_numpy(rep, dev)
    tnt = (key_tenant(t, pk.dst_ip, pk.src_ip), t.tnt_sess_base,
           t.tnt_sess_mask)
    sess = (*pk.five_tuple, *session._columns(t),
            torch.tensor(now, dtype=torch.int32, device=dev), t.sess_max_age)
    tid = tenant_ids(t, pk)
    age = (torch.arange(n, device=dev, dtype=torch.int32) * 7) % 300
    ml = (t, pk, pk.valid, pk.valid, age)
    cases = {
        "sess_probe_ways.tenant": (
            lambda: session.sess_probe_ways(*sess, tnt=tnt),
            lambda: session.sess_probe_reverse_plain(*sess, tnt=tnt),
            sess_bound(sess, tnt)),
        "ml_score.tid": (
            lambda: mlscore.ml_stage(*ml, kind="mlp", tid=tid),
            lambda: mlscore.ml_stage_plain(*ml, kind="mlp", tid=tid),
            ml_bound(n, "mlp", t, tid)),
    }
    out = {}
    for name, (kern, plain, (b_ms, b_by)) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        errors.hold(name.split(".")[0], got, want, f"{name} main-path P={n}")
        row = dict(ms=time_graph(kern), call_ms=time_eager(kern, TIMED_STEPS),
                   plain_ms=time_eager(plain, TIMED_STEPS), bound_ms=b_ms,
                   bound_by=b_by, key_tenants=torch.unique(tnt[0]).numel())
        out[(name, n)] = row
        say(f"kernel {name} P={n}: {row['ms']:.5f} ms (graph replay), "
            f"{row['call_ms']:.5f} ms per eager call, plain "
            f"{row['plain_ms']:.5f} ms, bound {b_ms:.6f} ms ({b_by}), "
            f"{row['key_tenants']} tenants, bit-exact")
    return out


def idle_share(prof: dict, step_ms: float) -> float:
    """The device's idle share of a timed step: 1 - the profiled window's
    busy ms per step over the step's ms timed without the profiler
    (which slows the host's graph launches)."""
    return max(0.0, 1.0 - prof["device_busy_ms_per_step"] / step_ms)


def run_path(cfg: DataplaneConfig, path: str, n_rules: int, n_nodes: int,
             seed: int):
    """Stage ``cfg`` on the card, drive the main path with every launch
    counter set to 0 just before and read just after (each kernel of
    ``path`` must have launched, no other), then replay the same steps
    on the CPU: every result field, counter and the final state must be
    equal. Returns (dp, uplink, pods, inputs, snapshots, launches)."""
    t0 = time.perf_counter()
    gpu = Dataplane(cfg)
    up, pods = stage(gpu, n_rules, n_nodes)
    rungs = (gpu.classifier_impl, gpu.fib_impl, gpu.session_impl)
    say(f"staged {path}: {n_rules} global rules, {N_PODS} pods on "
        f"{cfg.max_rules}-rule local tables, "
        f"{gpu.builder.fib_route_count()} routes, {cfg.sess_slots} "
        f"session slots, VIP with {N_BACKENDS} backends in "
        f"{time.perf_counter() - t0:.1f} s; rungs {'/'.join(rungs)}, "
        f"fast path {'on' if gpu._use_fastpath else 'off'}")
    if rungs != (path, "pallas", "pallas"):
        raise AssertionError(f"rungs {rungs} selected for the {path} path")
    if tuple(gpu.tables.fib_lpm_stk_pfx.shape) != (33, cfg.fib_slots):
        raise AssertionError("unexpected LPM stack shape "
                             f"{tuple(gpu.tables.fib_lpm_stk_pfx.shape)}")
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inputs, snaps = drive(gpu, up, pods, ROUNDS, seed)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    say(f"main path {path}: {len(inputs)} process steps on the card in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    if any((launches[k] > 0) != (k in PATH_KERNELS[path])
           for k in WRAPPERS):
        raise AssertionError(f"the {path} path launched {launches}, "
                             f"expected exactly {PATH_KERNELS[path]}")

    t0 = time.perf_counter()
    cpu = Dataplane(cfg, device="cpu")
    stage(cpu, n_rules, n_nodes)
    csnaps = replay(cpu, inputs)
    for k, (g, c) in enumerate(zip(snaps, csnaps)):
        assert_equal(c, g, f"{path} step {k}")
    assert_equal(state_of(cpu), state_of(gpu), f"{path} final state")
    say(f"reference {path}: the same {len(inputs)} steps on the CPU "
        f"(plain versions, rungs {cpu.classifier_impl}/{cpu.fib_impl}/"
        f"{cpu.session_impl}) in {time.perf_counter() - t0:.1f} s; every "
        f"result field, counter and the session/NAT state bit-exact")
    return gpu, up, pods, inputs, snaps, launches


def packed_batch(cols: dict) -> np.ndarray:
    """A vector's columns as the ``[5, n]`` bit-packed batch."""
    n = cols["src_ip"].shape[0]
    flat = packed_input_zeros(n)
    pack_packet_columns(flat.view(np.uint32), cols, n)
    return flat


def packed_snap(out: np.ndarray) -> dict:
    """The fields of a packed result ``reply_traffic`` reads."""
    dec = unpack_packet_result(np.array(out))
    return {"pkts.src_ip": dec["src_ip"].view(np.int32),
            "pkts.dst_ip": dec["dst_ip"].view(np.int32),
            "pkts.sport": dec["sport"], "pkts.dport": dec["dport"],
            "disp": dec["disp"]}


def eager_vs_captured(cfg: DataplaneConfig, path: str, n_rules: int,
                      n_nodes: int, seed: int, n: int = VEC):
    """Phase 4c: a captured dataplane and an eager one (``graphs=False``)
    staged alike take the same vectors through ``process``,
    ``process_packed`` and ``process_packed_chain`` (K = CHAIN_K), with
    a swap that changes no shape and an ``expire_sessions`` between the
    two rounds; every result, aux row and the final state must be equal,
    and the captured side's table tensors must stay where they were.
    The clock starts far above the wall-clock ticks, and the expiry
    runs at the last step's clock, so it cuts at the same point on both.
    Returns (captured, eager, tiers of the
    chains' sub-batches)."""
    t0 = time.perf_counter()
    dps = [Dataplane(cfg, graphs=g) for g in (True, False)]
    up, pods = stage(dps[0], n_rules, n_nodes)
    if stage(dps[1], n_rules, n_nodes) != (up, pods):
        raise AssertionError("the two stagings differ")
    ptrs = [t.data_ptr() for t in dps[0].tables]
    now = 10 ** 6
    tiers = []

    def both(fn, what):
        got = [fn(dp) for dp in dps]
        assert_equal(got[1], got[0], f"{path} eager vs captured {what}")
        return got[0]

    def arrays(ts):
        return {f"{k}": t.cpu().numpy() for k, t in enumerate(ts)}

    for rnd in range(2):
        fwd = forward_traffic(n, up, seed + 31 * rnd)
        snap = both(lambda dp: snapshot(dp.process(
            packet_vector_from_numpy(fwd, dp.device), now=now)), "process")
        rep = reply_traffic(snap, pods, "forwarded")
        both(lambda dp: snapshot(dp.process(
            packet_vector_from_numpy(rep, dp.device), now=now + 1)),
            "process (replies)")
        flat = packed_batch(forward_traffic(n, up, seed + 31 * rnd + 1))
        got = both(lambda dp: arrays(dp.process_packed(
            flat, now=now + 2, with_aux=True)), "process_packed")
        first = packed_snap(got["0"])
        flats = np.stack(
            [packed_batch(forward_traffic(n, up, seed + 31 * rnd + 2 + i))
             for i in range(CHAIN_K - 2)]
            + [packed_batch(reply_traffic(first, pods, to))
               for to in ("forwarded", "dropped")])
        got = both(lambda dp: arrays(dp.process_packed_chain(
            flats, now=now + 3, with_aux=True)), "process_packed_chain")
        tiers.append(got["1"][:, 0].tolist())
        both(state_of, "state")
        if rnd == 0:
            for dp in dps:
                dp.builder.add_route("10.250.0.0/24", up, Disposition.REMOTE,
                                     next_hop=ip4("192.168.250.1"),
                                     node_id=250)
                dp.swap()
            for dp in dps:
                dp._now = now + 3  # the clock of the last step
            # the sessions last hit at ``now + 1`` or before expire
            expired = both(lambda dp: {"n": np.array(
                dp.expire_sessions(max_age=1))}, "expire_sessions")["n"]
            if int(expired) <= 0:
                raise AssertionError("the expiry reclaimed nothing")
            if [t.data_ptr() for t in dps[0].tables] != ptrs:
                raise AssertionError("a same-shape swap or the expiry "
                                     "replaced a live table tensor")
        now += 10
    say(f"eager vs captured {path}: 2 rounds of process, process_packed "
        f"and process_packed_chain (K={CHAIN_K}) at P={n} around a "
        f"same-shape swap and an expiry of {int(expired)} sessions, "
        f"{time.perf_counter() - t0:.1f} s with the staging; every result, "
        f"aux row and the final state equal; chain tiers {tiers}; every "
        f"table tensor kept")
    return dps[0], dps[1], tiers


# --- phase 4d: the ML stage and telemetry on the slice -------------------

# latencies (µs) of the stamped packed batches: 0..3, both sides of 2^3
# and 2^10, and past the last of the 24 buckets (2^23 and up)
TEL_OFFSETS = (0, 1, 2, 3, 7, 8, 1023, 1024, (1 << 24) + 5)
NOW_US = 1 << 30      # the dispatch clock of every stamped call
CHAIN_ML_K = 4        # sub-batches of phase 4d's stamped chain


def ml_slice_config(cfg: DataplaneConfig) -> DataplaneConfig:
    """The slice with the ML stage enforcing (capacity: 16 hidden, 4
    trees of depth 3) and full telemetry at the reference's defaults
    (24 log2 µs buckets, a 2 x 1,024 count-min sketch, top-8)."""
    return cfg._replace(ml_stage="enforce", ml_hidden=16, ml_trees=4,
                        ml_depth=3, telemetry="full")


@functools.lru_cache(maxsize=None)
def ml_models(seed: int):
    """The run sequence's models: bench.py ``ml_stage_bench``'s MLP
    (``train_and_pack(kind="mlp", hidden=16, samples=2048,
    action="drop")``, from ``seed``); a forest of 4 trees x depth 3
    drawn from ``seed`` (features, thresholds and leaf votes at random;
    the flag threshold at the median score of a forward vector and its
    replies, so that it flags on both tiers: the trained models treat
    an established flow as benign); then that forest with
    ``action="ratelimit"``, ``rl_shift=1`` (table values only)."""
    mlp, _ = train_and_pack(kind="mlp", hidden=16, samples=2048,
                            action="drop", seed=seed)
    rng = np.random.default_rng(seed)
    forest = MlModel(
        kind="forest", version=2, n_features=18,
        f_feat=rng.integers(0, 12, (4, 3)).astype(np.int32),
        f_thresh=rng.integers(0, 256, (4, 3)).astype(np.int32),
        f_leaf=rng.integers(-500, 500, (4, 8)).astype(np.int32),
        action="drop").validate()
    fwd = ml_forward_traffic(VEC, 0, seed)
    rep = dict(fwd, src_ip=fwd["dst_ip"], dst_ip=fwd["src_ip"],
               sport=fwd["dport"], dport=fwd["sport"])
    scores = np.concatenate([
        score_oracle(forest, packet_features(fwd, np.zeros(VEC, bool),
                                             np.zeros(VEC))),
        score_oracle(forest, packet_features(rep, np.ones(VEC, bool),
                                             np.ones(VEC)))])
    forest.flag_thresh = int(np.median(scores))
    rl = dict(forest.to_dict(), version=3, action="ratelimit",
              rl_shift=1)
    return [("mlp", mlp.to_dict()), ("forest", forest.to_dict()),
            ("ratelimit", rl)]


def ml_forward_traffic(n: int, uplink: int, seed: int) -> dict:
    """``forward_traffic`` with the trained model's attack profile on
    1/8 of the packets (the ``make_synth_dataset`` attack slice: 40-79
    byte frames from source ports below 1024), from the permitted rule
    blocks, so the ACL permits them and the enforcing model drops
    them."""
    cols = forward_traffic(n, uplink, seed)
    rng = np.random.default_rng(seed + 1)
    attack = rng.random(n) < 0.125
    cols["pkt_len"] = np.where(attack, rng.integers(40, 80, n),
                               cols["pkt_len"]).astype(np.int32)
    cols["sport"] = np.where(attack, rng.integers(1, 1024, n),
                             cols["sport"]).astype(np.int32)
    return cols


def apply_op(dp: Dataplane, op) -> dict:
    """One recorded call on ``dp``; returns what it gave, as numpy."""
    kind = op[0]
    if kind == "model":
        dp.builder.set_ml_model(op[1])
        dp.swap()
        return {}
    if kind == "process":
        _, vec, now = op
        return snapshot(dp.process(packet_vector_from_numpy(vec, dp.device),
                                   now=now))
    if kind == "packed":
        _, flat, now, stamp, now_us = op
        out, aux = dp.process_packed(flat, now=now, with_aux=True,
                                     stamp_us=stamp, now_us=now_us)
    else:
        _, flat, now, stamp, now_us = op
        out, aux = dp.process_packed_chain(flat, now=now, with_aux=True,
                                           stamps_us=stamp, now_us=now_us)
    return {"out": out.cpu().numpy(), "aux": aux.cpu().numpy()}


def tel_state_of(dp: Dataplane) -> dict:
    return {f: getattr(dp.tables, f).cpu().numpy()
            for f in STATE_FIELDS + tuple(TELEMETRY_FIELDS)}


def _valid(flat: np.ndarray) -> int:
    return int(np.count_nonzero(flat[4] & 1))


def ml_tel_path(cfg: DataplaneConfig, path: str, n_rules: int,
                n_nodes: int, seed: int):
    """Phase 4d on one path: the slice with the ML stage and telemetry
    on, on the card captured and eager and on the CPU. The run sequence,
    each step recorded: the MLP; a forest swapped in (a new program key
    must be captured); the forest's action swapped to ratelimit (table
    values: nothing may be captured). Each sequence drives, at P = 256
    and 4,096, a forward vector and the replies to its forwarded and
    dropped packets through ``process``; packed batches stamped at
    ``NOW_US`` minus ``TEL_OFFSETS`` (and an unstamped one, a negative
    latency, two at P = 4,096) through ``process_packed``; and a stamped
    K = 4 ``process_packed_chain``. The launch counters are set to 0
    just before and read just after. Returns (captured dataplane,
    uplink, pods, launches, summary)."""
    t0 = time.perf_counter()
    mcfg = ml_slice_config(cfg)
    models = ml_models(seed)
    seed += 3  # the traffic's
    made = {}
    for mode, graphs in (("captured", True), ("eager", False)):
        dp = Dataplane(mcfg, graphs=graphs)
        up, pods = stage(dp, n_rules, n_nodes)
        dp.builder.set_ml_model(models[0][1])
        dp.swap()
        made[mode] = dp
    gpu = made["captured"]
    if (gpu._ml_mode, gpu._ml_kind, gpu._tel_mode) != ("enforce", "mlp",
                                                        "full"):
        raise AssertionError(f"{path}+ml: gates {gpu._ml_mode} "
                             f"{gpu._ml_kind} {gpu._tel_mode}")
    say(f"staged {path}+ml: ML enforce (trained MLP, version "
        f"{int(gpu.tables.glb_ml_version)}), telemetry full "
        f"{tuple(gpu.tables.tel_sketch.shape)} sketch, "
        f"{gpu.tables.tel_lat_hist.shape[0]} buckets, in "
        f"{time.perf_counter() - t0:.1f} s (two dataplanes)")
    for w in WRAPPERS.values():
        w.launches = 0
    _sync(gpu.device)
    t1 = time.perf_counter()
    ops, outs = [], []
    nb = gpu.tables.tel_lat_hist.shape[0]
    bins = np.zeros(nb, np.int64)
    keys_by_seq = []
    now = 100

    def run(op):
        ops.append(op)
        outs.append(apply_op(gpu, op))
        return outs[-1]

    def observe(n_valid, off):
        if off is not None and off >= 0:
            bins[int(lat_bucket_np(np.asarray([off]), nb)[0])] += n_valid

    for s, (name, model) in enumerate(models):
        if s:
            run(("model", model))
        keys = set(gpu._programs)
        caps = capture.capture_counts()
        firsts = {}
        for n in (VEC, BIG_VEC):
            firsts[n] = run(("process", ml_forward_traffic(
                n, up, seed + 7919 * s + n), now))
            now += 1
            for to in ("forwarded", "dropped"):
                run(("process", reply_traffic(firsts[n], pods, to), now))
                now += 1
        stamped = ([(VEC, off) for off in TEL_OFFSETS]
                   + [(VEC, None), (VEC, -5), (BIG_VEC, 1024),
                      (BIG_VEC, 0)])
        for k, (n, off) in enumerate(stamped):
            flat = packed_batch(ml_forward_traffic(
                n, up, seed + 31 * s + 101 * k + 1))
            run(("packed", flat, now, 0 if off is None else NOW_US - off,
                 NOW_US))
            observe(_valid(flat), off)
            now += 1
        flats = np.stack(
            [packed_batch(ml_forward_traffic(VEC, up, seed + 977 * s + i))
             for i in range(CHAIN_ML_K - 1)]
            + [packed_batch(reply_traffic(firsts[VEC], pods, "forwarded"))])
        offs = (3, 1024, None, 8)
        run(("chain", flats, now,
             [0 if o is None else NOW_US - o for o in offs], NOW_US))
        for f, o in zip(flats, offs):
            observe(_valid(f), o)
        now += 1
        new_keys = set(gpu._programs) - keys
        new_caps = sum(capture.capture_counts().values()) - sum(
            caps.values())
        keys_by_seq.append((name, len(new_keys), new_caps))
        if s == 1 and not any(k[9] == "forest" for k in new_keys):
            raise AssertionError(f"{path}+ml: the forest swap captured "
                                 f"no forest program ({new_keys})")
        if s == 2 and (new_keys or new_caps):
            raise AssertionError(f"{path}+ml: the action swap built "
                                 f"{len(new_keys)} keys, {new_caps} "
                                 f"captures")
    _sync(gpu.device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    want = PATH_KERNELS.get(f"{path}+ml", ())
    say(f"main path {path}+ml: {len(ops)} calls on the card in "
        f"{time.perf_counter() - t1:.2f} s; launches {launches}; new "
        f"keys / captures per sequence {keys_by_seq}")
    if any((launches[k] > 0) != (k in want) for k in WRAPPERS):
        raise AssertionError(f"the {path}+ml path launched {launches}, "
                             f"expected exactly {want}")

    # the gates on the card's own results
    tiers = {0: np.zeros(3, np.int64), 1: np.zeros(3, np.int64)}
    sketched = alive = 0
    aux_i = {k: i for i, k in enumerate(
        ("fastpath", "rx", "sess_hits", "insert_fails", "evictions",
         "ml_scored", "ml_flagged", "ml_drops", "tel_observed",
         "tel_sketched", "tnt_limited", "tnt_qfail"))}
    for op, out in zip(ops, outs):
        if op[0] == "process":
            tier = int(out["stats.fastpath"])
            tiers[tier] += [int(out[f"stats.{f}"]) for f in (
                "ml_scored", "ml_flagged", "ml_drops")]
            sketched += int(out["stats.tel_sketched"])
            alive += int(out["stats.rx"])
        elif op[0] in ("packed", "chain"):
            aux = out["aux"].reshape(-1, len(aux_i))
            for row in aux:
                tiers[int(row[0])] += row[[aux_i["ml_scored"],
                                           aux_i["ml_flagged"],
                                           aux_i["ml_drops"]]]
            sketched += int(aux[:, aux_i["tel_sketched"]].sum())
            alive += int(aux[:, aux_i["rx"]].sum())
    for tier in ((0, 1) if path == "mxu" else (0,)):
        if tiers[tier][1] <= 0 or tiers[tier][2] <= 0:
            raise AssertionError(f"{path}+ml tier {tier}: scored / "
                                 f"flagged / dropped {tiers[tier]}")
    snap = gpu.telemetry_snapshot()
    if sketched != alive or snap["sketched"] != alive:
        raise AssertionError(f"{path}+ml: {sketched} sketched in the "
                             f"steps, {snap['sketched']} in the plane, "
                             f"{alive} alive packets")
    if not np.array_equal(snap["bins"], bins):
        raise AssertionError(f"{path}+ml: histogram {snap['bins']} != "
                             f"the known latencies' {bins}")
    # a probe and a commit=False packed call move no live plane
    before = tel_state_of(gpu)
    vec = forward_traffic(VEC, up, seed + 5)
    gpu.probe(packet_vector_from_numpy(vec, gpu.device), now=now)
    gpu.process_packed(packed_batch(vec), now=now, commit=False,
                       stamp_us=NOW_US - 2, now_us=NOW_US)
    _sync(gpu.device)
    assert_equal(tel_state_of(gpu), before, f"{path}+ml probe")
    if gpu.telemetry_snapshot()["sketched"] != snap["sketched"]:
        raise AssertionError(f"{path}+ml: a probe moved the counters")

    # captured against eager on the card, then the CPU replay
    t1 = time.perf_counter()
    for k, (op, out) in enumerate(zip(ops, outs)):
        assert_equal(out, apply_op(made["eager"], op),
                     f"{path}+ml eager vs captured call {k} ({op[0]})")
    assert_equal(tel_state_of(made["eager"]), tel_state_of(gpu),
                 f"{path}+ml eager vs captured final state")
    t_eager = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu = Dataplane(mcfg, device="cpu", graphs=False)
    stage(cpu, n_rules, n_nodes)
    cpu.builder.set_ml_model(models[0][1])
    cpu.swap()
    for k, (op, out) in enumerate(zip(ops, outs)):
        assert_equal(apply_op(cpu, op), out,
                     f"{path}+ml CPU vs card call {k} ({op[0]})")
    assert_equal(tel_state_of(cpu), before, f"{path}+ml final state")
    csnap = cpu.telemetry_snapshot()
    assert_equal({k: np.asarray(v) for k, v in csnap.items()
                  if k != "mode"},
                 {k: np.asarray(v) for k, v in snap.items()
                  if k != "mode"}, f"{path}+ml telemetry_snapshot")
    summary = dict(
        calls=len(ops), tiers={t: v.tolist() for t, v in tiers.items()},
        sketched=alive, bins=bins.tolist(), keys_by_seq=keys_by_seq,
        eager_s=t_eager, cpu_s=time.perf_counter() - t1,
        seconds=time.perf_counter() - t0)
    say(f"ml+telemetry {path}: {len(ops)} calls captured = eager = CPU "
        f"replay, bit-exact (every StepResult field, counter, packed row "
        f"and aux row, the session/NAT/ECMP/telemetry planes and "
        f"telemetry_snapshot); scored/flagged/dropped per tier "
        f"{summary['tiers']}; {alive} sketched = alive; bins {bins.tolist()}"
        f" = the known latencies'; probe and commit=False moved nothing; "
        f"{summary['seconds']:.1f} s")
    return gpu, up, pods, launches, summary


# --- phase 4e: tenancy, the overlay, service VIPs and ECMP on the slice --


def tnt_ovl_config(cfg: DataplaneConfig) -> DataplaneConfig:
    """Phase 4d's configuration with tenancy on at the reference's
    defaults (8 tenants, 64 prefix slots), the VXLAN overlay, 64 service
    VIP rows of 8 backend ways (overlay_bench's) and 8 ECMP groups of 8
    ways (bench.py's)."""
    return ml_slice_config(cfg)._replace(
        tenancy="on", overlay="vxlan", svc_vips=64, svc_backend_ways=8,
        fib_ecmp_groups=8, fib_ecmp_ways=8)


def svc_vip(v: int) -> int:
    return ip4(f"10.96.{1 + v // 250}.{2 + v % 250}")


# tenant 4's token bucket: below its offered load at P = 4,096 (about
# 900 of its packets a vector, one vector a tick), so DROP_TENANT fires
TNT4_RATE, TNT4_BURST = 64, 256
# tenant 2's session and NAT slices (of 2^18 buckets each)
TNT2_BUCKETS = 1024


def stage_tnt_ovl(dp: Dataplane, n_rules: int, n_nodes: int, model):
    """``stage`` with the node /24s through ECMP group 0 and the service
    backends permitted, then the overlay (the VTEP, the underlay /24,
    16 remote /24s behind the 8 peer VTEPs), 48 service VIPs x 4
    backends behind a pod route, the four tenants and ``model``."""
    up, pods = stage(dp, n_rules, n_nodes, ecmp=True, svc=True)
    b = dp.builder
    dp.set_vtep(VTEP)
    b.add_route("192.168.16.0/24", up, Disposition.REMOTE)
    for x in range(16):
        b.add_route(f"10.250.{x}.0/24", up, Disposition.REMOTE,
                    next_hop=PEER_VTEPS[x % 8], node_id=2 + x)
    b.add_route(SVC_BACKEND_NET, pods[0], Disposition.LOCAL)
    for v in range(N_VIPS):
        b.set_service(svc_vip(v), 80, 6, [
            (ip4(f"10.200.{v}.10") + j, 80, 1)
            for j in range(N_SVC_BACKENDS)])
    b.set_tenant(1, prefixes=[TENANT_NETS[1]], vni=100,
                 ml_thresh=(1 << 31) - 1)
    b.set_tenant(2, prefixes=[TENANT_NETS[2]], vni=200,
                 sess_buckets=TNT2_BUCKETS, nat_buckets=TNT2_BUCKETS)
    b.set_tenant(3, prefixes=[TENANT_NETS[3]], vni=300, ml_mode="score")
    b.set_tenant(4, prefixes=[TENANT_NETS[4]], vni=400, rate=TNT4_RATE,
                 burst=TNT4_BURST)
    b.set_ml_model(model)
    dp.swap()
    return up, pods


def tnt_ovl_traffic(n: int, up: int, seed: int, n_nodes: int,
                    tenant=None):
    """A forward vector of phase 4e: ``ml_forward_traffic`` (1/8 to the
    ClusterIP VIP, 1/8 with the attack profile) with another 1/8 to the
    service VIPs (dport 80) and 1/8 to the remote pods' /24s (through
    the ECMP group; the rule blocks' ports, so the table permits them);
    ``tenant``: every source in that tenant's /16. A quarter arrives as
    VXLAN frames from the peer VTEPs: the outer header UDP to this
    node's VTEP, the inner sidecar the packet, the VNI its source
    tenant's (one in 16 an unknown VNI). Returns (outer, inner, vni)."""
    cols = ml_forward_traffic(n, up, seed)
    rng = np.random.default_rng(seed + 2)
    if tenant is not None:
        cols["src_ip"] = ((cols["src_ip"] & np.uint32(0xFFFF))
                          | np.uint32(ip4(TENANT_NETS[tenant].split("/")[0])))
    pick = rng.random(n)
    to_svc = (pick >= 0.5) & (pick < 0.625)
    to_remote = (pick >= 0.625) & (pick < 0.75)
    vip = np.array([svc_vip(v) for v in range(N_VIPS)], np.uint32)
    cols["dst_ip"] = np.where(to_svc, vip[rng.integers(0, N_VIPS, n)],
                              cols["dst_ip"]).astype(np.uint32)
    cols["dport"] = np.where(to_svc, 80, cols["dport"]).astype(np.int32)
    node = rng.integers(0, n_nodes, n)
    remote = ((10 << 24) | ((2 + node // 256) << 16) | ((node % 256) << 8)
              | rng.integers(2, 250, n)).astype(np.uint32)
    cols["dst_ip"] = np.where(to_remote, remote, cols["dst_ip"]).astype(
        np.uint32)
    framed = rng.random(n) < 0.25
    outer = {k: v.copy() for k, v in cols.items()}
    outer["src_ip"] = np.where(
        framed, np.array(PEER_VTEPS, np.uint32)[rng.integers(0, 8, n)],
        cols["src_ip"]).astype(np.uint32)
    outer["dst_ip"] = np.where(framed, np.uint32(VTEP),
                               cols["dst_ip"]).astype(np.uint32)
    outer["proto"] = np.where(framed, 17, cols["proto"]).astype(np.int32)
    outer["sport"] = np.where(framed, 49152 + rng.integers(0, 16384, n),
                              cols["sport"]).astype(np.int32)
    outer["dport"] = np.where(framed, 4789, cols["dport"]).astype(np.int32)
    outer["pkt_len"] = np.where(framed, cols["pkt_len"] + 50,
                                cols["pkt_len"]).astype(np.int32)
    tenant_of = ((cols["src_ip"] >> np.uint32(16)) & np.uint32(0xFF)
                 ).astype(np.int64) - 15
    vni = np.where(rng.random(n) < 1 / 16, UNKNOWN_VNI, 100 * tenant_of)
    vni = np.where(framed, vni, -1).astype(np.int32)
    return outer, cols, vni


def tnt_ovl_pv(dp: Dataplane, outer, inner, vni):
    """(outer PacketVector, the sidecar kwargs) on ``dp``'s device."""
    return (packet_vector_from_numpy(outer, dp.device),
            dict(ovl_inner=packet_vector_from_numpy(inner, dp.device),
                 ovl_vni=torch.from_numpy(vni).to(dp.device)))


def apply_tnt_op(dp: Dataplane, op) -> dict:
    """One recorded call of phase 4e on ``dp``; returns its snapshot."""
    if op[0] == "tenant_ml":
        dp.builder.set_tenant_ml(*op[1:])
        dp.swap()
        return {}
    _, (outer, inner, vni), now = op
    pkts, sidecar = tnt_ovl_pv(dp, outer, inner, vni)
    return snapshot(dp.process(pkts, now=now, **sidecar))


def plain_vec(cols: dict):
    """A reply vector as phase 4e's op input: no VXLAN framing."""
    n = cols["src_ip"].shape[0]
    return cols, cols, np.full(n, -1, np.int32)


def tnt_state_of(dp: Dataplane) -> dict:
    return {f: getattr(dp.tables, f).cpu().numpy()
            for f in STATE_FIELDS + tuple(TELEMETRY_FIELDS)
            + tuple(TENANCY_STATE_FIELDS)}


def tnt_snapshots(dp: Dataplane, now: int) -> dict:
    """``tenant_snapshot`` and ``fib_snapshot`` as numpy, at the
    clock ``now`` (the FIB's rung name left out: the CPU's differs)."""
    dp._now = now
    out = {}
    for k, v in dp.tenant_snapshot().items():
        if k != "tenants":
            out[f"tenant.{k}"] = np.asarray(v)
    fib = dp.fib_snapshot()
    out["fib.ecmp_c"] = fib["ecmp_c"]
    out["fib.members"] = np.array(
        [[m["pkts"], len(m["ways"])] for g in sorted(fib["ecmp_groups"])
         for m in fib["ecmp_groups"][g]], np.int64)
    out["fib.routes"] = np.array([fib["routes"]])
    return out


def outside_slices(dp: Dataplane) -> dict:
    """Every session and NAT row outside tenant 2's slices."""
    t = dp.tables
    out = {}
    for prefix, base, nbk in (("sess_", t.tnt_sess_base, t.tnt_sess_mask),
                              ("natsess_", t.tnt_nat_base, t.tnt_nat_mask)):
        lo = int(base[2])
        hi = lo + int(nbk[2]) + 1
        for f in SESSION_FIELDS:
            if f.startswith(prefix) and not f.endswith("_cursor"):
                a = getattr(t, f).cpu().numpy()
                out[f] = np.concatenate([a[:lo], a[hi:]])
    return out


def tnt_ovl_path(cfg: DataplaneConfig, path: str, n_rules: int,
                 n_nodes: int, seed: int):
    """Phase 4e on one path (module doc): three dataplanes staged alike
    (captured and eager on the card, and the CPU), the run sequence
    recorded on the captured one with the launch counters set to 0 just
    before and read just after (and per call, for the per-tier gates),
    then replayed on the others. Returns (captured dataplane, uplink,
    pods, launches, summary, the P = 256 and 4,096 vectors)."""
    t0 = time.perf_counter()
    tcfg = tnt_ovl_config(cfg)
    model = ml_models(seed)[0][1]
    made = {}
    for mode, graphs in (("captured", True), ("eager", False)):
        dp = Dataplane(tcfg, graphs=graphs)
        up, pods = stage_tnt_ovl(dp, n_rules, n_nodes, model)
        made[mode] = dp
    gpu = made["captured"]
    if (gpu._tnt_mode, gpu._overlay, gpu._ml_mode) != ("on", "vxlan",
                                                       "enforce"):
        raise AssertionError(f"{path}+tnt: gates {gpu._tnt_mode} "
                             f"{gpu._overlay} {gpu._ml_mode}")
    say(f"staged {path}+tnt: 4 tenants, {N_VIPS} service VIPs x "
        f"{N_SVC_BACKENDS}, ECMP group 0 of {len(PEER_VTEPS)} members, "
        f"{gpu.builder.fib_route_count()} routes, VTEP {ip4_str(VTEP)}, in "
        f"{time.perf_counter() - t0:.1f} s (two dataplanes)")
    seed += 5  # the traffic's
    ops, outs, deltas = [], [], []
    now = 100
    feeds = {}
    for w in WRAPPERS.values():
        w.launches = 0
    _sync(gpu.device)
    t1 = time.perf_counter()

    def run(op):
        before = {k: w.launches for k, w in WRAPPERS.items()}
        ops.append(op)
        outs.append(apply_tnt_op(gpu, op))
        deltas.append({k: w.launches - before[k]
                       for k, w in WRAPPERS.items()})
        return outs[-1]

    def round_(n, s):
        nonlocal now
        vec = tnt_ovl_traffic(n, up, seed + 7919 * s + n, n_nodes)
        first = run(("process", vec, now))
        now += 1
        for to in ("forwarded", "dropped"):
            rep = reply_traffic(first, pods, to)
            run(("process", plain_vec(rep), now))
            now += 1
            if to == "forwarded":
                feeds[n] = (vec, rep)

    for n in (VEC, BIG_VEC):
        round_(n, 0)
    # the flood: fresh flows of tenant 2 fill its slices, and nothing
    # outside them moves
    rows = outside_slices(gpu)
    occ = gpu.tenant_snapshot()["occupancy"]
    flood = run(("process", tnt_ovl_traffic(BIG_VEC, up, seed + 11,
                                            n_nodes, tenant=2), now))
    now += 1
    _sync(gpu.device)
    assert_equal(outside_slices(gpu), rows, f"{path}+tnt flood")
    occ2 = gpu.tenant_snapshot()["occupancy"]
    if int(flood["stats.tnt_qfail"]) <= 0 or not np.array_equal(
            np.delete(occ2, 2), np.delete(occ, 2)):
        raise AssertionError(f"{path}+tnt flood: {flood['stats.tnt_qfail']}"
                             f" slice failures, occupancy {occ} -> {occ2}")
    # a tenant's ML override flips: table values, nothing captured
    caps = sum(capture.capture_counts().values())
    keys = set(gpu._programs)
    run(("tenant_ml", 1, "inherit", None))
    round_(VEC, 1)
    if set(gpu._programs) != keys or sum(
            capture.capture_counts().values()) != caps:
        raise AssertionError(f"{path}+tnt: the set_tenant_ml swap built "
                             f"a program")
    _sync(gpu.device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    want = PATH_KERNELS[f"{path}+tnt"]
    say(f"main path {path}+tnt: {len(ops)} calls on the card in "
        f"{time.perf_counter() - t1:.2f} s; launches {launches}")
    if any((launches[k] > 0) != (k in want) for k in WRAPPERS):
        raise AssertionError(f"the {path}+tnt path launched {launches}, "
                             f"expected exactly {want}")
    # per call: the tenant forms on every tier, the FIB walked twice
    # (nothing launches on the CPU, where the smoke is rehearsed)
    tiers = set()
    for op, out, d in zip(ops, outs, deltas):
        if op[0] != "process":
            continue
        tier = int(out["stats.fastpath"])
        tiers.add(tier)
        if gpu.device.type == "cuda" and (
                d["sess_probe_ways"] < 1 or d["ml_score"] != 1
                or d["lpm_fused_lookup"] != 2):
            raise AssertionError(f"{path}+tnt tier {tier} call launched "
                                 f"{d}")
    if tiers != ({0, 1} if path == "mxu" else {0}):
        raise AssertionError(f"{path}+tnt ran tiers {tiers}")
    steps = [o for o, op in zip(outs, ops) if op[0] == "process"]
    fired = {f: int(sum(int(o[f"stats.{f}"]) for o in steps))
             for f in ("tnt_limited", "drop_overlay", "ovl_decap",
                       "ovl_encap", "dnat", "snat", "ml_flagged", "ml_drops",
                       "tnt_qfail")}
    causes = np.concatenate([o["drop_cause"] for o in steps])
    fired["DROP_TENANT"] = int((causes == graph.DROP_TENANT).sum())
    fired["DROP_OVERLAY"] = int((causes == graph.DROP_OVERLAY).sum())
    # DNAT'd to a service backend (10.200.0.0/16)
    fired["svc_dnat"] = int(sum(
        (o["dnat_applied"] & (o["pkts.dst_ip"].view(np.uint32)
                              >> np.uint32(16) == (10 << 8 | 200))).sum()
        for o in steps))
    ecmp = gpu.fib_snapshot()["ecmp_groups"][0]
    fired["ecmp_members"] = sum(m["pkts"] > 0 for m in ecmp)
    for f, v in fired.items():
        if v <= (1 if f == "ecmp_members" else 0):
            raise AssertionError(f"{path}+tnt: {f} = {v} ({fired})")
    # the packed forms refuse the overlay (the reference's ValueError)
    for call in (lambda: gpu.process_packed(packed_input_zeros(8)),
                 lambda: gpu.process_packed_chain(packed_input_zeros(8)[None])):
        try:
            call()
        except ValueError as e:
            if "supports only the plain step form" not in str(e):
                raise
        else:
            raise AssertionError(f"{path}+tnt: a packed form ran under "
                                 f"the overlay")
    # a probe moves no live plane
    before = tnt_state_of(gpu)
    vec = tnt_ovl_traffic(VEC, up, seed + 13, n_nodes)
    gpu.probe(packet_vector_from_numpy(vec[0], gpu.device), now=now)
    _sync(gpu.device)
    assert_equal(tnt_state_of(gpu), before, f"{path}+tnt probe")
    snaps = tnt_snapshots(gpu, now)

    # captured against eager on the card, then the CPU replay
    t1 = time.perf_counter()
    for k, (op, out) in enumerate(zip(ops, outs)):
        assert_equal(out, apply_tnt_op(made["eager"], op),
                     f"{path}+tnt eager vs captured call {k} ({op[0]})")
    assert_equal(tnt_state_of(made["eager"]), before,
                 f"{path}+tnt eager vs captured final state")
    assert_equal(tnt_snapshots(made["eager"], now), snaps,
                 f"{path}+tnt eager vs captured snapshots")
    t_eager = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu = Dataplane(tcfg, device="cpu", graphs=False)
    stage_tnt_ovl(cpu, n_rules, n_nodes, model)
    for k, (op, out) in enumerate(zip(ops, outs)):
        assert_equal(apply_tnt_op(cpu, op), out,
                     f"{path}+tnt CPU vs card call {k} ({op[0]})")
    assert_equal(tnt_state_of(cpu), before, f"{path}+tnt final state")
    assert_equal(tnt_snapshots(cpu, now), snaps, f"{path}+tnt snapshots")
    summary = dict(calls=len(ops), fired=fired,
                   launches_per_call=deltas, eager_s=t_eager,
                   cpu_s=time.perf_counter() - t1,
                   seconds=time.perf_counter() - t0)
    say(f"tenancy+overlay {path}: {len(ops)} calls captured = eager = CPU "
        f"replay, bit-exact (every StepResult field with the outer "
        f"headers, every counter, the session/NAT/ECMP/tenancy/telemetry "
        f"planes, tenant_snapshot and fib_snapshot); fired {fired}; the "
        f"flood moved nothing outside tenant 2's slices; packed forms "
        f"refused; probe moved nothing; {summary['seconds']:.1f} s")
    return gpu, up, pods, launches, summary, feeds


def four_stage_cost(ml_p: Dataplane, ml_m: Dataplane, tnt_p: Dataplane,
                    tnt_m: Dataplane, up: int, pods, n_nodes: int, seed: int,
                    now: int):
    """The cost of tenancy, the overlay, service VIPs and ECMP: each path
    with them on (phase 4e's dataplanes) against the same path with them
    off (phase 4d's: the ML stage enforcing the trained MLP and telemetry
    full on both sides), in turns (off, on, on, off, off, on), ms per
    step and device operations per step. The overlay side takes the
    framed forward vector with its sidecar, the other side its inner
    headers; the pallas cells alternate it with the replies to all of
    the overlay side's packets, the MXU full-chain cells take forward
    vectors alone, the fast-tier cells each dataplane's replies that hit
    a session. Returns ({cell: ...}, the clock after)."""
    dev = tnt_p.device
    cost = {}
    for n in (VEC, BIG_VEC):
        outer, inner, vni = tnt_ovl_traffic(n, up, seed + 977 + n, n_nodes)
        on_fwd = tnt_ovl_pv(tnt_p, outer, inner, vni)
        first = tnt_p.process(on_fwd[0], now=now, **on_fwd[1])
        now += 1
        rep = reply_traffic(snapshot(first), pods)
        cells = [("pallas", None, ml_p, tnt_p)]
        for tier, fast in (("full", 0), ("fast", 1)):
            cells.append((f"mxu {tier}", fast, ml_m, tnt_m))
        for name, fast, off_dp, on_dp in cells:
            got = {}
            for side, dp in (("off", off_dp), ("on", on_dp),
                             ("on", on_dp), ("off", off_dp),
                             ("off", off_dp), ("on", on_dp)):
                fwd = (tnt_ovl_pv(dp, outer, inner, vni) if side == "on"
                       else packet_vector_from_numpy(inner, dev))
                if fast is None:
                    vecs = [fwd, packet_vector_from_numpy(rep, dev)]
                elif not fast:
                    vecs = [fwd]
                else:  # this dataplane's replies that hit a session
                    res = _process(dp, fwd, now)
                    own = reply_traffic(snapshot(res), pods, "forwarded")
                    hit = dp.process(packet_vector_from_numpy(own, dev),
                                     now=now + 1)
                    own["flags"] = (own["flags"]
                                    & hit.established.cpu().numpy()).astype(
                                        np.int32)
                    vecs = [packet_vector_from_numpy(own, dev)]
                    now += 2
                dev_ms, _ = time_process(dp, vecs, TIMED_STEPS, now + 1,
                                         tier=fast)
                now += TIMED_STEPS + 10
                got.setdefault(side, []).append(dev_ms)
                if len(got[side]) == 1:
                    prof = profile_steps(dp, vecs * (3 - len(vecs)),
                                         PROFILED_STEPS, now, spans=False)
                    now += PROFILED_STEPS + 10
                    got[f"{side}_ops"] = prof["device_ops_per_step"]
            cell = dict(off_ms=float(np.mean(got["off"])),
                        on_ms=float(np.mean(got["on"])),
                        off_turns=got["off"], on_turns=got["on"],
                        off_ops=got["off_ops"], on_ops=got["on_ops"])
            cell["added_ms"] = cell["on_ms"] - cell["off_ms"]
            cell["added_ops"] = cell["on_ops"] - cell["off_ops"]
            cost[f"{name} P={n}"] = cell
            say(f"stage cost tenancy+overlay+svc+ecmp {name} P={n}: on "
                f"{cell['on_ms']:.4f} ms against off {cell['off_ms']:.4f} "
                f"ms per step (+{cell['added_ms']:.4f}; turns on "
                f"{[round(x, 4) for x in got['on']]}, off "
                f"{[round(x, 4) for x in got['off']]}); device ops per "
                f"step {cell['on_ops']:g} against {cell['off_ops']:g} "
                f"(+{cell['added_ops']:g})")
    return cost, now


def four_stage_layers(ml_p: Dataplane, tnt_p: Dataplane, up: int, pods,
                      n_nodes: int, seed: int, now: int):
    """Where the four stages' time goes: the pallas path's steps with
    them off (phase 4d's dataplane) and on (4e's) run eagerly (the
    ``graphs`` switch flipped for the window) under ``profile_steps``
    with every layer spanned, on a framed forward vector (the inner
    headers on the off side) alternating with the replies to all its
    packets. Returns ({"off|on P=n": profile}, the clock after)."""
    dev = tnt_p.device
    out = {}
    for n in (VEC, BIG_VEC):
        outer, inner, vni = tnt_ovl_traffic(n, up, seed + 1979 + n, n_nodes)
        on_fwd = tnt_ovl_pv(tnt_p, outer, inner, vni)
        first = tnt_p.process(on_fwd[0], now=now, **on_fwd[1])
        rep = packet_vector_from_numpy(reply_traffic(snapshot(first), pods),
                                       dev)
        now += 1
        for side, dp, fwd in (("off", ml_p, packet_vector_from_numpy(
                inner, dev)), ("on", tnt_p, on_fwd)):
            dp.graphs = False
            try:
                prof = profile_steps(dp, [fwd, rep], PROFILED_STEPS, now)
            finally:
                dp.graphs = True
            now += PROFILED_STEPS + 10
            out[f"{side} P={n}"] = prof
            say(f"profile four stages {side} eager P={n}: "
                f"{json.dumps(prof)}")
    return out, now


# --- phase 4f: incremental uploads and session snapshots on the slice ----

# phase 4f's step clock: far past any tick count of the run, so that a
# snapshot's clock (the larger of the two) is the step clock
UPS_NOW = 50_000
SNAP_CHUNK = 4096       # chunk_buckets of the slice's snapshots
MIGRATE_BUCKETS = 4096  # the migrated range (from bucket 8,192)
# the churns in order, each with the upload groups it dirties and the
# block path it must take (the reference's choice at this staging)
CHURNS = (
    ("a", "one global rule's dest_port at index 5,000", {"glb", "glb_bv"},
     {"_glb_incremental": True}),
    ("b", "the same rule objects committed again", {"glb"},
     {"_glb_incremental": True}),
    ("c", "a pod add: interface, local table, /32 route",
     {"if", "acl", "fib"}, {"_fib_incremental": 9 * 256 * 4}),
    ("d", "a route flap: del_route + add_route of one /24", {"fib"},
     {"_fib_incremental": 9 * 256 * 4}),
    ("e", "a backend roll on one service VIP", {"svc"},
     {"_svc_incremental": (5 * 8 + 2 * 8 * 8) * 4}),
    ("f", "set_tenant: tenant 4's rate", {"tenant"}, {}),
    ("g", "set_ml_model: the seeded forest", {"ml"}, {}),
    ("h", "a rule inserted at index 0 (every row shifts)",
     {"glb", "glb_bv"}, {"_glb_incremental": False}),
    ("i", "add_routes_np of 1,000 /32s over slots 2,000-2,999", {"fib"},
     {"_fib_incremental": 9 * 1024 * 4}),
)


def churn_sizes(config: DataplaneConfig) -> dict:
    """The indices and counts of the churns, scaled to the slice's
    tables (the numbers of ``CHURNS`` at the full slice): the rule of
    (a), the slots of (i), the snapshot chunk and the migrated range."""
    nb = config.sess_slots // config.sess_ways
    n = 1000 * config.fib_slots // 4096
    w = 256
    while w < n:
        w *= 4
    return dict(rule=min(5000, config.max_global_rules // 2),
                routes=n, base_slot=2000 * config.fib_slots // 4096,
                route_blob=9 * w * 4, chunk=min(SNAP_CHUNK, nb // 64),
                mig_start=nb // 32,
                mig_buckets=min(MIGRATE_BUCKETS, nb // 16))
# the churn whose swap changes the step variant (a forest replaces the
# MLP): the only one whose round may capture
NEW_VARIANT = {"g": "the ML kind moves from mlp to forest"}


def apply_churn(dp: Dataplane, name: str, up: int, seed: int) -> None:
    """Stage churn ``name`` (``CHURNS``) on ``dp``'s builder; the rule
    churns keep every unchanged rule the same object, as a renderer
    does."""
    b = dp.builder
    size = churn_sizes(dp.config)
    if name in ("a", "b", "h"):
        rules = list(b._glb_rules_ref)
        if name == "a":
            k = size["rule"]
            rules[k] = dataclasses.replace(rules[k], dest_port=9999)
        elif name == "h":
            rules = [ContivRule(
                action=Action.PERMIT, protocol=Protocol.TCP, dest_port=7777,
                src_network=ipaddress.ip_network("172.31.250.0/24"))] \
                + rules[:-4] + rules[-3:]
        b.set_global_table(rules)
    elif name == "c":
        pod = ("default", "pod-new")
        idx = dp.add_pod_interface(pod)
        dp.alloc_table_slot("pod-new-policy")
        b.set_local_table(dp.table_slots["pod-new-policy"],
                          local_rules(N_PODS, dp.config.max_rules))
        dp.assign_pod_table(pod, "pod-new-policy")
        b.add_route("10.1.1.251/32", idx, Disposition.LOCAL)
    elif name == "d":
        if not b.del_route("10.2.5.0/24"):
            raise AssertionError("churn d: no route to flap")
        # back through another next hop (the row changes)
        b.add_route("10.2.5.0/24", up, Disposition.REMOTE,
                    next_hop=ip4("192.168.15.5"), node_id=7, group=0)
    elif name == "e":
        b.set_service(svc_vip(7), 80, 6, [
            (ip4("10.200.7.10") + j, 80, 1) for j in (1, 2, 3, 5)])
    elif name == "f":
        b.set_tenant(4, prefixes=[TENANT_NETS[4]], vni=400,
                     rate=2 * TNT4_RATE, burst=TNT4_BURST)
    elif name == "g":
        b.set_ml_model(ml_models(seed)[1][1])
    elif name == "i":
        n = size["routes"]
        nets = (ip4("10.3.0.0") + 4 * np.arange(n)).astype(np.uint32)
        b.add_routes_np(nets, np.full(n, 32, np.int32), tx_if=up,
                        disp=int(Disposition.REMOTE),
                        next_hop=PEER_VTEPS[0], node_id=2,
                        base_slot=size["base_slot"])


def new_flow(outer, inner, vni, out):
    """A P = 1 vector of a new flow: the first unframed packet of a
    forward vector that was forwarded from tenant 1 (whose ML threshold
    never flags) with a source port no flow of the run uses."""
    src = inner["src_ip"]
    ok = ((out["disp"] != int(Disposition.DROP)) & (vni == -1)
          & ((src >> np.uint32(16)) == np.uint32(172 << 8 | 16)))
    i = int(np.nonzero(ok)[0][0])
    cols = {k: v[i:i + 1].copy() for k, v in inner.items()}
    cols["sport"][:] = 1023 if cols["sport"][0] != 1023 else 1022
    return cols, cols, np.full(1, -1, np.int32)


def spy_block_paths(dp: Dataplane) -> dict:
    """Record what the builder's three block-path methods return (as
    tests/test_dataplane.py spies ``_glb_incremental``)."""
    took = {}
    b = dp.builder
    for name in ("_glb_incremental", "_fib_incremental",
                 "_svc_incremental"):
        orig = getattr(type(b), name)

        def spy(builder, host_np, _orig=orig, _name=name):
            out = _orig(builder, host_np)
            took[_name] = out
            return out
        setattr(b, name, spy.__get__(b))
    return took


def timed_swap(dp: Dataplane):
    """(host wall ms, device ms between CUDA events around it) of one
    swap, the card synchronised before and after; the event span holds
    the copies and writes and the host's diff and staging between them
    (``vpp_tpu_torch.swap_pairs`` also gives the device's busy ms of
    churns (a) and (c) from ``torch.profiler``)."""
    _sync(dp.device)
    t0 = time.perf_counter()
    if dp.device.type != "cuda":
        dp.swap()
        return (time.perf_counter() - t0) * 1e3, 0.0
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    dp.swap()
    z.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, a.elapsed_time(z)


def session_arrays(dp: Dataplane) -> dict:
    """Every session field of the live tables on the host."""
    return {f: getattr(dp.tables, f).cpu().numpy().copy()
            for f in SESSION_FIELDS}


def chunk_crcs(directory: str) -> dict:
    """{table: [(file, start, crc, digest)]} of a snapshot's manifest."""
    m = json.loads((Path(directory) / snapshot_mod.MANIFEST).read_text())
    return {t: [(e["file"], e["start"], e["crc"], e["digest"])
                for e in v["chunks"]] for t, v in m["tables"].items()}


def full_build(dp: Dataplane) -> dict:
    """Every staged and derived field of ``dp``'s builder uploaded and
    derived from scratch on its device."""
    host = {f: tensor_of(a, dp.device)
            for f, a in dp.builder.host_arrays().items()}
    return {**host, **derive_tables(host)}


def upload_snapshot_path(cfg: DataplaneConfig, n_rules: int, n_nodes: int,
                         seed: int):
    """Phase 4f (module doc) on the MXU path. Returns (the launches of
    the churn rounds, the summary with every timing)."""
    t0 = time.perf_counter()
    tcfg = tnt_ovl_config(cfg)
    size = churn_sizes(tcfg)
    model = ml_models(seed)[0][1]
    gpu = Dataplane(tcfg)
    twin = Dataplane(tcfg, device="cpu", graphs=False)
    up, pods = stage_tnt_ovl(gpu, n_rules, n_nodes, model)
    stage_tnt_ovl(twin, n_rules, n_nodes, model)
    took = spy_block_paths(gpu)
    say(f"staged mxu+tnt for phase 4f: card and CPU twin in "
        f"{time.perf_counter() - t0:.1f} s")
    now = UPS_NOW
    last_fwd = {}

    def round_(s):
        """The three vectors of ``drive`` at P = 256 on the card, then
        on the twin: every result equal."""
        nonlocal now
        vec = tnt_ovl_traffic(VEC, up, seed + 7919 * s, n_nodes)
        first = apply_tnt_op(gpu, ("process", vec, now))
        assert_equal(first, apply_tnt_op(twin, ("process", vec, now)),
                     f"4f round {s}: forward vector, card vs CPU")
        last_fwd.update(vec=vec, out=first)
        now += 1
        for to in ("forwarded", "dropped"):
            rep = plain_vec(reply_traffic(first, pods, to))
            out = apply_tnt_op(gpu, ("process", rep, now))
            assert_equal(out, apply_tnt_op(twin, ("process", rep, now)),
                         f"4f round {s}: {to} replies, card vs CPU")
            if to == "forwarded":
                last_fwd["rep"] = rep
                if int(out["stats.fastpath"]) != 1:
                    raise AssertionError(f"4f round {s}: forwarded "
                                         f"replies left the fast tier")
            now += 1

    round_(0)
    for w in WRAPPERS.values():
        w.launches = 0
    _sync(gpu.device)
    churns = {}
    for k, (name, what, dirty, path) in enumerate(CHURNS, start=1):
        held = {f: getattr(gpu.tables, f) for f in TABLE_FIELDS}
        caps = sum(capture.capture_counts().values())
        keys = set(gpu._programs)
        h2d = device_transfer_totals("h2d")
        took.clear()
        for dp in (gpu, twin):
            apply_churn(dp, name, up, seed)
        host_ms, dev_ms = timed_swap(gpu)
        rec = {g: dict(r) for g, r in gpu.builder.last_upload.items()}
        moved = {g: n - h2d.get(g, 0)
                 for g, n in device_transfer_totals("h2d").items()
                 if n - h2d.get(g, 0)}
        twin.swap()
        replaced = [f for f in TABLE_FIELDS
                    if getattr(gpu.tables, f) is not held[f]]
        if replaced:
            raise AssertionError(f"churn {name}: tensors replaced "
                                 f"{replaced}")
        clean = {g for g, r in rec.items() if r["bytes"] == 0}
        if set(moved) - dirty or not set(rec) - dirty <= clean:
            raise AssertionError(f"churn {name}: bytes moved {moved}, "
                                 f"dirty groups {sorted(dirty)}")
        if name == "i":
            path = {"_fib_incremental": size["route_blob"]}
        for m, want in path.items():
            if took.get(m, "not run") != want:
                raise AssertionError(f"churn {name}: {m} gave "
                                     f"{took.get(m, 'not run')!r}, the "
                                     f"reference's path is {want!r}")
        round_(k)
        _sync(gpu.device)
        captured = sum(capture.capture_counts().values()) - caps
        if (captured > 0 or set(gpu._programs) != keys) \
                and name not in NEW_VARIANT:
            raise AssertionError(f"churn {name}: the swap or its round "
                                 f"captured {captured} parts")
        assert_equal(tnt_state_of(twin), tnt_state_of(gpu),
                     f"churn {name}: state planes, card vs CPU")
        churns[name] = dict(
            what=what, swap_host_ms=host_ms, swap_device_ms=dev_ms,
            h2d_bytes=moved, block_paths={m: took[m] for m in took},
            fields={g: r["fields"] for g, r in rec.items() if r["fields"]},
            blob_bytes={g: r["blob_bytes"] for g, r in rec.items()
                        if "blob_bytes" in r},
            captured=captured, new_variant=NEW_VARIANT.get(name))
        say(f"churn ({name}) {what}: swap {host_ms:.3f} ms host, "
            f"{dev_ms:.3f} ms between CUDA events around it; H2D bytes "
            f"{moved}; "
            f"block paths {churns[name]['block_paths']}; captured "
            f"{captured}{' (' + NEW_VARIANT[name] + ')' if captured else ''}"
            f"; every tensor kept; round bit-exact with the CPU twin")
    _sync(gpu.device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    want = PATH_KERNELS["mxu+tnt"]
    if any((launches[k] > 0) != (k in want) for k in WRAPPERS):
        raise AssertionError(f"phase 4f launched {launches}, expected "
                             f"exactly {want}")
    say(f"main path mxu+tnt churn: launches {launches}")

    # the live tables against a fresh card dataplane staged to the same
    # final state, and against its full upload
    rest = Dataplane(tcfg)
    r_up, r_pods = stage_tnt_ovl(rest, n_rules, n_nodes, model)
    for name, *_ in CHURNS:
        apply_churn(rest, name, r_up, seed)
    rest.swap()
    full = full_build(rest)
    for f in HOST_FIELDS + DERIVED_FIELDS:
        for what, other in (("fresh dataplane", getattr(rest.tables, f)),
                            ("full upload", full[f])):
            if not torch.equal(getattr(gpu.tables, f), other):
                raise AssertionError(f"4f: {f} differs from the {what}")
    say(f"4f: every staged and derived tensor equals a fresh card "
        f"dataplane's and its full upload ({len(HOST_FIELDS)} + "
        f"{len(DERIVED_FIELDS)} fields)")

    # the snapshot: full, then one P = 1 step with a new flow, then the
    # incremental one; the CPU twin alike
    dirs = {k: tempfile.mkdtemp(prefix=f"vpp_tpu_torch_snap_{k}_")
            for k in ("card", "cpu")}
    chunk = size["chunk"]
    snaps = {side: snapshot_mod.SessionSnapshotter(
        dp, dirs[side], chunk_buckets=chunk)
        for side, dp in (("card", gpu), ("cpu", twin))}
    snap_t = {}
    crcs = []
    one = new_flow(*last_fwd["vec"], last_fwd["out"])
    touched = None
    for gen, label in ((1, "full"), (2, "incremental")):
        if gen == 2:
            before = session_arrays(gpu)
            for dp in (gpu, twin):
                apply_tnt_op(dp, ("process", one, now))
            now += 1
            after = session_arrays(gpu)
            touched = {(t, int(c)) for t, fields in
                       snapshot_mod.TABLE_COLS.items() for f in fields
                       for c in np.unique(np.nonzero(
                           before[f] != after[f])[0] // chunk)}
            if not any(t == "sess" for t, _ in touched):
                raise AssertionError("4f: the P = 1 step installed no "
                                     "session")
        for dp in (gpu, twin):
            dp._now = now
        for side in ("card", "cpu"):
            s = snaps[side]
            before = s.stats_snapshot()
            _sync(gpu.device)
            t1 = time.perf_counter()
            if s.snapshot() != gen:
                raise AssertionError(f"4f: {side} snapshot {gen} failed: "
                                     f"{s.stats_snapshot()['last_error']}")
            ms = (time.perf_counter() - t1) * 1e3
            after = s.stats_snapshot()
            if side == "card":
                snap_t[label] = dict(
                    ms=ms, lock_hold_ms=after["lock_hold_ms"],
                    chunks_written=after["chunks_written"]
                    - before["chunks_written"],
                    chunks_skipped=after["chunks_skipped"]
                    - before["chunks_skipped"],
                    bytes_written=after["bytes_written"]
                    - before["bytes_written"])
        crcs.append((chunk_crcs(dirs["card"]), chunk_crcs(dirs["cpu"])))
        if crcs[-1][0] != crcs[-1][1]:
            raise AssertionError(f"4f snapshot {gen}: card and CPU chunk "
                                 f"CRCs differ")
        say(f"snapshot {label}: {snap_t[label]['ms']:.2f} ms, "
            f"{snap_t[label]['chunks_written']} chunks "
            f"({snap_t[label]['bytes_written']} bytes) written, "
            f"{snap_t[label]['chunks_skipped']} skipped, lock held "
            f"{snap_t[label]['lock_hold_ms']:.3f} ms (host); card chunk "
            f"CRCs equal the CPU twin's")
    n_chunks = sum(len(v) for v in crcs[0][0].values())
    if snap_t["full"]["chunks_written"] != n_chunks or n_chunks != 2 * (
            tcfg.sess_slots // tcfg.sess_ways // chunk):
        raise AssertionError(f"4f: the full snapshot wrote "
                             f"{snap_t['full']['chunks_written']} of "
                             f"{n_chunks} chunks")
    if snap_t["incremental"]["chunks_written"] != len(touched):
        raise AssertionError(f"4f: one step touched the chunks "
                             f"{sorted(touched)}, the snapshot re-shipped "
                             f"{snap_t['incremental']['chunks_written']}")

    # the restore: a fresh card dataplane (``rest``, staged alike) after
    # one warm-up round, then the replies to the last forwarded packets
    snap_now = json.loads((Path(dirs["card"]) / snapshot_mod.MANIFEST)
                          .read_text())["now"]
    warm = tnt_ovl_traffic(VEC, r_up, seed + 5, n_nodes)
    first = apply_tnt_op(rest, ("process", warm, 10))
    for j, to in enumerate(("forwarded", "dropped")):
        apply_tnt_op(rest, ("process",
                            plain_vec(reply_traffic(first, r_pods, to)),
                            11 + j))
    _sync(rest.device)
    caps = sum(capture.capture_counts().values())
    keys = set(rest._programs)
    t1 = time.perf_counter()
    if not snapshot_mod.SessionSnapshotter(
            rest, dirs["card"], chunk_buckets=chunk).restore_into():
        raise AssertionError("4f: the restore refused")
    _sync(rest.device)
    restore_ms = (time.perf_counter() - t1) * 1e3
    for b in range(2):
        ref = apply_tnt_op(gpu, ("process", last_fwd["rep"],
                                 snap_now + 1 + b))
        got = apply_tnt_op(rest, ("process", last_fwd["rep"], 1 + b))
        rx = int(got["stats.rx"])
        if int(got["stats.fastpath"]) != 1 or int(
                got["stats.sess_hits"]) != rx or rx == 0:
            raise AssertionError(f"4f restore batch {b}: fast tier "
                                 f"{got['stats.fastpath']}, hits "
                                 f"{got['stats.sess_hits']} of {rx}")
        assert_equal({f: ref[f] for f in ref if f.startswith("pkts.")
                      or f in ("disp", "tx_if", "next_hop", "drop_cause")},
                     {f: got[f] for f in ref if f.startswith("pkts.")
                      or f in ("disp", "tx_if", "next_hop", "drop_cause")},
                     f"4f restore batch {b}: restored vs uninterrupted")
    _sync(rest.device)
    if sum(capture.capture_counts().values()) != caps \
            or set(rest._programs) != keys:
        raise AssertionError("4f: the restore or its replies captured")
    say(f"restore: {restore_ms:.2f} ms (read, verify, write into the "
        f"live tensors); nothing captured; the replies to the forwarded "
        f"packets ride the fast tier, every one a session hit, bit-exact "
        f"with the uninterrupted dataplane")

    # the migration: a 4,096-bucket range from the card dataplane to the
    # restored one
    _sync(gpu.device)
    t1 = time.perf_counter()
    start, n_mig = size["mig_start"], size["mig_buckets"]
    cols, now_src = snapshot_mod.drain_bucket_range(gpu, start, n_mig)
    drain_ms = (time.perf_counter() - t1) * 1e3
    rest._now = now_dst = UPS_NOW // 2
    t1 = time.perf_counter()
    adopted = snapshot_mod.adopt_bucket_range(rest, cols, start, now_src)
    adopt_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    released = snapshot_mod.release_bucket_range(gpu, start, n_mig)
    release_ms = (time.perf_counter() - t1) * 1e3
    moved_rows = session_arrays(rest)
    src_rows = session_arrays(gpu)
    sl = slice(start, start + n_mig)
    for f in snapshot_mod.TABLE_COLS["sess"]:
        want = cols[f].view(np.int32)
        if f.endswith("_time"):
            want = (want.astype(np.int64) - now_src + now_dst).astype(
                np.int32)
        if not np.array_equal(moved_rows[f][sl], want):
            raise AssertionError(f"4f migration: {f} rows differ")
    if adopted <= 0 or released != adopted or src_rows["sess_valid"][
            sl].any():
        raise AssertionError(f"4f migration: adopted {adopted}, released "
                             f"{released}")
    say(f"migration of {n_mig} buckets ({adopted} sessions): "
        f"drain {drain_ms:.2f} ms, adopt {adopt_ms:.2f} ms, release "
        f"{release_ms:.2f} ms; the moved rows equal, ages rebased")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    summary = dict(churns=churns, snapshot=snap_t, restore_ms=restore_ms,
                   migration=dict(buckets=n_mig, sessions=adopted,
                                  drain_ms=drain_ms, adopt_ms=adopt_ms,
                                  release_ms=release_ms),
                   seconds=time.perf_counter() - t0)
    say(f"phase 4f: {summary['seconds']:.1f} s")
    return launches, summary


# --- phase 4g: the IO pump and the device rings on the slice -------------

RING_SLOTS = 8        # slots per ring window (io.io_ring_slots)
PUMP_SNAP = 640       # payload bytes a frame slot keeps (pkt_len 512 + 14)
PUMP_DEADLINE = 120.0  # seconds a pump stage may take to drain
STEADY_FRAMES = 2048  # VEC-packet frames in a steady window (seconds)
STEADY_TRACE = 256    # frames in the profiled steady window (one trace)
PUMP_NOW = 200_000    # the pinned clock of phase 4g (far past 4f's)
PUMP_TEL_US = 1 << 20  # the pinned telemetry clock of phase 4g (µs)


def pump_config(cfg: DataplaneConfig) -> DataplaneConfig:
    """(i): phase 4e's configuration with the overlay off (the packed
    boundary carries no overlay sidecar)."""
    return tnt_ovl_config(cfg)._replace(overlay="off")


def ring_frames(cols: dict):
    """A vector's columns as ring frames of at most VEC packets: each a
    dict of every ring column ([VEC], the IO-only ones zero) and its
    packet count."""
    n = cols["src_ip"].shape[0]
    frames = []
    for o in range(0, n, VEC):
        k = min(VEC, n - o)
        f = {c: np.zeros(VEC, dt) for c, dt in RING_COLUMNS}
        for c, dt in RING_COLUMNS[:len(PacketVector._fields)]:
            f[c][:k] = np.ascontiguousarray(cols[c][o:o + k]).view(dt)
        frames.append((f, k))
    return frames


class PumpRecorder:
    """What the pumps of one card dataplane sent to the card, in order:
    every step's packed batch (or chain), clock and rx stamps, with the
    packet count of each frame it carries; and the swaps between them.
    The CPU twin replays it (``twin_check``). Steps come from one
    dispatch thread at a time, so the frames packed since the last step
    are that step's."""

    def __init__(self, dp: Dataplane):
        self.dp, self.calls, self._frames = dp, [], []
        orig, orig_chain = dp.process_packed, dp.process_packed_chain

        def packed(flat, now=None, commit=True, with_aux=False,
                   stamp_us=0, now_us=None):
            if commit:
                self._step([np.array(flat)], now, [stamp_us])
            return orig(flat, now=now, commit=commit, with_aux=with_aux,
                        stamp_us=stamp_us, now_us=now_us)

        def chain(flats, now=None, with_aux=False, stamps_us=None,
                  now_us=None):
            flats = np.array(flats)
            self._step(list(flats), now, list(
                np.zeros(len(flats), np.int64) if stamps_us is None
                else stamps_us))
            return orig_chain(flats, now=now, with_aux=with_aux,
                              stamps_us=stamps_us, now_us=now_us)

        dp.process_packed, dp.process_packed_chain = packed, chain

    def _step(self, flats, now, stamps) -> None:
        if now is None:  # the dataplane's clock, as _clock reads it
            now = max(self.dp._now, self.dp.clock_ticks())
        frames, self._frames = self._frames, []
        self.calls.append(("step", flats, int(now),
                           [int(x) for x in stamps], frames))

    def detach(self) -> None:
        """Stop recording the dataplane's steps (the twin has replayed
        them)."""
        del self.dp.process_packed, self.dp.process_packed_chain

    def attach(self, pump: DataplanePump) -> None:
        orig = pump._pack_group

        def pack(frames, flat, non_ip):
            self._frames.append([f.n for f in frames])
            return orig(frames, flat, non_ip)

        pump._pack_group = pack

    @contextlib.contextmanager
    def ring(self):
        """Record the ring's submits (one slot each) while in scope."""
        cls = persistent_mod.PersistentPump
        orig = cls.submit
        rec = self

        def submit(pp, flat, now, stamp_us=0, priority=False):
            if pp.dp is rec.dp:
                rec._step([np.array(flat)], now, [stamp_us])
            return orig(pp, flat, now, stamp_us, priority)

        cls.submit = submit
        try:
            yield
        finally:
            cls.submit = orig

    def swap(self, change) -> None:
        """``change(dp)`` stages a configuration change; swap it in on
        the card and record it for the twin."""
        change(self.dp)
        self.dp.swap()
        self.calls.append(("swap", change))


def twin_check(twin: Dataplane, calls, tx_frames, what: str) -> int:
    """Replay ``calls`` on the CPU twin through ``process_packed`` /
    ``process_packed_chain`` at their clocks; every frame the card's
    pump wrote to the tx ring (in order) must carry the twin's verdict:
    headers, TTL, disposition, egress interface and next hop. Returns
    the frames compared."""
    k = 0
    for call in calls:
        if call[0] == "swap":
            call[1](twin)
            twin.swap()
            continue
        _, flats, now, stamps, groups = call
        if len(flats) == 1:
            outs = [twin.process_packed(flats[0], now=now,
                                        stamp_us=stamps[0]).numpy()]
        else:
            outs = list(twin.process_packed_chain(
                np.stack(flats), now=now, stamps_us=stamps).numpy())
        for out, sizes in zip(outs, groups):
            dec = unpack_packet_result(np.array(out))
            off = 0
            for n in sizes:
                cols, got_n = tx_frames[k]
                if got_n != n:
                    raise AssertionError(f"{what}: tx frame {k} has {got_n} "
                                         f"packets, the twin's {n}")
                for c, d in (("src_ip", "src_ip"), ("dst_ip", "dst_ip"),
                             ("sport", "sport"), ("dport", "dport"),
                             ("ttl", "ttl"), ("disp", "disp"),
                             ("rx_if", "tx_if"), ("next_hop", "next_hop")):
                    a = cols[c][:n].view(np.uint32)
                    b = np.asarray(dec[d][off:off + n]).astype(
                        np.int64).astype(np.uint32)
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            f"{what}: tx frame {k} {c} differs from the "
                            f"twin's ({int(np.sum(a != b))} packets)")
                off += n
                k += 1
    if k != len(tx_frames):
        raise AssertionError(f"{what}: {len(tx_frames)} tx frames, the twin "
                             f"stepped {k}")
    return k


def exchange(rings: IORingPair, frames, out, waits=None) -> float:
    """Push ``frames`` into the rx ring, drain as many from the tx ring
    (appended to ``out``; with ``out`` None only checked: each tx frame
    must carry its rx frame's packet count and source ports, so every
    frame left once and in order); returns the wall seconds. The tx ring
    is drained as it fills, so nothing stalls. ``waits`` gets each
    frame's seconds from its push to its drain (ring to ring)."""
    t0 = time.perf_counter()
    pushed: list = []
    got = 0
    deadline = t0 + PUMP_DEADLINE
    while got < len(frames):
        while (len(pushed) < len(frames)
               and rings.rx.push(frames[len(pushed)][0],
                                 frames[len(pushed)][1])):
            pushed.append(time.perf_counter())
        f = rings.tx.peek()
        if f is None:
            if time.perf_counter() > deadline:
                raise AssertionError(f"pump: {got} of {len(frames)} frames "
                                     f"left the tx ring in "
                                     f"{PUMP_DEADLINE:.0f} s")
            time.sleep(0.0002)
            continue
        if waits is not None:
            waits.append(time.perf_counter() - pushed[got])
        if out is not None:
            out.append(({c: f.cols[c].copy() for c, _ in RING_COLUMNS},
                        f.n))
        else:
            cols, n = frames[got]
            if f.n != n or not np.array_equal(f.cols["sport"][:n],
                                              cols["sport"][:n]):
                raise AssertionError(f"pump: tx frame {got} is not rx "
                                     f"frame {got}")
        rings.tx.release()
        got += 1
    return time.perf_counter() - t0


def tx_snap(frames) -> dict:
    """The fields of the tx frames ``reply_traffic`` reads."""
    cat = {c: np.concatenate([f[c][:n] for f, n in frames])
           for c in ("src_ip", "dst_ip", "sport", "dport", "disp")}
    return {"pkts.src_ip": cat["src_ip"].view(np.int32),
            "pkts.dst_ip": cat["dst_ip"].view(np.int32),
            "pkts.sport": cat["sport"], "pkts.dport": cat["dport"],
            "disp": cat["disp"]}


def pump_rounds(pump, rings, up, pods, traffic, seed: int, sizes,
                tx: list, clock: list) -> dict:
    """The main path through a running pump: per size a forward vector
    as VEC-packet frames, then the replies to the packets it forwarded
    and to those it dropped; the clock moves one tick a vector. Returns
    the valid packets, the packets and frames offered (every lane of a
    frame counts, as the pump counts them) and the wall seconds of the
    exchanges."""
    out = dict(valid=0, offered=0, frames=0, seconds=0.0)

    def send(cols, into):
        frames = ring_frames(cols)
        out["seconds"] += exchange(rings, frames, into)
        out["valid"] += int(np.count_nonzero(cols["flags"]))
        out["offered"] += sum(k for _, k in frames)
        out["frames"] += len(frames)
        clock[0] += 1

    for n in sizes:
        fwd = traffic(n, up, seed + n)
        first = []
        send(fwd, first)
        tx += first
        for to in ("forwarded", "dropped"):
            send(reply_traffic(tx_snap(first), pods, to), tx)
    return out


def ring_health(pump, what: str) -> None:
    """No hidden fallback: the ring never died, never degraded, never
    left persistent mode, and made no host callback."""
    s = pump.stats
    if (pump.degraded_ring or pump._ring_faults or pump.mode != "persistent"
            or s["io_callbacks"] or s["batch_errors"]):
        raise AssertionError(
            f"{what}: the ring degraded or fell back (degraded "
            f"{pump.degraded_ring}, faults {pump._ring_faults}, mode "
            f"{pump.mode}, io_callbacks {s['io_callbacks']}, batch errors "
            f"{s['batch_errors']})")


def conserved(pump, offered: int, frames: int, what: str) -> None:
    """Every offered packet left the tx ring, each frame once, or is
    attributed to a loss cause (none expected here: the tx ring is
    drained as it fills). ``drops_tenant_quota`` counts verdicts, not
    losses: those packets leave in their frames with DROP_TENANT."""
    s = pump.stats
    lost = {k: s[k] for k in PUMP_DROP_KEYS
            if s[k] and k != "drops_tenant_quota"}
    if (s["pkts"] + sum(lost.values()) != offered or lost
            or s["frames"] != frames):
        raise AssertionError(f"{what}: {s['pkts']} packets and "
                             f"{s['frames']} frames out, losses {lost}, of "
                             f"{offered} packets and {frames} frames "
                             f"offered")


def steady_pool(up: int, traffic, seed: int):
    """The frames of a path's steady windows: STEADY_FRAMES +
    STEADY_TRACE ring frames of VEC packets cut from forward vectors of
    BIG_VEC packets (fresh flows, a seed a vector), and their valid
    packets."""
    frames, valid = [], []
    need = STEADY_FRAMES + STEADY_TRACE
    v = 0
    while len(frames) < need:
        cols = traffic(BIG_VEC, up, seed + v)
        frames += ring_frames(cols)
        valid += [int(np.count_nonzero(cols["flags"][o:o + VEC]))
                  for o in range(0, BIG_VEC, VEC)]
        v += 1
    return frames[:need], valid[:need]


def percentiles_us(seconds) -> dict:
    a = np.asarray(seconds) * 1e6
    return dict(p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)), n=int(a.size))


class SteadyProbe:
    """Instruments one steady window of a pump: the dispatch-to-tx
    latency of each batch the pump writes, once for each frame it
    carries (``_write``: the pump's own ``latency_us`` measure, but
    every frame of the window); and on the card CUDA events around
    every device submission — each ring window (``PersistentPump.
    _dispatch``) or dispatch step (``process_packed`` /
    ``process_packed_chain``) — and around every replay of a step
    graph (``capture.Part``), so that the device clock of this one
    unprofiled run shows how long the stream sat with nothing queued
    between two submissions (idle for certain) and how much of the span
    lay outside the step graphs (copies, flag round trips and waits:
    idle at most)."""

    def __init__(self, dp: Dataplane, pump: DataplanePump):
        self.dp, self.pump = dp, pump
        self.lat: list = []
        self.events: list = []
        self.graphs: list = []
        self._cuda = dp.device.type == "cuda"

    def _timed(self, fn, into: list):
        if not self._cuda:
            return fn

        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                return fn(*a, **k)
            finally:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                into.append((e0, e1))
        return call

    def __enter__(self):
        pump, dp = self.pump, self.dp
        orig = pump._write

        def write(batch, groups, non_ip, t0, fast=False, pri=False):
            orig(batch, groups, non_ip, t0, fast, pri)
            self.lat += [time.perf_counter() - t0] * sum(map(len, groups))

        pump._write = write
        cls = persistent_mod.PersistentPump
        self._saved = cls._dispatch, capture.Part.__call__
        cls._dispatch = self._timed(cls._dispatch, self.events)
        capture.Part.__call__ = self._timed(capture.Part.__call__,
                                            self.graphs)
        dp.process_packed = self._timed(dp.process_packed, self.events)
        dp.process_packed_chain = self._timed(dp.process_packed_chain,
                                              self.events)
        return self

    def __exit__(self, *exc):
        persistent_mod.PersistentPump._dispatch, capture.Part.__call__ = \
            self._saved
        del self.dp.process_packed, self.dp.process_packed_chain
        del self.pump._write
        return False

    def gaps(self):
        """(span ms from the first submission's start to the last one's
        end, ms the stream sat empty between submissions, ms of step
        graphs), device clock; None on the CPU."""
        if not self.events:
            return None
        torch.cuda.synchronize()
        ev = self.events
        span = ev[0][0].elapsed_time(ev[-1][1])
        empty = sum(max(0.0, a[1].elapsed_time(b[0]))
                    for a, b in zip(ev, ev[1:]))
        graphs = sum(a.elapsed_time(b) for a, b in self.graphs)
        return span, empty, graphs


def trace_window(dp: Dataplane, pump, rings, frames) -> dict | None:
    """``frames`` through the running pump under ``torch.profiler``
    (device activity only): from that one trace, the device's busy ms
    (the union of its kernels and copies), the span from its first
    device activity to its last, and the host syncs; on the CPU the
    frames go through unprofiled and the result is None."""
    if dp.device.type != "cuda":
        exchange(rings, frames, None)
        return None
    from torch.profiler import ProfilerActivity, profile

    w0 = pump.stats["ring_windows"]
    b0 = pump.stats["batches"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs = exchange(rings, frames, None)
    evs = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in evs if e.device_type() == cuda)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = max(b for _, b in spans) - spans[0][0]
    syncs = sum(1 for e in evs if e.name() == "cudaStreamSynchronize")
    pump._ring_stats_sync()
    return dict(frames=len(frames), seconds=secs, device_ops=len(spans),
                busy_ms=busy / 1e6, span_ms=span / 1e6,
                idle_share=1.0 - busy / span, syncs=syncs,
                windows=pump.stats["ring_windows"] - w0,
                batches=pump.stats["batches"] - b0)


def pump_kw(mode: str, workers) -> dict:
    return (dict(mode="persistent", ring_slots=RING_SLOTS, ring_windows=2)
            if mode == "persistent"
            else dict(max_batch=2048, chain_k=8, fetch_workers=workers))


def pump_name(path: str, turn: int, mode: str, workers, depth: int) -> str:
    return f"{path} {mode} depth={depth}" + (
        f" workers={workers} #{turn}" if workers else "")


def pump_path(cfg: DataplaneConfig, path: str, n_rules: int, n_nodes: int,
              seed: int, modes, traffic, stage_fn, kernels, swap_change,
              rounds: int) -> dict:
    """Phase 4g on one path (module doc): a card dataplane and its CPU
    twin staged alike; on the card, for each mode, a pump over an
    in-process IORingPair drives ``rounds`` of the main path (a swap
    that changes no shape between two rounds of the persistent mode,
    which must restart the ring with no capture; persistent, then a
    ``sync_sessions``); then the twin replays what the pumps sent and
    every tx frame must carry its verdict. The dataplane's clock is
    pinned and moved by the harness, so the twin steps at the same
    clocks. The steady windows come later (``steady_path``)."""
    t0 = time.perf_counter()
    gpu = Dataplane(cfg)
    twin = Dataplane(cfg, device="cpu", graphs=False)
    up, pods = stage_fn(gpu)
    stage_fn(twin)
    clock = [PUMP_NOW]
    gpu.clock_ticks = lambda: clock[0]
    say(f"staged {path} for phase 4g: card and CPU twin in "
        f"{time.perf_counter() - t0:.1f} s; fast path "
        f"{'on' if gpu._use_fastpath else 'off'}")
    rec = PumpRecorder(gpu)
    summary = {}
    tx: list = []
    warmed = set()
    for turn, (mode, workers, depth) in enumerate(modes):
        name = pump_name(path, turn, mode, workers, depth)
        rings = IORingPair(n_slots=64, snap=PUMP_SNAP)
        pump = DataplanePump(gpu, rings, max_inflight=depth,
                             **pump_kw(mode, workers))
        rec.attach(pump)
        h2d0 = device_transfer_totals("h2d").get("ring.window", 0)
        d2h0 = device_transfer_totals().get("ring.window", 0)
        with contextlib.ExitStack() as scope:
            if mode == "persistent":
                scope.enter_context(rec.ring())
            # the first pump of a mode captures its programs; a later
            # one (the ring restarted on its held clone) captures nothing
            t1 = time.perf_counter()
            if mode not in warmed:
                pump.warm()
                warmed.add(mode)
            else:
                scope.enter_context(capture.capture_budget(0))
            warm_s = time.perf_counter() - t1
            pump.start()
            _sync(gpu.device)
            for w in WRAPPERS.values():
                w.launches = 0
            runs = []
            try:
                for r in range(rounds):
                    if r and mode == "persistent":
                        rec.swap(swap_change)
                        with capture.capture_budget(0):
                            got = pump_rounds(pump, rings, up, pods,
                                              traffic, seed + 7919 * r,
                                              (VEC, BIG_VEC), tx, clock)
                    else:
                        got = pump_rounds(pump, rings, up, pods, traffic,
                                          seed + 7919 * r, (VEC, BIG_VEC),
                                          tx, clock)
                    runs.append(got)
                if mode == "persistent":
                    if not pump.sync_sessions():
                        raise AssertionError(f"{name}: sync_sessions "
                                             f"declined")
                    ring = pump._ppump._prog.tables
                    same = [f for f in SESSION_FIELDS if torch.equal(
                        getattr(gpu.tables, f), getattr(ring, f))]
                    if (len(same) != len(SESSION_FIELDS)
                            or int(gpu.tables.sess_valid.sum()) == 0):
                        raise AssertionError(
                            f"{name}: sync_sessions landed "
                            f"{len(same)} of {len(SESSION_FIELDS)} "
                            f"session columns")
                _sync(gpu.device)
                launches = {k: w.launches for k, w in WRAPPERS.items()}
                lat = pump.latency_us()
                if mode == "persistent":
                    ring_health(pump, name)
            finally:
                stopped = pump.stop(join_timeout=PUMP_DEADLINE)
                rings.close()
        if not stopped:
            raise AssertionError(f"{name}: the pump's threads did not join")
        if mode == "persistent":
            ring_health(pump, name)
        s = dict(pump.stats)
        frames_out = s["frames"]
        conserved(pump, sum(g["offered"] for g in runs),
                  sum(g["frames"] for g in runs), name)
        missing = [k for k in kernels if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name}: {missing} never launched "
                                 f"({launches})")
        valid = sum(g["valid"] for g in runs)
        secs = sum(g["seconds"] for g in runs)
        row = dict(mpps=valid / secs / 1e6, valid=valid, seconds=secs,
                   frames=frames_out, batches=s["batches"],
                   latency_us=lat, launches=launches, warm_s=warm_s)
        if mode == "persistent":
            windows = s["ring_windows"]
            h2d = device_transfer_totals("h2d").get("ring.window", 0) - h2d0
            d2h = device_transfer_totals().get("ring.window", 0) - d2h0
            row.update(
                windows=windows, fill=s["ring_frames"] / windows,
                h2d_per_window=h2d / windows, d2h_per_window=d2h / windows,
                stager_ms_per_window=1e3 * s["t_stage"] / windows,
                host_reads_per_window=s["host_reads"] / windows)
        summary[name] = row
        say(f"pump {name} rounds: {row['mpps']:.4f} Mpps ({valid} valid "
            f"packets in {secs:.3f} s of exchanges), {frames_out} frames "
            f"in {s['batches']} batches, batch latency p50 "
            f"{lat['p50']:.0f} us p99 {lat['p99']:.0f} us (n={lat['n']}); "
            f"launches {launches}")
        if mode == "persistent":
            say(f"pump {name} windows: {row['windows']} windows, fill "
                f"{row['fill']:.2f} of {RING_SLOTS}; H2D "
                f"{row['h2d_per_window']:.0f} B and D2H "
                f"{row['d2h_per_window']:.0f} B per window; stager "
                f"{row['stager_ms_per_window']:.3f} ms host per window; "
                f"host reads per window {row['host_reads_per_window']:.2f}"
                f" (counted at the read)")
    # the twin: every frame's verdict, then the state
    t0 = time.perf_counter()
    n = twin_check(twin, rec.calls, tx, f"{path} pumps")
    rec.detach()
    say(f"twin {path}: {n} tx frames carry the CPU twin's verdicts "
        f"({len(rec.calls)} recorded steps and swaps replayed in "
        f"{time.perf_counter() - t0:.1f} s)")
    return dict(gpu=gpu, twin=twin, up=up, pods=pods, clock=clock,
                summary=summary)


def steady_path(res: dict, path: str, modes, traffic, kernels,
                seed: int) -> None:
    """The steady windows of one path (module doc), after its twin
    checks: for each mode a new pump on the same card dataplane, which
    captures nothing (its programs were built by the rounds' pumps),
    drains STEADY_FRAMES frames pushed as fast as the rx ring takes them
    (a backlog of seconds), instrumented by ``SteadyProbe``, then
    STEADY_TRACE more under the profiler (``trace_window``). Every frame
    leaves once and in order, nothing is lost, the path's kernels launch,
    and the ring neither degrades nor falls back. Adds a ``steady`` entry
    to each mode's row of ``res["summary"]``."""
    gpu, clock = res["gpu"], res["clock"]
    t0 = time.perf_counter()
    frames, valid = steady_pool(res["up"], traffic, seed)
    window, traced = frames[:STEADY_FRAMES], frames[STEADY_FRAMES:]
    say(f"steady {path}: {len(frames)} frames of {VEC} packets built in "
        f"{time.perf_counter() - t0:.1f} s")
    for turn, (mode, workers, depth) in enumerate(modes):
        name = pump_name(path, turn, mode, workers, depth)
        rings = IORingPair(n_slots=64, snap=PUMP_SNAP)
        pump = DataplanePump(gpu, rings, max_inflight=depth,
                             **pump_kw(mode, workers))
        clock[0] += 1
        waits: list = []
        with capture.capture_budget(0):
            pump.start()
            try:
                _sync(gpu.device)
                for w in WRAPPERS.values():
                    w.launches = 0
                with SteadyProbe(gpu, pump) as probe:
                    secs = exchange(rings, window, None, waits)
                gaps = probe.gaps()
                pump._ring_stats_sync()
                s = dict(pump.stats)
                launches = {k: w.launches for k, w in WRAPPERS.items()}
                trace = trace_window(gpu, pump, rings, traced)
                if mode == "persistent":
                    ring_health(pump, name)
            finally:
                stopped = pump.stop(join_timeout=PUMP_DEADLINE)
                rings.close()
        if not stopped:
            raise AssertionError(f"{name}: the pump's threads did not join")
        if mode == "persistent":
            ring_health(pump, name)
        conserved(pump, sum(k for _, k in frames), len(frames),
                  f"{name} steady")
        missing = [k for k in kernels if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name} steady: {missing} never launched "
                                 f"({launches})")
        n_valid = sum(valid[:STEADY_FRAMES])
        st = dict(frames=len(window), valid=n_valid, seconds=secs,
                  mpps=n_valid / secs / 1e6, batches=s["batches"],
                  latency_us=percentiles_us(probe.lat),
                  ring_to_ring_us=percentiles_us(waits),
                  launches=launches, trace=trace)
        if gaps is not None:
            st.update(span_ms=gaps[0], empty_ms=gaps[1],
                      empty_share=gaps[1] / gaps[0], graph_ms=gaps[2],
                      outside_share=1.0 - gaps[2] / gaps[0])
        if mode == "persistent":
            st.update(windows=s["ring_windows"],
                      fill=s["ring_frames"] / s["ring_windows"],
                      host_reads_per_window=s["host_reads"]
                      / s["ring_windows"])
        res["summary"][name]["steady"] = st
        lat, r2r = st["latency_us"], st["ring_to_ring_us"]
        say(f"pump {name} steady: {st['mpps']:.4f} Mpps, {len(window)} "
            f"frames ({n_valid} valid packets) in {secs:.3f} s, "
            f"{s['batches']} batches"
            + (f", {st['windows']} windows, fill {st['fill']:.2f} of "
               f"{RING_SLOTS}, host reads per window "
               f"{st['host_reads_per_window']:.2f}"
               if mode == "persistent" else "")
            + f"; frame latency (dispatch to tx) p50 {lat['p50']:.0f} us "
            f"p99 {lat['p99']:.0f} us over n={lat['n']} frames, ring to "
            f"ring p50 {r2r['p50']:.0f} us p99 {r2r['p99']:.0f} us; "
            f"launches {launches}")
        if gaps is not None:
            say(f"pump {name} steady, device clock: {gaps[0]:.1f} ms from "
                f"the first submission to the last; the stream empty "
                f"{gaps[1]:.1f} ms between submissions: "
                f"{st['empty_share']:.4f} of the span (idle for "
                f"certain); step graphs {gaps[2]:.1f} ms: "
                f"{st['outside_share']:.4f} of the span outside them "
                f"(idle at most)")
        if trace is not None:
            per = trace["windows"] if mode == "persistent" else \
                trace["batches"]
            say(f"pump {name} trace: {trace['frames']} frames in "
                f"{1e3 * trace['seconds']:.1f} ms under the profiler; "
                f"device busy {trace['busy_ms']:.1f} ms of its "
                f"{trace['span_ms']:.1f} ms span: idle share "
                f"{trace['idle_share']:.4f} (one trace; {trace['device_ops']}"
                f" device ops, {trace['syncs']} host syncs in {per} "
                f"{'windows' if mode == 'persistent' else 'batches'})")


@contextlib.contextmanager
def pinned_tel_clock(us: int):
    """The telemetry clock (``tel_clock_us``: the pump's rx stamps, the
    ring's and ``process_packed``'s dispatch clock) pinned at ``us``, so
    that the CPU twin observes the same latencies."""
    saved = telemetry_mod.tel_clock_us, dataplane_mod.tel_clock_us
    telemetry_mod.tel_clock_us = dataplane_mod.tel_clock_us = lambda: us
    try:
        yield
    finally:
        telemetry_mod.tel_clock_us, dataplane_mod.tel_clock_us = saved


def ring_direct(res: dict, traffic, seed: int) -> dict:
    """(iii): ``PersistentPump`` driven directly on the card dataplane
    of (i), an explicit clock and rx stamp per frame, against its CPU
    twin taking the same frames through ``process_packed`` at the same
    clocks: every tx row, aux row, the telemetry rider and the final
    state bit-exact. The two start equal (the pumps' grafts and the
    twin's replay must agree on every plane)."""
    gpu, twin, up, pods = res["gpu"], res["twin"], res["up"], res["pods"]
    assert_equal(tables_to_numpy(gpu.tables), tables_to_numpy(twin.tables),
                 "4g (iii): the card after the pumps vs the twin")
    clock = res["clock"]
    pp = persistent_mod.PersistentPump(gpu, batch=VEC,
                                       ring_slots=RING_SLOTS).start()
    frames = 0
    try:
        for r in range(2):
            fwd = traffic(BIG_VEC, up, seed + 7919 * r)
            for step in range(3):
                cols = fwd if step == 0 else reply_traffic(
                    first, pods, ("forwarded", "dropped")[step - 1])
                flats = [packed_batch({c: v[o:o + VEC] for c, v in
                                       cols.items()})
                         for o in range(0, BIG_VEC, VEC)]
                clock[0] += 1
                stamps = [PUMP_TEL_US - 97 * (k + 1) - 3 * r
                          for k in range(len(flats))]
                for flat, st in zip(flats, stamps):
                    pp.submit(flat, now=clock[0], stamp_us=st)
                got = [pp.result_ex(timeout=PUMP_DEADLINE) for _ in flats]
                for k, (flat, st, (out, aux)) in enumerate(zip(
                        flats, stamps, got)):
                    t_out, t_aux = twin.process_packed(
                        flat, now=clock[0], with_aux=True, stamp_us=st,
                        now_us=PUMP_TEL_US)
                    if not (np.array_equal(out, t_out.numpy())
                            and np.array_equal(aux, t_aux.numpy())):
                        raise AssertionError(f"4g (iii): frame {k} of "
                                             f"round {r} step {step} "
                                             f"differs from the twin")
                frames += len(flats)
                if step == 0:
                    first = packed_snap(np.concatenate(
                        [o for o, _ in got], axis=1))
    finally:
        final = pp.stop()
    rider = pp.tel_raw()
    want = telemetry_mod.pack_tel_rider(twin.tables).numpy()
    if rider is None or not np.array_equal(rider, want):
        raise AssertionError("4g (iii): the telemetry rider differs from "
                             "the twin's")
    assert_equal(tables_to_numpy(final), tables_to_numpy(twin.tables),
                 "4g (iii): the ring's final state vs the twin")
    st = pp.stats_snapshot()
    say(f"ring direct (iii): {frames} frames at explicit clocks in "
        f"{st['ring_windows']} windows, every tx row, aux row, the "
        f"{rider.size}-word rider and the final state equal the CPU "
        f"twin's; io_callbacks {st['io_callbacks']}")
    return dict(frames=frames, windows=st["ring_windows"],
                rider_words=int(rider.size))


def io_pump_phase(cfg: DataplaneConfig, mcfg: DataplaneConfig,
                  n_rules: int, n_nodes: int, seed: int):
    """Phase 4g (module doc): (i) the MXU auto path with tenancy, ML,
    telemetry, VIPs and ECMP through the persistent pump and the
    dispatch pump (fetch workers 8 and 1 in turns), (ii) the pallas
    full chain through the persistent pump, (iii) ``PersistentPump``
    directly against the CPU twin; then each mode's steady window.
    Returns (summary, launches per cell)."""
    model = ml_models(seed)[0][1]
    # the native frame ring and codec are built (g++, first use) before
    # any pump is timed: the codec is loaded by its constructor
    t0 = time.perf_counter()
    PacketCodec()
    IORingPair(n_slots=2, snap=64).close()
    say(f"native: frame ring and codec built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels_i = PATH_KERNELS["mxu+tnt"]
    kernels_ii = PATH_KERNELS["pallas"]
    modes_i = [("persistent", None, 2 * RING_SLOTS), ("dispatch", 8, 8),
               ("dispatch", 1, 8), ("dispatch", 1, 8), ("dispatch", 8, 8)]
    modes_ii = [("persistent", None, 8), ("persistent", None, 2 * RING_SLOTS)]
    with pinned_tel_clock(PUMP_TEL_US):
        res_i = pump_path(
            pump_config(mcfg), "mxu+tnt", n_rules, n_nodes, seed + 41,
            modes_i, ml_forward_traffic,
            lambda dp: stage_tnt_ovl(dp, n_rules, n_nodes, model),
            kernels_i, lambda dp: dp.builder.set_tenant(
                4, prefixes=[TENANT_NETS[4]], vni=400,
                rate=TNT4_RATE // 2, burst=TNT4_BURST), rounds=2)
        direct = ring_direct(res_i, ml_forward_traffic, seed + 43)
        steady_path(res_i, "mxu+tnt", modes_i, ml_forward_traffic,
                    kernels_i, seed + 53)
        res_ii = pump_path(
            cfg, "pallas", n_rules, n_nodes, seed + 47, modes_ii,
            forward_traffic, lambda dp: stage(dp, n_rules, n_nodes),
            kernels_ii, None, rounds=1)
        steady_path(res_ii, "pallas", modes_ii, forward_traffic,
                    kernels_ii, seed + 59)
    summary = dict(res_i["summary"], **res_ii["summary"])
    summary["ring direct"] = direct
    disp = {k: v["steady"]["mpps"] for k, v in summary.items()
            if "dispatch" in k}
    say(f"fetch workers (mxu+tnt dispatch steady windows, in turns 8, 1, "
        f"1, 8; Mpps): {json.dumps(disp)}")
    launches = {k: v["launches"] for k, v in summary.items()
                if "launches" in v}
    return summary, launches


# --- phase 4h: Kubernetes state down to the card --------------------------

K8S_NODE = "node-a"
K8S_NODE_IP = "192.168.16.1"  # the node's address, also its SNAT address
K8S_NAMESPACES = 6
K8S_POLICY_NAMESPACES = 4     # namespaces ns0..ns3 carry the policies
K8S_PODS = 58
K8S_APPS = ("web", "api", "db", "cache", "queue")
# the destination ports of the pod-to-pod vectors (every policy port and
# two that no policy names)
K8S_PORTS = (80, 443, 8080, 5432, 6379, 9090, 9187, 8081, 5672, 22)
K8S_SERVICES = 64
K8S_NAT_MAPPINGS = 128        # 64 cluster IPs + 16 node ports need 80
K8S_EVENTS = 2                # events of each churn kind
K8S_ROUNDS = ("policy add", "policy update", "policy delete", "pod add",
              "pod delete", "namespace labels", "endpoints update",
              "service delete")
K8S_ADDED = (58, 59)          # the pods a pod-add round creates
K8S_DELETED = (5, 17)         # and the pods a pod-delete round removes
K8S_SPORT0 = 20000            # pod-to-pod source ports: 4,096 per round
K8S_REMOTE_NODES = 3744       # remote nodes' /24s behind the uplink
K8S_EXCEPTS = 28              # excepts of each web pod's widest ipBlock


def k8s_ns_labels(k: int, flipped=()) -> dict:
    """Namespace ``ns<k>``: env prod for ns0..ns2 (flipped ones swap)."""
    prod = (k < 3) != (k in flipped)
    return {"env": "prod" if prod else "dev", "team": f"t{k}"}


def k8s_pod(i: int):
    """Pod i: (PodID, labels, IP). Namespace ns<i % 6>, app by i % 5, the
    web and api pods on the front tier."""
    app = K8S_APPS[i % len(K8S_APPS)]
    labels = {"app": app, "tier": "front" if app in ("web", "api")
              else "back"}
    return (PodID(f"ns{i % K8S_NAMESPACES}", f"pod{i}"), labels,
            f"10.1.1.{2 + i}")


def _peer_pods(ns_env=None, **labels):
    """A pod-selector peer; with ``ns_env`` it selects in the namespaces
    of that env, else (``ns_env`` "") in every namespace."""
    return km.PolicyPeer(
        pods=km.LabelSelector(match_labels=dict(labels)),
        namespaces=(None if ns_env is None else km.LabelSelector(
            match_labels={"env": ns_env} if ns_env else {})))


def _peer_block(cidr: str, excepts) -> km.PolicyPeer:
    return km.PolicyPeer(ip_block=km.IPBlock(cidr=cidr,
                                             except_cidrs=list(excepts)))


def _policy(ns: str, name: str, app: str, peers, ports) -> km.Policy:
    return km.Policy(
        name=name, namespace=ns,
        pods=km.LabelSelector(match_labels={"app": app}),
        policy_type=km.POLICY_INGRESS,
        ingress_rules=[km.PolicyRule(
            ports=[km.PolicyPort(protocol="TCP", port=p) for p in ports],
            peers=list(peers))])


def k8s_policies() -> list:
    """The node's NetworkPolicies, 12 in each of ns0..ns3: ingress to the
    web, api, db and cache pods from pod selectors (every namespace, or
    the prod ones) and from ipBlocks with excepts (the uplink's sources,
    which grow the global table)."""
    out = []
    for k in range(K8S_POLICY_NAMESPACES):
        ns = f"ns{k}"
        ext = [f"172.{16 + (3 * k + j) % 16}.{(37 * j + 11 * k) % 256}.0/24"
               for j in range(K8S_EXCEPTS)]
        cdn = [f"100.{64 + (5 * k + 7 * j) % 64}.{16 * j}.0/20"
               for j in range(6)]
        out += [
            _policy(ns, "web-ext", "web",
                    [_peer_block("172.16.0.0/12", ext)], (80, 443)),
            _policy(ns, "web-cdn", "web",
                    [_peer_block("100.64.0.0/10", cdn)], (443,)),
            _policy(ns, "web-front", "web",
                    [_peer_pods("prod", tier="front")], (80,)),
            _policy(ns, "web-health", "web",
                    [_peer_block("198.18.0.0/15", [f"198.18.{k}.0/24",
                                                   f"198.19.{k + 10}.0/24"])],
                    (8081,)),
            _policy(ns, "api-web", "api", [_peer_pods("prod", app="web")],
                    (8080,)),
            _policy(ns, "api-ext", "api",
                    [_peer_block("10.128.0.0/9",
                                 [f"10.{130 + 9 * j + k}.0.0/16"
                                  for j in range(6)])], (8080,)),
            _policy(ns, "api-monitor", "api", [_peer_pods("", app="queue")],
                    (9090,)),
            _policy(ns, "db-api", "db", [_peer_pods("prod", app="api")],
                    (5432,)),
            _policy(ns, "db-backup", "db",
                    [_peer_block("192.168.0.0/16",
                                 ["192.168.16.0/24",
                                  f"192.168.{100 + k}.0/24",
                                  f"192.168.{200 + k}.0/26"])], (5432,)),
            _policy(ns, "db-monitor", "db", [_peer_pods("", app="queue")],
                    (9187,)),
            _policy(ns, "cache-api", "cache", [_peer_pods("", app="api")],
                    (6379,)),
            _policy(ns, "cache-web", "cache",
                    [_peer_pods("prod", app="web")], (6379,)),
        ]
    return out


def k8s_service(s: int) -> km.Service:
    """Service s: a ClusterIP in ns<s % 6>; every 4th also a NodePort,
    every 8th with ``externalTrafficPolicy: Local``."""
    return km.Service(
        name=f"svc{s}", namespace=f"ns{s % K8S_NAMESPACES}",
        cluster_ip=f"10.96.{s // 200}.{10 + s % 200}",
        service_type="NodePort" if s % 4 == 3 else "ClusterIP",
        external_traffic_policy="Local" if s % 8 == 7 else "Cluster",
        ports=[km.ServicePort(name="http", protocol="TCP", port=80,
                              target_port="http",
                              node_port=30000 + s if s % 4 == 3 else 0)])


def k8s_endpoints(s: int, gen: int = 0) -> km.Endpoints:
    """Service s's 2-8 endpoints on port 8080: even ones local pods, odd
    ones on remote nodes (``gen`` moves them: an endpoints update)."""
    addrs = []
    for j in range(2 + s % 7):
        if j % 2 == 0:
            _pid, _l, ip = k8s_pod((7 * s + 5 * j + 3 * gen) % K8S_PODS)
            addrs.append(km.EndpointAddress(ip=ip, node_name=K8S_NODE))
        else:
            addrs.append(km.EndpointAddress(
                ip=f"10.2.{(s + j + gen) % 200}.{10 + j}", node_name="node-b"))
    return km.Endpoints(
        name=f"svc{s}", namespace=f"ns{s % K8S_NAMESPACES}",
        subsets=[km.EndpointSubset(
            addresses=addrs,
            ports=[km.EndpointPort(name="http", port=8080,
                                   protocol="TCP")])])


def k8s_allowed(policies, pods, labels, src, dst, port, ns_labels=None,
                src_ip=None):
    """The ingress NetworkPolicy oracle of
    tests/test_policy_differential.py ``k8s_allowed`` (copied: the smoke
    imports no test), with the namespace semantics this cluster needs: a
    policy applies to the pods of its namespace; a pod-selector peer
    selects in the policy's namespace, or with a namespace selector in
    the namespaces it matches; an ipBlock peer matches the source
    address inside its CIDR and outside its excepts. ``src`` None: the
    source is no pod (the uplink's), so only ipBlock peers can match."""
    ns_labels = ns_labels or {}

    def peer_ok(peer, pol):
        if peer.ip_block is not None and peer.ip_block.cidr:
            addr = ipaddress.ip_address(src_ip)
            if addr in ipaddress.ip_network(peer.ip_block.cidr) and not any(
                    addr in ipaddress.ip_network(e)
                    for e in peer.ip_block.except_cidrs):
                return True
        if src is None:
            return False  # a source outside the pods: only ipBlocks
        if peer.namespaces is not None:
            if not peer.namespaces.matches(ns_labels.get(src.namespace, {})):
                return False
            return peer.pods is None or peer.pods.matches(labels[src])
        return (peer.pods is not None and src.namespace == pol.namespace
                and peer.pods.matches(labels[src]))

    applying = [
        p for p in policies
        if p.namespace == dst.namespace and p.pods.matches(labels[dst])
        and p.applies_ingress()
    ]
    if not applying:
        return True  # not isolated
    for pol in applying:
        for rule in pol.ingress_rules:
            port_ok = (not rule.ports) or any(
                pp.port == port for pp in rule.ports
            )
            ok = (not rule.peers) or any(peer_ok(peer, pol)
                                         for peer in rule.peers)
            if port_ok and ok:
                return True
    return False


class K8sWorld:
    """The cluster's Kubernetes state as the KSR would reflect it, and
    the node agents' control planes that consume it: every event goes to
    each plane (``planes``) in turn, the first plane's inside a root
    span, as the KSR reflector would open one."""

    def __init__(self, planes):
        self.planes = planes
        self.flipped = set()
        self.pods = {}
        for i in range(K8S_PODS):
            pid, labels, ip = k8s_pod(i)
            self.pods[pid] = (labels, ip)
        self.policies = {(p.namespace, p.name): p for p in k8s_policies()}
        self.services = {s: k8s_service(s) for s in range(K8S_SERVICES)}
        self.eps = {s: k8s_endpoints(s) for s in range(K8S_SERVICES)}
        # (kind, root span, the spans of its trace) of the first plane's
        # events
        self.events = []

    def namespaces(self):
        return [km.Namespace(name=f"ns{k}",
                             labels=k8s_ns_labels(k, self.flipped))
                for k in range(K8S_NAMESPACES)]

    def pod_objects(self):
        return [km.Pod(name=pid.name, namespace=pid.namespace, labels=lab,
                       ip_address=ip, host_ip_address=K8S_NODE_IP)
                for pid, (lab, ip) in self.pods.items()]

    def event(self, kind: str, fn) -> None:
        """``fn(plane)`` on every plane; the first plane's in a root
        span."""
        with spans.RECORDER.span("ksr", kind) as root:
            fn(self.planes[0])
        self.events.append((kind, root, [
            s for s in spans.RECORDER.entries()
            if s.trace_id == root.trace_id]))
        for plane in self.planes[1:]:
            fn(plane)

    def start(self) -> None:
        """The agents' start: the bootstrap (interfaces, routes), then the
        KSR resync of pods, policies and namespaces (one policy-resync
        commit) and of services and endpoints."""
        for plane in self.planes:
            plane.bootstrap(self.pods)
            plane.cache.resync(self.pod_objects(),
                               list(self.policies.values()),
                               self.namespaces())
            for sp in plane.services:
                sp.resync(list(self.services.values()),
                          list(self.eps.values()))

    def churn(self, kind: str, r: int) -> None:
        """``K8S_EVENTS`` events of one churn kind (``r``: the round)."""
        for e in range(K8S_EVENTS):
            if kind == "policy add":
                k = 4 + e % 2
                pol = _policy(f"ns{k}", f"queue-web-{e}", "queue",
                              [_peer_pods("prod", app="web")], (5672,))
                self.policies[(pol.namespace, pol.name)] = pol
                self.event(kind, lambda p, pol=pol: p.cache.update_policy(pol))
            elif kind == "policy update":
                old = self.policies[(f"ns{e}", "api-web")]
                pol = _policy(old.namespace, old.name, "api",
                              old.ingress_rules[0].peers, (8443,))
                self.policies[(pol.namespace, pol.name)] = pol
                self.event(kind, lambda p, pol=pol: p.cache.update_policy(pol))
            elif kind == "policy delete":
                key = (f"ns{e}", "db-monitor")
                del self.policies[key]
                self.event(kind, lambda p, key=key: p.cache.delete_policy(
                    *key))
            elif kind == "pod add":
                pid, labels, ip = k8s_pod(K8S_ADDED[e])
                self.pods[pid] = (labels, ip)
                pod = km.Pod(name=pid.name, namespace=pid.namespace,
                             labels=labels, ip_address=ip,
                             host_ip_address=K8S_NODE_IP)
                self.event(kind, lambda p, pid=pid, ip=ip, pod=pod: (
                    p.cni_add(pid, ip), p.cache.update_pod(pod)))
            elif kind == "pod delete":
                pid, _labels, ip = k8s_pod(K8S_DELETED[e])
                del self.pods[pid]
                self.event(kind, lambda p, pid=pid, ip=ip: (
                    p.cache.delete_pod(pid), p.cni_del(pid, ip)))
            elif kind == "namespace labels":
                k = (1, 4)[e]
                self.flipped ^= {k}
                ns = km.Namespace(name=f"ns{k}",
                                  labels=k8s_ns_labels(k, self.flipped))
                self.event(kind, lambda p, ns=ns: p.cache.update_namespace(
                    ns))
            elif kind == "endpoints update":
                s = 3 + 8 * e
                self.eps[s] = k8s_endpoints(s, gen=r)
                self.event(kind, lambda p, eps=self.eps[s]: [
                    sp.update_endpoints(eps) for sp in p.services])
            elif kind == "service delete":
                s = 60 + e
                svc = self.services.pop(s)
                self.eps.pop(s)
                self.event(kind, lambda p, svc=svc: [
                    sp.delete_service(svc.namespace, svc.name)
                    for sp in p.services])
            else:
                raise ValueError(kind)

    def resync(self) -> None:
        """A full resync of both pipelines on every plane."""
        def run(plane):
            plane.policy.resync()
            for sp in plane.services:
                sp.resync(list(self.services.values()),
                          list(self.eps.values()))
        self.event("resync", run)

    def allowed(self, src, dst, port: int) -> bool:
        labels = {pid: lab for pid, (lab, _ip) in self.pods.items()}
        ns = {f"ns{k}": k8s_ns_labels(k, self.flipped)
              for k in range(K8S_NAMESPACES)}
        return k8s_allowed(list(self.policies.values()), None, labels, src,
                           dst, port, ns, self.pods[src][1])

    def allowed_from(self, src_ip: str, dst, port: int) -> bool:
        """The oracle for a source outside the cluster's pods."""
        labels = {pid: lab for pid, (lab, _ip) in self.pods.items()}
        return k8s_allowed(list(self.policies.values()), None, labels, None,
                           dst, port, None, src_ip)


class ControlPlane:
    """One node agent's control plane over ``dps``: the policy pipeline
    (cache → processor → configurator → a ``TpuRenderer`` per
    dataplane) and a service pipeline per dataplane (processor →
    configurator); ``cni_add`` / ``cni_del`` stage a pod's interface and
    /32 as the CNI server will."""

    def __init__(self, dps):
        self.dps = dps
        self.cache = PolicyCache()
        conf = PolicyConfigurator(self.cache)
        for dp in dps:
            conf.register_renderer(TpuRenderer(dp))
        self.policy = PolicyProcessor(self.cache, conf)
        self.services = [ServiceProcessor(ServiceConfigurator(
            dp, node_ips=[K8S_NODE_IP]), node_name=K8S_NODE) for dp in dps]

    def bootstrap(self, pods) -> None:
        """Each dataplane's node configuration: the uplink, the host
        interface, the pods' interfaces and /32s, the remote nodes'
        /24s, an SNAT default route and the SNAT address."""
        for dp in self.dps:
            up = dp.add_uplink()
            dp.add_host_interface()
            b = dp.builder
            for pid, (_labels, ip) in pods.items():
                b.add_route(f"{ip}/32", dp.add_pod_interface(pid),
                            Disposition.LOCAL)
            for n in range(K8S_REMOTE_NODES):
                b.add_route(f"10.{2 + n // 256}.{n % 256}.0/24", up,
                            Disposition.REMOTE,
                            next_hop=ip4("192.168.0.0") + n, node_id=n + 2)
            b.add_route("0.0.0.0/0", up, Disposition.REMOTE,
                        next_hop=ip4("192.168.255.254"), snat=True)
            b.set_snat_ip(ip4(K8S_NODE_IP))
            b.txn_label = "bootstrap"
            dp.swap()

    def cni_add(self, pid, ip: str) -> None:
        for dp in self.dps:
            dp.builder.add_route(f"{ip}/32", dp.add_pod_interface(pid),
                                 Disposition.LOCAL)
            dp.builder.txn_label = "cni-add"
            dp.swap()

    def cni_del(self, pid, ip: str) -> None:
        for dp in self.dps:
            dp.del_pod_interface(pid)
            dp.builder.del_route(f"{ip}/32")
            dp.builder.txn_label = "cni-del"
            dp.swap()



def k8s_uplink_traffic(rng, n: int, up: int, world: K8sWorld):
    """Uplink ingress: a quarter to service cluster IPs (port 80), a
    quarter to the node's node ports, half straight to pod addresses on
    the policy ports; sources from the policies' ipBlocks (their excepts
    included) and from outside them. Returns the columns and each
    packet's destination pod (None for a cluster IP or a node port)."""
    nets = np.array([ip4(a) for a in (
        "172.16.0.0", "172.20.0.0", "100.64.0.0", "100.100.0.0",
        "198.18.0.0", "10.128.0.0", "10.130.0.0", "192.168.0.0",
        "192.168.100.0", "203.0.113.0")], np.uint32)
    src = nets[rng.integers(0, len(nets), n)] + rng.integers(
        1, 1 << 12, n).astype(np.uint32)
    kind = rng.integers(0, 4, n)
    svcs = sorted(world.services)
    svc = np.array(svcs)[rng.integers(0, len(svcs), n)]
    vip = np.array([ip4(world.services[s].cluster_ip) for s in svc],
                   np.uint32)
    pids = list(world.pods)
    pod_ips = np.array([ip4(ip) for _l, ip in world.pods.values()],
                       np.uint32)
    to_pod = rng.integers(0, len(pod_ips), n)
    dst = np.where(kind == 0, vip, np.where(
        kind == 1, np.uint32(ip4(K8S_NODE_IP)), pod_ips[to_pod]))
    pod_port = np.array((80, 443, 8080, 5432, 8081, 22))[
        rng.integers(0, 6, n)]
    dport = np.where(kind == 0, 80, np.where(
        kind == 1, 30000 + (svc | 3), pod_port)).astype(np.int32)
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    cols = dict(src_ip=src.astype(np.uint32), dst_ip=dst.astype(np.uint32),
                proto=full(6), sport=rng.integers(1024, 65535, n).astype(
                    np.int32), dport=dport, ttl=full(64), pkt_len=full(512),
                rx_if=full(up), flags=full(FLAG_VALID))
    return cols, [pids[j] if k == 2 else None for k, j in zip(kind, to_pod)]


def k8s_pod_traffic(rng, n: int, dp: Dataplane, world: K8sWorld, r: int):
    """Pod to pod: random pairs of live pods (never a pod to itself) on
    the policy ports, each from its own interface, source ports fresh
    every round (no session from an earlier round applies). Returns the
    columns and each packet's (src, dst) pods."""
    pids = sorted(world.pods)
    a = rng.integers(0, len(pids), n)
    b = (a + rng.integers(1, len(pids), n)) % len(pids)
    ip = np.array([ip4(world.pods[p][1]) for p in pids], np.uint32)
    ifs = np.array([dp.pod_if[p] for p in pids], np.int32)
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    cols = dict(src_ip=ip[a], dst_ip=ip[b], proto=full(6),
                sport=(K8S_SPORT0 + r * n + np.arange(n)).astype(np.int32),
                dport=np.array(K8S_PORTS, np.int32)[
                    rng.integers(0, len(K8S_PORTS), n)],
                ttl=full(64), pkt_len=full(512), rx_if=ifs[a],
                flags=full(FLAG_VALID))
    return cols, [(pids[i], pids[j]) for i, j in zip(a, b)]


def k8s_replies(fwd: dict, out: np.ndarray) -> dict:
    """The replies of a packed forward vector's packets that left on an
    interface (LOCAL or REMOTE): endpoints swapped after NAT, received
    on the interface the forward packet left by; the others invalid."""
    dec = unpack_packet_result(np.array(out))
    n = dec["src_ip"].shape[0]
    keep = np.isin(dec["disp"], (int(Disposition.LOCAL),
                                 int(Disposition.REMOTE)))
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    return dict(src_ip=dec["dst_ip"].copy(), dst_ip=dec["src_ip"].copy(),
                proto=full(6), sport=dec["dport"].copy(),
                dport=dec["sport"].copy(), ttl=full(64), pkt_len=full(512),
                rx_if=np.where(keep, dec["tx_if"], 0).astype(np.int32),
                flags=np.where(keep, FLAG_VALID, 0).astype(np.int32))


def k8s_round(dps: dict, world: K8sWorld, r: int, seed: int,
              now: int) -> dict:
    """One round of checks after a churn: an uplink vector and a pod-to-
    pod vector through ``process_packed``, then the replies of each
    through ``process``, on every dataplane (``dps``: {name: dp}, the
    CPU twin under "cpu"). Every card dataplane's packed rows, aux rows,
    reply StepResults and StepStats (but the auto path's ``fastpath``
    flag) and final session / NAT state must equal the twin's, and the
    pod-to-pod verdicts and those of the uplink's packets addressed
    straight to a pod the oracle's. Returns counts for the log."""
    rng = np.random.default_rng(seed + 7919 * r)
    n = BIG_VEC
    cpu = dps["cpu"]
    up_cols, up_pods = k8s_uplink_traffic(rng, n, cpu.uplink_if, world)
    pp_cols, pairs = k8s_pod_traffic(rng, n, cpu, world, r)
    got = {}
    for name, dp in dps.items():
        res = []
        for k, cols in enumerate((up_cols, pp_cols)):
            out, aux = dp.process_packed(packed_batch(cols), now=now + k,
                                         with_aux=True)
            res.append((out.cpu().numpy().copy(), aux.cpu().numpy().copy()))
        got[name] = res
    reps = [k8s_replies(cols, got["cpu"][k][0])
            for k, cols in enumerate((up_cols, pp_cols))]
    for name, dp in dps.items():
        for k, rep in enumerate(reps):
            res = dp.process(packet_vector_from_numpy(rep, dp.device),
                             now=now + 2 + k)
            got[name].append(snapshot(res))
    twin = got["cpu"]
    for name in dps:
        if name == "cpu":
            continue
        auto = dps[name]._use_fastpath
        for k in range(2):
            (o, a), (co, ca) = got[name][k], twin[k]
            if not np.array_equal(o, co):
                raise AssertionError(f"k8s round {r} {name}: packed rows "
                                     f"of vector {k} differ from the twin")
            if not np.array_equal(a[1:] if auto else a, ca[1:] if auto
                                  else ca):
                raise AssertionError(f"k8s round {r} {name}: aux rows of "
                                     f"vector {k} differ from the twin")
        for k in (2, 3):
            mine = got[name][k]
            if auto:
                mine = {f: v for f, v in mine.items()
                        if f != "stats.fastpath"}
            assert_equal(mine, twin[k], f"k8s round {r} {name} reply {k}")
        assert_equal(state_of(dps[name]), state_of(cpu),
                     f"k8s round {r} {name} state")
    # the pod-to-pod verdicts against the NetworkPolicy oracle
    dec = unpack_packet_result(twin[1][0].copy())
    cause = dec["drop_cause"]
    allowed = dec["disp"] == int(Disposition.LOCAL)
    memo = {}
    denied = 0
    for k, (src, dst) in enumerate(pairs):
        key = (src, dst, int(pp_cols["dport"][k]))
        if key not in memo:
            memo[key] = world.allowed(*key)
        if memo[key] != bool(allowed[k]) or (
                not memo[key] and cause[k] != DROP_ACL):
            raise AssertionError(
                f"k8s round {r}: {src} -> {dst}:{key[2]} oracle "
                f"{'allow' if memo[key] else 'deny'}, dataplane disp "
                f"{int(dec['disp'][k])} cause {int(cause[k])}")
        denied += not memo[key]
    # the uplink's packets to pod addresses against the same oracle, by
    # their source addresses: the ipBlocks folded into the global table
    up_dec = unpack_packet_result(twin[0][0].copy())
    up_denied = up_held = 0
    for k, dst in enumerate(up_pods):
        if dst is None:
            continue
        src_ip = str(ipaddress.ip_address(int(up_cols["src_ip"][k])))
        want = world.allowed_from(src_ip, dst, int(up_cols["dport"][k]))
        disp, why = int(up_dec["disp"][k]), int(up_dec["drop_cause"][k])
        if want != (disp == int(Disposition.LOCAL)) or (
                not want and why != DROP_ACL):
            raise AssertionError(
                f"k8s round {r}: uplink {src_ip} -> {dst}:"
                f"{int(up_cols['dport'][k])} oracle "
                f"{'allow' if want else 'deny'}, dataplane disp {disp} "
                f"cause {why}")
        up_held += 1
        up_denied += not want
    return dict(pod_denied=denied, pod_allowed=n - denied,
                uplink_to_pods=up_held, uplink_to_pods_denied=up_denied,
                uplink_forwarded=int(np.isin(up_dec["disp"], (
                    int(Disposition.LOCAL), int(Disposition.REMOTE))).sum()),
                uplink_acl_drops=int((up_dec["drop_cause"]
                                      == DROP_ACL).sum()),
                reply_sess_hits=int(twin[2]["stats.sess_hits"])
                + int(twin[3]["stats.sess_hits"]),
                reply_nat_reversed=int(twin[2]["stats.nat_reversed"]))


def k8s_commit_times(events) -> dict:
    """Per churn kind, over its events: the ``epoch-swap`` spans (the
    first plane's dataplane) and the enclosing ``render`` spans of the
    policy or service pipeline, summed per event, median and max (ms)."""
    by_kind = {}
    for kind, root, mine in events:
        row = by_kind.setdefault(kind, {"swap": [], "render": [],
                                        "event": [], "swaps": []})
        row["swap"].append(sum(s.duration for s in mine
                               if s.stage == "swap") * 1e3)
        row["render"].append(sum(s.duration for s in mine
                                 if s.stage == "render") * 1e3)
        row["event"].append(root.duration * 1e3)
        row["swaps"].append(sum(s.stage == "swap" for s in mine))
    out = {}
    for kind, row in by_kind.items():
        out[kind] = {f"{k}_ms": {"median": float(np.median(v)),
                                 "max": float(np.max(v))}
                     for k, v in row.items() if k != "swaps"}
        out[kind]["swaps_per_event"] = row["swaps"]
    return out


def k8s_staged(dp: Dataplane) -> dict:
    """What the renderer staged on ``dp``: global rules, local tables in
    use and their rule counts, NAT mappings and backends."""
    b = dp.builder
    slots = sorted(dp.table_slots.values())
    return dict(global_rules=int(b.glb_nrules),
                local_tables=len(slots),
                local_rules=[int(b.acl_nrules[s]) for s in slots],
                nat_mappings=int((b.nat_bcnt > 0).sum()),
                nat_backends=int(b.nat_bcnt.sum()),
                routes=b.fib_route_count(), pods=len(dp.pod_if))


def k8s_phase(cfg: DataplaneConfig, mcfg: DataplaneConfig, seed: int):
    """Phase 4h (module doc). Returns (summary, launches)."""
    t_phase = time.perf_counter()
    kcfg = cfg._replace(nat_mappings=K8S_NAT_MAPPINGS)
    kmcfg = mcfg._replace(nat_mappings=K8S_NAT_MAPPINGS)
    tmp = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_k8s_")
    journal = str(Path(tmp.name) / "txn-journal.jsonl")
    gpu = Dataplane(kcfg)
    gpu.enable_journal(journal)
    mxu = Dataplane(kmcfg)
    cpu = Dataplane(kcfg, device="cpu")
    dps = {"pallas": gpu, "mxu": mxu, "cpu": cpu}
    world = K8sWorld([ControlPlane([gpu]), ControlPlane([mxu, cpu])])
    for w in WRAPPERS.values():
        w.launches = 0
    _sync(gpu.device)
    t0 = time.perf_counter()
    world.start()
    staged = k8s_staged(gpu)
    say(f"k8s staged: {len(world.pods)} pods in {K8S_NAMESPACES} "
        f"namespaces, {len(world.policies)} policies, "
        f"{len(world.services)} services in "
        f"{time.perf_counter() - t0:.1f} s: {json.dumps(staged)}")
    if staged["global_rules"] < 4096:
        say(f"k8s: the renderer's folding reached {staged['global_rules']} "
            f"global rules, below 4,096")
    for name, dp in dps.items():
        if k8s_staged(dp) != staged:
            raise AssertionError(f"k8s: {name} staged {k8s_staged(dp)}")
    snaps = {name: dp.kernel_snapshot() for name, dp in dps.items()
             if name != "cpu"}
    for name, want in (("pallas", ("pallas", "pallas", "pallas")),
                       ("mxu", ("mxu", "pallas", "pallas"))):
        s = snaps[name]
        got = (s["classifier"]["impl"], s["fib"]["impl"],
               s["session"]["impl"])
        say(f"kernel_snapshot {name}: {json.dumps(s)}")
        if got != want:
            raise AssertionError(f"k8s {name}: rungs {got}, not {want}")
    now = 60_000
    rounds = [("start", k8s_round(dps, world, 0, seed, now))]
    for r, kind in enumerate(K8S_ROUNDS, 1):
        now += 10
        world.churn(kind, r)
        rounds.append((kind, k8s_round(dps, world, r, seed, now)))
    now += 10
    world.resync()
    rounds.append(("resync", k8s_round(dps, world, len(K8S_ROUNDS) + 1,
                                       seed, now)))
    _sync(gpu.device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    churn_s = time.perf_counter() - t0
    for kind, row in rounds:
        say(f"k8s round {kind}: {json.dumps(row)}")
    say(f"k8s path: {len(rounds)} rounds of 4 vectors x {BIG_VEC} on the "
        f"pallas and mxu card dataplanes and the CPU twin in {churn_s:.1f} "
        f"s; launches {launches}")
    need = set(PATH_KERNELS["pallas"]) | set(PATH_KERNELS["mxu"])
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"k8s path launched {launches}")
    staged_end = k8s_staged(gpu)
    say(f"k8s staged after churn and resync: {json.dumps(staged_end)}")
    commits = k8s_commit_times(world.events)
    for kind, row in commits.items():
        say(f"k8s commit {kind}: {json.dumps(row)}")
    # the journal: replayed onto a fresh card dataplane, every table
    # tensor equal to the live one's, then one round of verdicts equal
    entries = TxnJournal(journal).load_entries()
    n_ops = sum(len(e["ops"]) for e in entries)
    jbytes = Path(journal).stat().st_size
    fresh = Dataplane(kcfg)
    t0 = time.perf_counter()
    replayed = TxnJournal(journal).replay(fresh.builder)
    fresh.swap()
    replay_s = time.perf_counter() - t0
    for f in HOST_FIELDS + DERIVED_FIELDS:
        if not torch.equal(getattr(fresh.tables, f),
                           getattr(gpu.tables, f)):
            raise AssertionError(f"k8s journal replay: {f} differs")
    empty = zero_sessions(kcfg)
    for dp in (gpu, fresh):
        dp.adopt_sessions(empty)
    flows = []
    for dp in (gpu, fresh):
        rng = np.random.default_rng(seed + 99)
        up_cols, _ = k8s_uplink_traffic(rng, BIG_VEC, gpu.uplink_if,
                                        world)
        pp_cols, _ = k8s_pod_traffic(rng, BIG_VEC, gpu, world,
                                     len(K8S_ROUNDS) + 2)
        flows.append([dp.process_packed(packed_batch(c), now=now + 20 + k,
                                        with_aux=True)
                      for k, c in enumerate((up_cols, pp_cols))])
    for (o, a), (fo, fa) in zip(*flows):
        if not (torch.equal(o, fo) and torch.equal(a, fa)):
            raise AssertionError("k8s journal replay: verdicts differ")
    say(f"k8s journal: {len(entries)} entries, {n_ops} ops, {jbytes} "
        f"bytes; replayed ({replayed} txns) onto a fresh card dataplane "
        f"in {replay_s:.2f} s: every table tensor and a round of "
        f"verdicts equal the live one's")
    classify = {}
    for name, dp in (("pallas", gpu), ("mxu", mxu)):
        for n in (VEC, BIG_VEC):
            classify[f"{name} P={n}"] = dp.time_classifier(batch=n, iters=20)
    say(f"k8s time_classifier ns/packet: {json.dumps(classify)}")
    tmp.cleanup()
    summary = dict(staged=staged, staged_end=staged_end, commits=commits,
                   rounds=dict(rounds), launches=launches,
                   journal=dict(entries=len(entries), ops=n_ops,
                                bytes=jbytes, replay_s=replay_s),
                   classify_ns_pkt=classify, kernel_snapshot=snaps,
                   seconds=time.perf_counter() - t_phase)
    say(f"phase 4h: {summary['seconds']:.1f} s")
    return summary, launches


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_graphs(paths) -> list:
    """Every part of the captured dataplanes ``paths`` ({path: [dp]}):
    captured exactly once, its graph's dump naming each kernel its
    capture launched, the parts of a path together every kernel of the
    path. Returns one row per part (label, P, capture ms, pool MB,
    launches per replay, kernel nodes)."""
    twice = {k: n for k, n in capture.capture_counts().items() if n != 1}
    if twice:
        raise AssertionError(f"keys captured more than once: "
                             f"{sorted(k[0] for k in twice)}")
    rows = []
    for path, dps in paths.items():
        for dp in dps:
            seen = set()
            for prog in dp.programs():
                for part in (p for p in prog.parts() if p.built):
                    if part.graph is None or part.dump is None:
                        raise AssertionError(f"{part.label} was not "
                                             f"captured and dumped")
                    text = Path(part.dump).read_text()
                    nodes = {k: text.count(sym)
                             for k, sym in KERNEL_SYMBOLS.items()}
                    launched = {NAME_OF[w]: c
                                for w, c in part.launches.items()}
                    for k in launched:
                        if not nodes[k]:
                            raise AssertionError(
                                f"{part.label}: {k} launched under "
                                f"capture but not among the graph's nodes")
                    seen |= set(launched)
                    rows.append(dict(
                        label=part.label, P=prog.shape[-1],
                        graph_nodes=sum(
                            1 for line in text.splitlines()
                            if "->" not in line
                            and re.search(r'node_\d+"\s*\[', line)),
                        capture_ms=part.capture_ms,
                        pool_mb=part.pool_bytes / 2 ** 20,
                        replays=part.replays, launches=launched,
                        kernel_nodes={k: v for k, v in nodes.items() if v}))
            if not set(PATH_KERNELS[path]) <= seen:
                raise AssertionError(f"the {path} graphs hold "
                                     f"{sorted(seen)}, not every kernel "
                                     f"of {PATH_KERNELS[path]}")
    return rows


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random kernel inputs and traffic")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # every capture keeps its graph's nodes for phase 4c's check
    dumps = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_graphs_")
    capture.debug_dump_dir = dumps.name

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    say(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    built = _cuda.build_all()
    for name in ("sess_probe", "bv_first_set", "lpm_lookup",
                 "mxu_first_match"):
        _cuda.library(name)
    say(f"build: {len(list(_cuda.CSRC.glob('*.cu')))} kernels, nvcc "
        f"{built:.2f} s, loaded in {time.perf_counter() - t0:.2f} s")

    # 3. kernels vs plain versions
    n_rules, sess_slots, n_nodes = 10240, 1 << 20, 3744
    cfg = slice_config(n_rules, sess_slots)
    errors = Errors()
    check_kernels(dev, errors, args.seed, n_rules,
                  sess_slots // cfg.sess_ways, cfg.fib_slots)

    # 4. the main path on the card, then the same on the CPU
    gpu, up, pods, inputs, gsnaps, launches = run_path(
        cfg, "pallas", n_rules, n_nodes, args.seed + 1)
    gstate = state_of(gpu)
    totals = {f: int(sum(int(s[f"stats.{f}"].sum()) for s in gsnaps))
              for f in ("rx", "tx", "drop_acl", "sess_hits", "dnat",
                        "nat_reversed", "snat", "drop_no_route")}
    totals["sess_occupancy"] = int(gsnaps[-1]["stats.sess_occupancy"])
    say(f"main path totals: {totals}")
    for f in ("tx", "drop_acl", "sess_hits", "dnat", "nat_reversed",
              "snat"):
        if totals[f] <= 0:
            raise AssertionError(f"the traffic mix never fired {f}")
    for s, (vec, _) in zip(gsnaps, inputs):
        if s["disp"].shape != vec["src_ip"].shape:
            raise AssertionError("result shape differs from its vector")
    denied = oracle_check(global_rules(n_rules), gsnaps[0], 64)
    say(f"oracle: first 64 packets' global ACL verdicts equal the rule "
        f"oracle ({denied} denied)")

    # 4b. the MXU path: classifier mxu, the two-tier dispatcher on
    mcfg = cfg._replace(classifier="mxu", fastpath=True)
    gpu_m, up_m, pods_m, m_inputs, msnaps, m_launches = run_path(
        mcfg, "mxu", n_rules, n_nodes, args.seed + 1)
    if not gpu_m._use_fastpath or (up_m, pods_m) != (up, pods):
        raise AssertionError("the MXU path did not engage the fast path")
    tiers = [int(s["stats.fastpath"]) for s in msnaps]
    if tiers != [int(k % 3 == 1) for k in range(len(msnaps))]:
        raise AssertionError(f"tiers per step {tiers}: every reply to "
                             f"forwarded packets must ride the fast "
                             f"tier, every forward step and every reply "
                             f"to dropped packets the full chain")
    for k, (g, m) in enumerate(zip(gsnaps, msnaps)):
        assert_equal(inputs[k][0], m_inputs[k][0], f"input {k}")
        assert_equal({f: v for f, v in g.items() if f != "stats.fastpath"},
                     m, f"mxu vs pallas step {k}")
    assert_equal(gstate, state_of(gpu_m), "mxu vs pallas final state")
    say(f"mxu path: tiers per step {tiers}; every result field, counter "
        f"(but stats.fastpath) and the final state equal the pallas "
        f"path's")

    # 4c. eager against captured, on each path; the graphs
    cap_p, eager_p, _ = eager_vs_captured(cfg, "pallas", n_rules, n_nodes,
                                          args.seed + 2)
    cap_m, eager_m, chain_tiers = eager_vs_captured(
        mcfg, "mxu", n_rules, n_nodes, args.seed + 2)
    if chain_tiers[0][-2:] != [1, 0]:
        raise AssertionError(f"mxu chain tiers {chain_tiers}: the replies "
                             f"to forwarded packets must ride the fast "
                             f"tier, those to dropped ones the full chain")

    # 4d. the ML stage and telemetry on the slice, on each path
    t4d = time.perf_counter()
    ml_p, _, _, ml_launches, ml_sum_p = ml_tel_path(
        cfg, "pallas", n_rules, n_nodes, args.seed)
    ml_m, _, _, ml_m_launches, ml_sum_m = ml_tel_path(
        mcfg, "mxu", n_rules, n_nodes, args.seed)
    say(f"phase 4d: {time.perf_counter() - t4d:.1f} s")

    # 4e. tenancy, the overlay, service VIPs and ECMP, on each path
    t4e = time.perf_counter()
    tnt_p, tnt_up, tnt_pods, tnt_launches, tnt_sum_p, tnt_feeds = \
        tnt_ovl_path(cfg, "pallas", n_rules, n_nodes, args.seed)
    tnt_m, _, _, tnt_m_launches, tnt_sum_m, _ = tnt_ovl_path(
        mcfg, "mxu", n_rules, n_nodes, args.seed)
    say(f"phase 4e: {time.perf_counter() - t4e:.1f} s")

    # 4f. incremental uploads into the live tensors, snapshots, restore
    # and migration, on the MXU path with every upload group populated
    ups_launches, ups_sum = upload_snapshot_path(mcfg, n_rules, n_nodes,
                                                 args.seed)

    # 4g. the IO pump and the device rings: both pump modes on the MXU
    # path with every stage on, the persistent ring on the pallas full
    # chain, PersistentPump against its CPU twin
    t4g = time.perf_counter()
    pump_sum, pump_launches = io_pump_phase(cfg, mcfg, n_rules, n_nodes,
                                            args.seed)
    say(f"phase 4g: {time.perf_counter() - t4g:.1f} s")

    # 4h. Kubernetes state down to the card: the policy and service
    # pipelines, the device renderer, the journal, on both classifiers
    k8s_sum, k8s_launches = k8s_phase(cfg, mcfg, args.seed)
    graphs = check_graphs({"pallas": [gpu, cap_p], "mxu": [gpu_m, cap_m],
                           "pallas+ml": [ml_p], "mxu+ml": [ml_m],
                           "pallas+tnt": [tnt_p], "mxu+tnt": [tnt_m]})
    say(f"graphs: {len(graphs)} parts, each key captured once; every "
        f"kernel launched under capture is a node of its graph")
    for row in graphs:
        say(f"graph {json.dumps(row)}")

    # 5. timing, captured (the phase 4 / 4b dataplanes) and eager (4c's)
    say(f"timing on {smi}")
    steps = {}
    now = 10_000
    feeds = {}
    for n in (VEC, BIG_VEC):
        for mode, dp in (("captured", gpu), ("eager", eager_p)):
            dev_ms, wall_ms, fwd, rep = time_steps(
                dp, up, pods, n, TIMED_STEPS, args.seed + n, now)
            now += TIMED_STEPS + 10
            feeds[n] = (fwd, rep)
            # valid packets per timed step (the steps alternate the two)
            valid = sum(int(np.count_nonzero(v["flags"]))
                        for v in feeds[n]) / 2
            vecs = [packet_vector_from_numpy(v, dev) for v in (fwd, rep)]
            prof = profile_steps(dp, vecs, PROFILED_STEPS, now,
                                 spans=mode == "eager")
            now += PROFILED_STEPS + 10
            steps[f"{mode} P={n}"] = dict(
                ms=dev_ms, wall_ms=wall_ms, valid=valid,
                mpps=valid / (dev_ms * 1e3), profile=prof,
                idle_share_timed=idle_share(prof, dev_ms))
            say(f"process step {mode} P={n} ({valid:g} valid): {dev_ms:.4f} "
                f"ms on the device (CUDA events), {wall_ms:.4f} ms wall "
                f"synchronised, {valid / (dev_ms * 1e3):.4f} Mpps")
            if mode == "captured":
                steps[f"{mode} P={n}"]["graphs"] = graph_times(dp, n)
                say(f"graph replay P={n}: "
                    f"{json.dumps(steps[f'{mode} P={n}']['graphs'])}")
            say(f"profile {mode} P={n}: {json.dumps(prof)}")
            if prof["host_syncs_per_step"] != 0:
                raise AssertionError(f"the {mode} full chain synchronised "
                                     f"with the host")
    mxu_steps = {}
    for n in (VEC, BIG_VEC):
        fwd = feeds[n][0]
        for mode, dp in (("captured", gpu_m), ("eager", eager_m)):
            first = dp.process(packet_vector_from_numpy(fwd, dev), now=now)
            rep = reply_traffic(snapshot(first), pods, "forwarded")
            for tier, cols, fast in (("full", fwd, 0), ("fast", rep, 1)):
                v = packet_vector_from_numpy(cols, dev)
                dev_ms, wall_ms = time_process(dp, [v], TIMED_STEPS,
                                               now + 1, tier=fast)
                now += TIMED_STEPS + 10
                prof = profile_steps(dp, [v, v], PROFILED_STEPS, now,
                                     spans=mode == "eager")
                now += PROFILED_STEPS + 10
                if prof["host_syncs_per_step"] != 1:
                    raise AssertionError(
                        f"the auto path's {mode} {tier} steps made "
                        f"{prof['host_syncs_per_step']} host syncs per "
                        f"step, not 1")
                valid = int(np.count_nonzero(cols["flags"]))
                mxu_steps[f"{mode} {tier} P={n}"] = dict(
                    ms=dev_ms, wall_ms=wall_ms, valid=valid,
                    mpps=valid / (dev_ms * 1e3), profile=prof,
                    idle_share_timed=idle_share(prof, dev_ms))
                say(f"mxu {mode} {tier} step P={n} ({valid} valid): "
                    f"{dev_ms:.4f} ms on the device (CUDA events), "
                    f"{wall_ms:.4f} ms wall synchronised, "
                    f"{valid / (dev_ms * 1e3):.4f} Mpps")
                say(f"profile mxu {mode} {tier} P={n}: {json.dumps(prof)}")
            if mode == "captured":
                mxu_steps[f"graphs P={n}"] = graph_times(dp, n)
                say(f"mxu graph replay P={n}: "
                    f"{json.dumps(mxu_steps[f'graphs P={n}'])}")

    # the ML stage's and telemetry's cost: each path with both on (the
    # phase 4d dataplanes, the trained MLP swapped back in: the bench's
    # model, whose program the run sequence captured) against the same
    # path with both off (phase 4 / 4b's), in turns, on the same vectors
    for dp in (ml_p, ml_m):
        dp.builder.set_ml_model(ml_models(args.seed)[0][1])
        dp.swap()
        if (dp._ml_mode, dp._ml_kind) != ("enforce", "mlp"):
            raise AssertionError(f"stage cost: gates {dp._ml_mode} "
                                 f"{dp._ml_kind}, not the trained MLP")
    stage_cost = {}
    for n in (VEC, BIG_VEC):
        fwd, rep = feeds[n]
        cells = [("pallas", None, gpu, ml_p, [fwd, rep])]
        for tier, fast in (("full", 0), ("fast", 1)):
            cells.append((f"mxu {tier}", fast, gpu_m, ml_m, None))
        for name, fast, off_dp, on_dp, cols in cells:
            got = {}
            for side, dp in (("off", off_dp), ("on", on_dp),
                             ("on", on_dp), ("off", off_dp),
                             ("off", off_dp), ("on", on_dp)):
                if cols is None:  # the replies to this dataplane's own
                    first = dp.process(packet_vector_from_numpy(fwd, dev),
                                       now=now)
                    vcols = [fwd] if not fast else [reply_traffic(
                        snapshot(first), pods, "forwarded")]
                else:
                    vcols = cols
                vecs = [packet_vector_from_numpy(v, dev) for v in vcols]
                dev_ms, _ = time_process(dp, vecs, TIMED_STEPS, now + 1,
                                         tier=fast)
                now += TIMED_STEPS + 10
                got.setdefault(side, []).append(dev_ms)
                if len(got[side]) == 1:
                    prof = profile_steps(dp, vecs * (3 - len(vecs)),
                                         PROFILED_STEPS, now, spans=False)
                    now += PROFILED_STEPS + 10
                    got[f"{side}_ops"] = prof["device_ops_per_step"]
            cell = dict(off_ms=float(np.mean(got["off"])),
                        on_ms=float(np.mean(got["on"])),
                        off_turns=got["off"], on_turns=got["on"],
                        off_ops=got["off_ops"], on_ops=got["on_ops"])
            cell["added_ms"] = cell["on_ms"] - cell["off_ms"]
            cell["added_ops"] = cell["on_ops"] - cell["off_ops"]
            stage_cost[f"{name} P={n}"] = cell
            say(f"stage cost {name} P={n}: ML + telemetry on "
                f"{cell['on_ms']:.4f} ms against off {cell['off_ms']:.4f} "
                f"ms per step (+{cell['added_ms']:.4f}; turns on "
                f"{[round(x, 4) for x in got['on']]}, off "
                f"{[round(x, 4) for x in got['off']]}); device ops per "
                f"step {cell['on_ops']:g} against {cell['off_ops']:g} "
                f"(+{cell['added_ops']:g})")

    tnt_cost, now = four_stage_cost(ml_p, ml_m, tnt_p, tnt_m, tnt_up,
                                    tnt_pods, n_nodes, args.seed, now)
    tnt_layers, now = four_stage_layers(ml_p, tnt_p, tnt_up, tnt_pods,
                                        n_nodes, args.seed, now)

    rows = []
    timed = {}
    for n in (VEC, BIG_VEC):
        inp = main_path_inputs(gpu, *feeds[n], now)
        fpk = packet_vector_from_numpy(feeds[n][0], dev)
        mx = (fpk.src_ip, fpk.dst_ip, fpk.proto, fpk.sport, fpk.dport,
              gpu_m.tables.glb_mxu_op)
        cases = {
            "sess_probe_ways": (
                lambda a=inp["sess"]: session.sess_probe_ways(*a),
                lambda a=inp["sess"]: session.sess_probe_reverse_plain(*a),
                sess_bound(inp["sess"])),
            "bv_first_set": (
                lambda a=inp["glb"]: acl_bv.bv_first_set(*a),
                lambda a=inp["glb"]: acl_bv.bv_search_first_set_plain(*a),
                bv_bound(inp["glb"])),
            "bv_first_set.local": (
                lambda a=inp["loc"]: acl_bv.bv_first_set(*a),
                lambda a=inp["loc"]: acl_bv.bv_search_first_set_plain(*a),
                bv_bound(inp["loc"])),
            "lpm_fused_lookup": (
                lambda a=inp["fib"]: lpm.lpm_fused_lookup(*a),
                lambda a=inp["fib"]: lpm.lpm_fused_lookup_plain(*a),
                lpm_bound(*inp["fib"])),
            "mxu_first_match": (
                lambda a=mx: acl_mxu.mxu_first_match(*a),
                lambda a=mx: acl_mxu.mxu_first_match_plain(*a),
                mxu_bound(*mx)),
        }
        for name, (kern, plain, (b_ms, b_by)) in cases.items():
            base = name.split(".")[0]
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            errors.hold(base, got, want, f"{name} main-path P={n}")
            k_ms = time_graph(kern)
            k_eager = time_eager(kern, TIMED_STEPS)
            p_ms = time_eager(plain, TIMED_STEPS)
            timed[(name, n)] = dict(ms=k_ms, call_ms=k_eager, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by)
            say(f"kernel {name} P={n}: {k_ms:.5f} ms (graph replay), "
                f"{k_eager:.5f} ms per eager call, plain {p_ms:.5f} ms, "
                f"bound {b_ms:.6f} ms ({b_by}), bit-exact")
        # the yardsticks: a bare product of the exploded bits and the
        # coefficients, bf16 and int8 (no explode, no epilogue; the port
        # never calls them)
        bits = acl_mxu.packet_bit_planes(fpk)
        coeff_t = acl_mxu.mxu_operand_rows(mx[5])[0]
        mm = time_graph(lambda a=bits, b=coeff_t.to(torch.bfloat16):
                        torch.matmul(a, b.t()))
        mm8 = time_graph(lambda a=bits.to(torch.int8), b=coeff_t:
                         torch._int_mm(a, b.t()))
        timed[("mxu_first_match", n)].update(
            matmul_ms=mm, int8_matmul_ms=mm8,
            bound_bf16_ms=mxu_bound(*mx, tc_rate=TC_BF16_FLOPS)[0])
        say(f"yardsticks [{n}, 128] x [128, {coeff_t.shape[0]}] P={n}: "
            f"torch.matmul bf16 {mm:.5f} ms, torch._int_mm int8 "
            f"{mm8:.5f} ms (graph replay)")
        timed.update(ml_kernel_times(ml_p, feeds[n][1], n, errors,
                                     args.seed))
        timed.update(tnt_kernel_times(tnt_p, tnt_feeds[n][1], n, errors,
                                      now))

    for name, meta in KERNELS.items():
        main = timed[(name, VEC)]
        on_path = launches if name in PATH_KERNELS["pallas"] else m_launches
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=on_path[name],
                   max_abs_err=errors.max[name], ms=main["ms"],
                   plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                   bound_by=main["bound_by"], library_ms=None,
                   shape=f"P={VEC}", call_ms=main["call_ms"],
                   at_4096=timed[(name, BIG_VEC)])
        row["launches_tenancy_overlay"] = {
            "pallas": tnt_launches[name], "mxu": tnt_m_launches[name]}
        row["launches_upload_snapshot"] = ups_launches[name]
        row["launches_pump"] = {cell: n[name]
                                for cell, n in pump_launches.items()}
        row["launches_control_plane"] = k8s_launches[name]
        if name == "sess_probe_ways":
            row["tenant_form"] = {f"P={n}": timed[("sess_probe_ways.tenant",
                                                   n)] for n in (VEC, BIG_VEC)}
        if name == "bv_first_set":
            row["local"] = {f"P={n}": timed[("bv_first_set.local", n)]
                            for n in (VEC, BIG_VEC)}
        if name == "mxu_first_match":
            for key in ("matmul_ms", "int8_matmul_ms", "bound_bf16_ms"):
                row[key] = main[key]
        elif name == "ml_score":
            row.update(launches=ml_launches[name],
                       launches_mxu_path=ml_m_launches[name],
                       library_ms=main["library_ms"],
                       library="torch._int_mm [P, 24] x [24, 16] (layer 1)",
                       forest={f"P={n}": timed[("ml_score.forest", n)]
                               for n in (VEC, BIG_VEC)},
                       tid_form={f"P={n}": timed[("ml_score.tid", n)]
                                 for n in (VEC, BIG_VEC)})
        else:
            row["launches_mxu_path"] = m_launches[name]
        rows.append(row)
    for summ in (tnt_sum_p, tnt_sum_m):
        summ.pop("launches_per_call")
    # the swap, snapshot, restore and migration times of phase 4f
    for name, c in ups_sum["churns"].items():
        say(f"upload ({name}) {c['what']}: swap {c['swap_host_ms']:.4f} ms "
            f"host, {c['swap_device_ms']:.4f} ms between CUDA events; H2D "
            f"bytes "
            f"{c['h2d_bytes']}; fields shipped whole {c['fields']}; "
            f"blobs {c['blob_bytes']}")
    for label, t in ups_sum["snapshot"].items():
        say(f"snapshot {label}: {t['ms']:.3f} ms, "
            f"{t['bytes_written']} bytes written, lock hold "
            f"{t['lock_hold_ms']:.4f} ms")
    mig = ups_sum["migration"]
    say(f"restore {ups_sum['restore_ms']:.3f} ms; migration of "
        f"{mig['buckets']} buckets: drain {mig['drain_ms']:.3f} ms, adopt "
        f"{mig['adopt_ms']:.3f} ms, release {mig['release_ms']:.3f} ms")
    say(json.dumps({"steps": steps, "mxu_steps": mxu_steps,
                    "stage_cost": stage_cost,
                    "tenancy_overlay_cost": tnt_cost,
                    "tenancy_overlay_layers": tnt_layers,
                    "ml_telemetry": {"pallas": ml_sum_p, "mxu": ml_sum_m},
                    "tenancy_overlay": {"pallas": tnt_sum_p,
                                        "mxu": tnt_sum_m},
                    "upload_snapshot": ups_sum,
                    "io_pump": pump_sum,
                    "control_plane": k8s_sum,
                    "captures": graphs, "power": smi}))
    if any(n != 1 for n in capture.capture_counts().values()):
        raise AssertionError("the timing captured a key again")
    capture.debug_dump_dir = None
    dumps.cleanup()
    say(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
