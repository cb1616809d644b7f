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
4i. the node agent on the card: a ``ContivAgent`` built from
   ``AgentConfig.from_dict`` at the slice's widths with the reference
   agent's default ladders (``auto``, fast path on; 128 NAT mappings,
   128 interfaces), serving HTTP (the CNI socket, the Prometheus and
   health pages, the maintenance thread), and a CPU twin agent that
   resolves the same rungs. Both clocks are pinned to one cell the
   phase moves, so the maintenance thread's expiry cuts at a known
   tick and expires nothing between rounds. Each agent's KSR reflects
   phase 4h's 6 namespaces; 110 pods (kubelet's default
   ``--max-pods``) are added through CNI (the card's through
   ``cni.shim.run`` over its socket: kubelet's exec of the shim), with
   equal addresses and interfaces on both; then their objects, the 64
   services with endpoints, 15 peer nodes published in the store and,
   last, phase 4h's first 16 NetworkPolicies (every CNI add re-renders
   every policy). After the start and after each churn (a pod add, a
   pod delete, a policy add, an endpoints update, a peer leaving by
   lease expiry) a 4,096-packet vector (half pod to pod, a quarter pod
   to a cluster IP, a quarter from the uplink) and the replies of its
   forwarded packets through each agent's ``dataplane.process``: every
   result, the state planes and the staged tables equal the twin's,
   every pod-to-pod verdict and every uplink packet's to a pod the
   NetworkPolicy oracle's, and the kernels of the resolved rungs launch.
   After a maintenance tick on each, the card's ``/stats`` page (GET
   over 127.0.0.1) equals the twin's exposition line for line but for
   ``AGENT_UNCOMPARED`` and the wall-clock histograms' buckets and sums;
   sessions are active and ``/readiness`` is ready. Then the card agent
   closes (the parting snapshot, the store file) and a new card agent
   boots on the same store file and snapshot directory with the rings
   and a dispatch pump: its CNI resync gives back the same 110 pods,
   addresses and interfaces, its session planes equal those at close
   (ages rebased), the replies to a last vector's forwarded packets all
   hit their sessions, and a vector of frames through its rings leaves
   once, in order, with the oracle's pod-to-pod verdicts and counted on
   ``vpp_tpu_pump_frames``. Printed: ``agent boot``, ``agent cni`` (the
   adds' p50 / p99 from ``vpp_tpu_cni_request_seconds`` and the shim's
   own), ``agent round <churn>`` (the commit and its epoch swaps),
   ``agent metrics`` (the scrape) and ``agent restart`` (close to
   serving warm: the snapshot write, the restore, the CNI resync);
4j. the agent's remote surfaces: phase 4i's two nodes (110 pods, 16
   policies, 64 services, 15 peers, the agent's default ladders), each
   keeping its state in a store pair of its own — a primary
   ``KVServer`` and a standby following it, each under an
   ``HaCoordinator`` fenced by a ``QuorumWitness``, on localhost; the
   agent's ``store_url`` names both (the card's through relays whose
   links can be cut) — with ``ml_stage: enforce`` and an MLP artifact
   written by ``vpp-tpu-torch-ml-train`` in its own process, the card's
   debug CLI on a socket. KSR reads a fake API server (stdlib HTTP,
   bearer token from a kubeconfig) through ``make_k8s_sources``: the
   world by list, the policies and then the churns as watch events (a
   pod add, a policy add, an endpoints update hidden by a dropped
   stream that must re-list and diff). After every step the card's
   results, state planes and staged tables equal the twin's and the
   verdicts the NetworkPolicy oracle's (phase 4i's round). A corrupt
   artifact is refused (v1 keeps serving, ``vpp_tpu_degraded{component=
   "ml"}`` 1), a v2 loads with no capture. ``vpp-tpu-torch-ctl`` runs
   ``show interface / sessions / kernels / ml / store / resilience``,
   ``trace add 8`` and ``show trace`` and two ``test connectivity``
   probes (a denied and an allowed pod pair, each the oracle's
   verdict) on the card's socket: each text equals the twin's CLI but
   for ``REMOTE_CLI_DIFFERS``. Then the card's links are cut (``show
   resilience`` reads the kvstore degraded, packets keep flowing on the
   last epoch), both primaries die, their standbys promote through the
   witnesses, the card's link to its standby heals and a policy added
   after commits on both nodes. Last, ``profile_stages`` (``show run``)
   on phase 4's dataplane at P = 256 and 4,096. Printed: ``remote
   boot``, ``remote staged`` (list and watch ms), ``remote round
   <kind>``, ``remote ml``, ``remote cli`` (round trip ms per command),
   ``remote failover`` (primary down -> standby writable -> the card's
   first commit), ``remote commits`` and the ``show run`` tables;
4k. the node's wire: (i) a card ``ContivAgent`` at phase 4i's widths
   (110 pods, 16 policies, 64 services, 15 peers; the default ladders
   with the FIB pinned to the LPM kernel rung) with its packet rings in
   shared memory, an IO plan file and the daemon's control socket, and a
   CPU twin agent with in-process rings. The IO daemon runs as its own
   process (``python -m vpp_tpu_torch.cmd.io_daemon``), started from the
   agent's plan by ``InitSupervisor`` with ``--if IDX:fd:N`` specs and the
   fds of a socketpair each for the uplink and 16 of the pods (the pods
   added through the CNI server without a netns: no kernel wiring); its
   process must map neither torch nor the CUDA driver. The twin's
   daemon is the port's ``IODaemon`` in process over socketpairs of its
   own; the wired pods' MACs are pinned on both (as the pod wirer pins
   them). Three rounds of Ethernet frames, from one ingress socket at a
   time in chunks of 128, each waited for until the daemon's counters
   account for every frame: phase 4i's 4,096-packet mix (half pod to
   pod between the wired pods, a quarter to the cluster IPs, a quarter
   from the uplink, a quarter of those VXLAN frames from the peers'
   VTEPs and pods), the replies of every frame that left, and (after a
   NetworkPolicy that leaves ns4's cache pods TCP 22 only, and after
   the daemon is killed with SIGKILL and respawned from its plan by the
   supervisor, the twin's daemon restarted alike) a fresh forward mix.
   The frames each socket received must equal the twin's as a multiset,
   byte for byte but for the Ethernet source MAC (each daemon process
   draws its transports' MACs: one per socket); every pod-to-pod frame
   must reach its destination's socket exactly when the NetworkPolicy
   oracle allows it, the deny must cut frames the old policies allowed;
   the daemon's rx count must equal the frames sent and its tx count the
   frames received; ``vpp_tpu_pump_drops_total{reason="rx_full"}`` on
   the card's ``/stats`` must read the pump's and the daemon's count;
   ``sess_probe_ways``, ``bv_first_set`` and ``lpm_fused_lookup`` must
   launch. Printed: the daemon's boot from the plan, each round's
   counts by socket, the daemon's rx / tx / drop / encap / decap counts,
   Mpps through the daemon process over the chunks, frame latency p50 /
   p99 socket to socket, and the respawn time (SIGKILL to the first
   frame through the new daemon). (ii) Where ``ip netns add`` succeeds
   (the line says ``wire kernel: ran`` or ``wire kernel: not permitted
   (<why>)``): the init supervisor boots an agent process (the store on
   a ``KVServer``, the host interconnect on) and its IO daemon process;
   8 pods added through the CNI shim get veths in named netns; UDP and
   a TCP handshake between two pods, the host pings a pod, a
   NetworkPolicy cuts one port and keeps another, a CNI DEL removes the
   veth, and ``LinuxNetlink`` steals and reverts a veth's addressing;
   printed: the CNI adds' p50 / p99 with wiring;
4l. the VCL host stack and the gateway fleet, at bench.py's widths:
   (i) a card ``ContivAgent`` with ``vcl_socket`` set (its admission
   server over the agent's session-rule engine, raised to 2,048 rules
   and packed with the 996-rule gen-policy filler and the proxy chain's
   rules, hoststack/scenarios.py), and the LD_PRELOAD shim built from
   ``native/vcl_preload.c``: a child process under the fail-closed shim
   must connect to the proxy's port and be refused the backend's; 4,096
   batched connect decisions must equal a CPU twin engine's, decision
   for decision, and 1,024 of them asked one at a time over the
   admission socket the engine's; printed: admission decisions per
   second batched and over the socket, RPS over 50 admitted connections
   and CPS in 32-wide admission waves (bench.py ``hoststack_bench``),
   and a 256 MB loopback transfer bare and under the shim (``vcl_iperf
   _bench``), every port the kernel's; (ii) ``FleetSteering`` over
   bench.py ``fleet_bench``'s instances (2^18 session slots x 4 ways,
   ``sess_hash: sym``, 64 ranges; the classifier, FIB and session on
   their fused-kernel rungs): rungs of 1, 2 and 4 instances take the
   same 64 frames of 1,024 packets; each instance's packed outputs, aux
   rows and session state must equal a CPU twin fleet's fed the same
   partitions; printed: Mpps through a ``FleetPump`` (the best of three
   interleaved passes) and steering ns a packet per rung, with a line
   saying that every instance shares the one card. Then two instances
   take a third under ``FleetPump`` load (fence, drain, adopt, commit,
   release for each moved range): conservation must be exact (offered
   = delivered + attributed drops, nothing pending) and the migrated
   flows' fast-path hit rate must reach 0.9 within 10 windows; printed:
   ranges and sessions moved, migration ms, the hit rate before and
   after, windows to recovery, submit p99. ``sess_probe_ways``,
   ``bv_first_set`` and ``lpm_fused_lookup`` must launch in (ii);
4m. the single-host mesh (parallel/): (i) a ``ClusterDataplane`` of 4
   nodes x 2 rule shards on the card, each node the slice (10,240
   global rules, 2^20 x 4 session slots and NAT the same, 3,996 routes
   in 4,096 FIB slots, 8 pods on 128-rule local tables) staged with its
   own pod /24, fabric routes to its peers and edge routes, on the
   ``auto`` rungs (the word-sharded BV classifier at 10,240 rules) and
   on ``classifier: mxu``, the fast path on: two rounds of each node's
   256-packet forward vector (a quarter to pods on the other nodes)
   and the replies to what it delivered and what it dropped, then on
   the auto rung a round whose cross-node quarter all goes to one peer
   under a fabric budget of 32 (it overflows, and the overflow is
   counted). Every ClusterStepResult field (the delivered rows,
   ``fabric_sent`` / ``fabric_overflow`` and the stats included) and the
   session / NAT / ECMP planes must equal a CPU twin cluster's;
   ``mxu_first_match`` must launch (once per rule shard, on the shard's
   operand) on the mxu rung, and checks bit-exact against its plain
   version on shard operands of 5,120 and 2,560 columns; printed: ms and
   Mpps per cluster step captured and eager at 256 and 4,096 packets a
   node (forward vectors on the full chain, replies on the fast tier),
   graph launches per captured step, a swap's ms per churn (one node's
   global table, one node's route) and the kernel's shard-operand times
   beside its bound and the bf16 ``matmul`` / ``torch._int_mm`` at that
   shape. (ii) a ``MeshRuntime`` of 2 x 2 with ``io.enabled`` on the
   card and its CPU twin: agents over one store, pods through the CNI, a
   ClusterIP whose backend is on the other node, a NetworkPolicy that
   cuts a cross-node flow; 64 frames of 256 packets written into node
   0's rings leave node 1's through the ``ClusterPump``; ``show mesh``
   and ``show partitions``; a cluster snapshot that restores on the same
   geometry and is refused on another. The steps, the session planes
   and the frames out of node 1 must equal the twin's; printed: the
   pump's Mpps and fabric-step p50 / p99;
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
from vpp_tpu_torch.cli import DebugCLI  # noqa: E402
from vpp_tpu_torch.interop import (  # noqa: E402
    cluster_result_to_numpy,
    cluster_tables_to_numpy,
    tables_to_numpy,
)
from vpp_tpu_torch.parallel import ClusterDataplane, cluster_mesh  # noqa: E402
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
from vpp_tpu_torch.agent.node_id import NodeIDAllocator  # noqa: E402
from vpp_tpu_torch.cmd import AgentConfig, ContivAgent  # noqa: E402
from vpp_tpu_torch.cmd.ksr_main import KsrAgent  # noqa: E402
from vpp_tpu_torch.cni import shim as cni_shim  # noqa: E402
from vpp_tpu_torch.cni.model import CNIRequest  # noqa: E402
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


def global_rules(n: int, svc: bool = False, pod_net: str = "10.1.1.0/24"):
    """The gen-policy.py shape (bench.py ``build_rules``): /24 CIDR
    blocks x ports with every 6th rule a deny, then a permit of the
    service backends' port on ``pod_net`` (with ``svc`` also of the
    service-VIP backends', as overlay_bench permits its VIP traffic) and
    the terminal deny-all; ``n`` rules."""
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
        dest_network=ipaddress.ip_network(pod_net)))
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


# the operand planes that carry work: the 104 header bit-planes and the k
# plane; the other 23 of a row's 128 are zero padding (acl_mxu.py)
MXU_LIVE_PLANES = acl_mxu._K_PLANE + 1


def mxu_bound(*args, tc_rate: float = TC_INT8_OPS):
    """Five header columns and the int8 operand (k folded in) in, the
    encodes out; 2 * P * 105 * R' tensor-core operations (the live
    planes, ``MXU_LIVE_PLANES``; int8 by default, ``TC_BF16_FLOPS`` for
    the bf16 figure) and ~2 ALU operations per (packet, rule) in the
    epilogue (compare with 0, select)."""
    p, r = args[0].shape[0], args[5].shape[0]
    nbytes = p * 5 * 4 + r * acl_mxu.PLANES + p * 4
    return bound(nbytes, 2.0 * p * r, 2.0 * p * MXU_LIVE_PLANES * r,
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



def k8s_uplink_traffic(rng, n: int, up: int, world: K8sWorld,
                       node_ip: str = K8S_NODE_IP):
    """Uplink ingress: a quarter to service cluster IPs (port 80), a
    quarter to the node's node ports (on ``node_ip``), half straight to
    pod addresses on the policy ports; sources from the policies'
    ipBlocks (their excepts included) and from outside them. Returns the
    columns and each packet's destination pod (None for a cluster IP or
    a node port)."""
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
        kind == 1, np.uint32(ip4(node_ip)), pod_ips[to_pod]))
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


# --- phase 4i: the node agent on the card ------------------------------

AGENT_PODS = 110              # kubelet's default --max-pods
AGENT_POLICIES = 16           # the first 16 of phase 4h's policies
AGENT_PEERS = 15              # peer nodes published in the store
AGENT_ADDED = 110             # the pod a pod-add round creates
AGENT_DELETED = 17            # and the pod a pod-delete round removes
AGENT_MOVED = 3               # the service an endpoints update moves
AGENT_NOW = 400_000           # the pinned step clock (past phase 4g's)
AGENT_TTL_S = 36_000.0        # liveness lease of the node and its peers
AGENT_LEAVING_TTL_S = 600.0   # the lease of the peer that leaves
# the vpptcp session-rule table: the agent's engine holds 4,096 rules (the
# reference's fixed default, no knob), which 110 pods under 16 policies
# exceed; both nodes raise it alike before their first policy
AGENT_SESSION_RULES = 1 << 16
AGENT_ROUNDS = ("boot", "pod add", "pod delete", "policy add",
                "endpoints update", "peer leave")
# the exposition families the card-against-twin comparison leaves out
AGENT_UNCOMPARED = {
    "vpp_tpu_build_info": "its device label (the twin's is the CPU)",
    "vpp_tpu_jit_compiles_total": "process-wide capture counts",
    "vpp_tpu_device_transfer_bytes_total": "process-wide byte counters",
    "vpp_tpu_snapshot_age_seconds": "wall clock",
    "vpp_tpu_snapshot_chunk_seconds": "wall clock",
}
# wall-clock histograms: their _bucket and _sum lines are timings, their
# _count lines (observations) are compared
AGENT_WALL_HISTOGRAMS = (
    "vpp_tpu_config_propagation_seconds", "vpp_tpu_txn_commit_seconds",
    "vpp_tpu_cni_request_seconds", "vpp_tpu_fib_churn_commit_seconds")
# the kernel each ladder's fused rung launches
RUNG_KERNELS = {("classifier", "pallas"): "bv_first_set",
                ("classifier", "mxu"): "mxu_first_match",
                ("fib", "pallas"): "lpm_fused_lookup",
                ("session", "pallas"): "sess_probe_ways"}


def agent_config(cfg: DataplaneConfig, root: Path, card: bool,
                 io: bool = False) -> AgentConfig:
    """A phase 4i node's configuration: phase 4h's widths with the
    reference agent's default ladders (``auto``, fast path on), room for
    110 pods, the CNI socket, the persisted store (the card's), the
    session snapshots, and (``io``) the packet rings and a dispatch
    pump. The card agent serves HTTP (the CNI socket, the Prometheus
    and health pages, the maintenance thread), the CPU twin does not."""
    dp = cfg._replace(classifier="auto", fastpath=True, fib_impl="auto",
                      session_impl="auto", nat_mappings=K8S_NAT_MAPPINGS,
                      max_ifaces=128)
    return AgentConfig.from_dict({
        "node_name": K8S_NODE, "serve_http": card, "stats_port": 0,
        "health_port": 0, "http_host": "127.0.0.1",
        "cni_socket": str(root / "cni.sock"),
        "persist_path": str(root / "store.json") if card else None,
        "snapshot_path": str(root / "snaps"),
        "snapshot_chunk_buckets": SNAP_CHUNK, "snapshot_interval_s": 3600.0,
        "node_liveness_ttl_s": AGENT_TTL_S,
        "dataplane": dp._asdict(),
        "io": {"enabled": io, "pump_mode": "dispatch", "snap": PUMP_SNAP},
    })


class AgentNode:
    """A phase 4i node: the agent, its step clock pinned to ``clock``,
    and a KSR with mock Kubernetes sources on the agent's store. The
    CPU twin (``device="cpu"``) resolves the card's rungs and takes
    their plain versions."""

    def __init__(self, config: AgentConfig, clock: list, device=None):
        before = sum(capture.capture_counts().values())
        t0 = time.perf_counter()
        self.agent = ContivAgent(config, device=device)
        self.agent.session_engine.capacity = AGENT_SESSION_RULES
        dp = self.agent.dataplane
        dp.clock_ticks = lambda: clock[0]
        if device is not None:
            dp._kernels_serve = lambda: True
        self.agent.start()
        _sync(dp.device)
        self.boot_ms = (time.perf_counter() - t0) * 1e3
        self.boot_captures = sum(capture.capture_counts().values()) - before
        self.card = config.serve_http
        self.ksr = self.start_ksr()

    def start_ksr(self):
        """KSR with mock Kubernetes sources on the agent's store."""
        ksr = KsrAgent(store=self.agent.store, serve_http=False)
        ksr.start()
        return ksr

    def reflect(self, kind: str, key: str, obj) -> None:
        self.ksr.sources[getattr(km, kind).TYPE].add(key, obj)

    def unreflect(self, kind: str, key: str) -> None:
        self.ksr.sources[getattr(km, kind).TYPE].delete(key)

    def cni(self, command: str, i: int) -> str:
        """A CNI ADD or DEL of pod ``i``: kubelet's exec of the shim over
        the agent's socket on the card node, the CNI server's entry on
        the twin. Returns the pod's address (ADD)."""
        pid = k8s_pod(i)[0]
        req = CNIRequest(container_id=f"c-pod{i}",
                         netns=f"/var/run/netns/pod{i}", if_name="eth0",
                         extra_args={"K8S_POD_NAMESPACE": pid.namespace,
                                     "K8S_POD_NAME": pid.name})
        if not self.card:
            srv = self.agent.cni_server
            reply = srv.add(req) if command == "ADD" else srv.delete(req)
            if reply.result != 0:
                raise AssertionError(f"twin CNI {command} pod{i}: {reply}")
            return (reply.interfaces[0].ip_addresses[0].address.split("/")[0]
                    if command == "ADD" else "")
        env = {"CNI_COMMAND": command, "CNI_CONTAINERID": req.container_id,
               "CNI_NETNS": req.netns, "CNI_IFNAME": req.if_name,
               "CNI_ARGS": f"IgnoreUnknown=1;K8S_POD_NAMESPACE="
                           f"{pid.namespace};K8S_POD_NAME={pid.name}"}
        conf = {"cniVersion": cni_shim.CNI_VERSION, "name": "vpp-tpu",
                "type": "vpp-tpu-torch-cni",
                "grpcServer": self.agent.config.cni_socket}
        out, code = cni_shim.run(env, json.dumps(conf).encode())
        if code != 0:
            raise AssertionError(f"CNI {command} pod{i}: {out}")
        return json.loads(out)["ips"][0]["address"].split("/")[0] \
            if command == "ADD" else ""

    def publish_peers(self) -> None:
        """The peer nodes in the store: ids, addresses and liveness
        leases (the last peer's lease is the short one)."""
        for k in range(AGENT_PEERS):
            alloc = NodeIDAllocator(
                self.agent.store, f"peer-{k}",
                liveness_ttl_s=(AGENT_LEAVING_TTL_S if k == AGENT_PEERS - 1
                                else AGENT_TTL_S))
            peer = alloc.get_or_allocate()
            ip = str(self.agent.ipam.node_ip_address(peer))
            alloc.publish_ips(ip)
            alloc.publish_liveness(ip)

    def close(self) -> None:
        self.ksr.close()
        self.agent.close()


def agent_vip_traffic(rng, n: int, dp: Dataplane, world: K8sWorld,
                      r: int) -> dict:
    """Pod to service: live pods to the cluster IPs on port 80, source
    ports fresh every round."""
    pids = sorted(world.pods)
    a = rng.integers(0, len(pids), n)
    svcs = sorted(world.services)
    vip = np.array([ip4(world.services[s].cluster_ip) for s in svcs],
                   np.uint32)[rng.integers(0, len(svcs), n)]
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    return dict(
        src_ip=np.array([ip4(world.pods[p][1]) for p in pids],
                        np.uint32)[a],
        dst_ip=vip, proto=full(6),
        sport=(40000 + r * n + np.arange(n)).astype(np.int32),
        dport=full(80), ttl=full(64), pkt_len=full(512),
        rx_if=np.array([dp.pod_if[p] for p in pids], np.int32)[a],
        flags=full(FLAG_VALID))


def agent_replies(snap: dict) -> dict:
    """The replies of a processed vector's forwarded packets (LOCAL or
    REMOTE): endpoints swapped after NAT, received on the interface the
    forward packet left by; the other lanes invalid."""
    keep = np.isin(snap["disp"], (int(Disposition.LOCAL),
                                  int(Disposition.REMOTE)))
    n = keep.shape[0]
    full = lambda v: np.full(n, v, np.int32)  # noqa: E731
    return dict(src_ip=snap["pkts.dst_ip"].copy(),
                dst_ip=snap["pkts.src_ip"].copy(), proto=full(6),
                sport=snap["pkts.dport"].copy(),
                dport=snap["pkts.sport"].copy(), ttl=full(64),
                pkt_len=full(512),
                rx_if=np.where(keep, snap["tx_if"], 0).astype(np.int32),
                flags=np.where(keep, FLAG_VALID, 0).astype(np.int32))


def agent_rungs(dp: Dataplane) -> dict:
    """The rung each of the dataplane's ladders resolved."""
    snap = dp.kernel_snapshot()
    return {op: snap[op]["impl"] for op in ("classifier", "fib", "session")}


def agent_traffic(rng, agent: ContivAgent, world: K8sWorld, r: int):
    """A round's 4,096-packet vector: half pod to pod, a quarter pod to
    service, a quarter from the uplink. Returns the columns, the pod
    pairs of the first half and the destination pods of the uplink's
    quarter."""
    n = BIG_VEC
    dp = agent.dataplane
    pp, pairs = k8s_pod_traffic(rng, n // 2, dp, world, r)
    vip = agent_vip_traffic(rng, n // 4, dp, world, r)
    up, up_pods = k8s_uplink_traffic(
        rng, n // 4, agent.uplink_if, world,
        str(agent.ipam.node_ip_address()))
    return ({f: np.concatenate([pp[f], vip[f], up[f]]) for f in pp},
            pairs, up_pods)


def agent_check(nodes, world: K8sWorld, r: int, seed: int, now: int,
                kernels) -> dict:
    """One round on both nodes (module doc, phase 4i): the vector and
    its replies through each agent's ``dataplane.process``; results,
    state planes and staged tables equal the twin's; the pod-to-pod and
    uplink-to-pod verdicts the NetworkPolicy oracle's; the kernels of
    the resolved rungs launched. Returns counts for the log."""
    card, twin = nodes
    rng = np.random.default_rng(seed + 104729 * r)
    cols, pairs, up_pods = agent_traffic(rng, card.agent, world, r)
    before = {k: WRAPPERS[k].launches for k in kernels}
    snaps = {}
    for node in nodes:
        dp = node.agent.dataplane
        res = dp.process(packet_vector_from_numpy(cols, dp.device), now=now)
        node.agent.stats.update(res.stats)
        snaps[node] = [snapshot(res)]
    rep = agent_replies(snaps[twin][0])
    for node in nodes:
        dp = node.agent.dataplane
        res = dp.process(packet_vector_from_numpy(rep, dp.device),
                         now=now + 1)
        node.agent.stats.update(res.stats)
        snaps[node].append(snapshot(res))
    _sync(card.agent.dataplane.device)
    for k, (mine, want) in enumerate(zip(snaps[card], snaps[twin])):
        assert_equal({f: v for f, v in mine.items() if f != "stats.fastpath"},
                     want, f"agent round {r} step {k}")
    assert_equal(state_of(card.agent.dataplane), state_of(twin.agent.dataplane),
                 f"agent round {r} state")
    staged = (card.agent.dataplane.builder.host_arrays(),
              twin.agent.dataplane.builder.host_arrays())
    for f in staged[1]:
        if not np.array_equal(np.asarray(staged[0][f]),
                              np.asarray(staged[1][f])):
            raise AssertionError(f"agent round {r}: staged {f} differs")
    launched = {k: WRAPPERS[k].launches - before[k] for k in kernels}
    if any(v <= 0 for v in launched.values()):
        raise AssertionError(f"agent round {r}: launches {launched}")
    # the verdicts against the NetworkPolicy oracle
    fwd = snaps[twin][0]
    allowed = fwd["disp"] == int(Disposition.LOCAL)
    memo = {}
    denied = 0
    for k, (src, dst) in enumerate(pairs):
        key = (src, dst, int(cols["dport"][k]))
        if key not in memo:
            memo[key] = world.allowed(*key)
        if memo[key] != bool(allowed[k]) or (
                not memo[key] and fwd["drop_cause"][k] != DROP_ACL):
            raise AssertionError(
                f"agent round {r}: {src} -> {dst}:{key[2]} oracle "
                f"{'allow' if memo[key] else 'deny'}, disp "
                f"{int(fwd['disp'][k])} cause {int(fwd['drop_cause'][k])}")
        denied += not memo[key]
    base = 3 * BIG_VEC // 4
    up_denied = up_held = 0
    for j, dst in enumerate(up_pods):
        if dst is None:
            continue
        k = base + j
        src_ip = str(ipaddress.ip_address(int(cols["src_ip"][k])))
        want = world.allowed_from(src_ip, dst, int(cols["dport"][k]))
        if want != bool(allowed[k]) or (
                not want and fwd["drop_cause"][k] != DROP_ACL):
            raise AssertionError(
                f"agent round {r}: uplink {src_ip} -> {dst}:"
                f"{int(cols['dport'][k])} oracle "
                f"{'allow' if want else 'deny'}, disp {int(fwd['disp'][k])}")
        up_held += 1
        up_denied += not want
    return dict(pod_denied=denied, pod_allowed=len(pairs) - denied,
                uplink_to_pods=up_held, uplink_to_pods_denied=up_denied,
                dnat=int(fwd["stats.dnat"]),
                reply_sess_hits=int(snaps[twin][1]["stats.sess_hits"]),
                replies=int(np.count_nonzero(rep["flags"])),
                launches=launched)


def compared_exposition(text: str) -> list:
    """The exposition lines phase 4i holds equal between the nodes."""
    out = []
    for line in text.splitlines():
        name = (line.split(" ")[2] if line.startswith("# ")
                else line.split("{")[0].split(" ")[0])
        if name in AGENT_UNCOMPARED:
            continue
        if not line.startswith("#") and any(
                name.startswith(h + "_") and not name.endswith("_count")
                for h in AGENT_WALL_HISTOGRAMS):
            continue
        out.append(line)
    return out


def http_get(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read().decode()


def sample(text: str, name: str, **labels) -> float:
    """The value of one exposition sample (labels given in full)."""
    want = name + ("{" + ",".join(f'{k}="{v}"' for k, v in
                                  sorted(labels.items())) + "}"
                   if labels else "")
    for line in text.splitlines():
        if line.rsplit(" ", 1)[0] == want:
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"no sample {want}")


def hist_quantile(text: str, name: str, q: float, **labels) -> float:
    """``histogram_quantile`` of one exposed histogram series (seconds;
    linear inside the bucket, as Prometheus interpolates)."""
    lbl = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    rows = []
    for line in text.splitlines():
        m = re.match(rf'{name}_bucket\{{{lbl},le="([^"]+)"\}} (\S+)$', line)
        if m:
            rows.append((float(m.group(1)), float(m.group(2))))
    total = rows[-1][1]
    lo, below = 0.0, 0.0
    for bound, cum in rows:
        if cum >= q * total:
            if bound == float("inf"):
                return lo
            return lo + (bound - lo) * (q * total - below) / max(
                cum - below, 1.0)
        lo, below = bound, cum
    return lo


def agent_commit(node: AgentNode, fn) -> dict:
    """``fn(node)`` (one churn event), timed: its wall ms and the
    epoch-swap spans it recorded."""
    t0 = time.perf_counter()
    fn(node)
    _sync(node.agent.dataplane.device)
    t1 = time.perf_counter()
    swaps = [s for s in spans.RECORDER.entries()
             if s.stage == "swap" and s.t0 >= t0 and s.t0 + s.duration <= t1]
    return dict(commit_ms=(t1 - t0) * 1e3, swaps=len(swaps),
                swap_ms=sum(s.duration for s in swaps) * 1e3)


def agent_phase(cfg: DataplaneConfig, seed: int):
    """Phase 4i (module doc). Returns (summary, launches)."""
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_agent_")
    root = Path(tmp.name)
    (root / "card").mkdir()
    (root / "twin").mkdir()
    clock = [AGENT_NOW]
    for w in WRAPPERS.values():
        w.launches = 0
    card = AgentNode(agent_config(cfg, root / "card", True), clock)
    twin = AgentNode(agent_config(cfg, root / "twin", False), clock,
                     device="cpu")
    nodes = (card, twin)
    say(f"agent boot: card {card.boot_ms:.1f} ms to serving, "
        f"{card.boot_captures} captures; CPU twin {twin.boot_ms:.1f} ms")
    world = K8sWorld([])
    world.pods = {}
    world.policies = dict(list(world.policies.items())[:AGENT_POLICIES])
    for node in nodes:
        for ns in world.namespaces():
            node.reflect("Namespace", ns.name, ns)
    # 110 pods through CNI (the card's through the shim), then their
    # objects, the services, the peers and, last, the policies: every
    # CNI add re-renders every policy
    shim_ms = []
    for i in range(AGENT_PODS):
        t0 = time.perf_counter()
        ip = card.cni("ADD", i)
        shim_ms.append((time.perf_counter() - t0) * 1e3)
        if twin.cni("ADD", i) != ip:
            raise AssertionError(f"agent cni pod{i}: addresses differ")
        pid, labels, _ = k8s_pod(i)
        world.pods[pid] = (labels, ip)
    if card.agent.dataplane.pod_if != twin.agent.dataplane.pod_if:
        raise AssertionError("agent cni: interfaces differ from the twin's")
    for node in nodes:
        for pod in world.pod_objects():
            node.reflect("Pod", f"{pod.namespace}/{pod.name}", pod)
        for s in sorted(world.services):
            svc = world.services[s]
            node.reflect("Service", f"{svc.namespace}/{svc.name}", svc)
            node.reflect("Endpoints", f"{svc.namespace}/{svc.name}",
                         world.eps[s])
        node.publish_peers()
    t0 = time.perf_counter()
    for pol in world.policies.values():
        for node in nodes:
            node.reflect("Policy", f"{pol.namespace}/{pol.name}", pol)
    policy_s = time.perf_counter() - t0
    rungs = {node: agent_rungs(node.agent.dataplane) for node in nodes}
    kernels = tuple(sorted(RUNG_KERNELS[r] for r in rungs[card].items()
                           if r in RUNG_KERNELS))
    say(f"agent staged: {len(world.pods)} pods, {len(world.policies)} "
        f"policies (both nodes in {policy_s:.1f} s), "
        f"{len(world.services)} services, {AGENT_PEERS} peers; "
        f"{json.dumps(k8s_staged(card.agent.dataplane))}; rungs "
        f"{json.dumps(rungs[card])} -> kernels {list(kernels)}")
    if rungs[twin] != rungs[card]:
        raise AssertionError(f"agent: the twin resolved {rungs[twin]}")
    rules = [n.agent.session_engine.num_rules for n in nodes]
    for node in nodes:
        if not node.agent.statuscheck.liveness()["ready"]:
            raise AssertionError(f"agent: not ready after staging: "
                                 f"{node.agent.statuscheck.plugin_status()}")
    if rules[0] != rules[1]:
        raise AssertionError(f"agent: session rules {rules}")
    say(f"agent session rules: {rules[0]} (vpptcp renderer; the engine's "
        f"default capacity is 4,096)")
    text = http_get(card.agent.stats_http.port, "/stats")
    cni = dict(p50_ms=hist_quantile(text, "vpp_tpu_cni_request_seconds",
                                    0.5, op="add") * 1e3,
               p99_ms=hist_quantile(text, "vpp_tpu_cni_request_seconds",
                                    0.99, op="add") * 1e3,
               count=sample(text, "vpp_tpu_cni_request_seconds_count",
                            op="add"),
               shim_p50_ms=float(np.percentile(shim_ms, 50)),
               shim_p99_ms=float(np.percentile(shim_ms, 99)))
    say(f"agent cni: {AGENT_PODS} adds through the shim: "
        f"vpp_tpu_cni_request_seconds p50 {cni['p50_ms']:.3f} ms, p99 "
        f"{cni['p99_ms']:.3f} ms (bucket-interpolated); shim exec-to-reply "
        f"p50 {cni['shim_p50_ms']:.3f} ms, p99 {cni['shim_p99_ms']:.3f} ms")

    def churn(kind: str, r: int):
        if kind == "pod add":
            pid, labels, _ = k8s_pod(AGENT_ADDED)
            ips = {}

            def fn(node):
                ips[node] = ip = node.cni("ADD", AGENT_ADDED)
                node.reflect("Pod", f"{pid.namespace}/{pid.name}", km.Pod(
                    name=pid.name, namespace=pid.namespace, labels=labels,
                    ip_address=ip))
            row = agent_commit(card, fn)
            fn(twin)
            if ips[card] != ips[twin]:
                raise AssertionError("agent pod add: addresses differ")
            world.pods[pid] = (labels, ips[card])
            return row
        if kind == "pod delete":
            pid = k8s_pod(AGENT_DELETED)[0]
            del world.pods[pid]

            def fn(node):
                node.unreflect("Pod", f"{pid.namespace}/{pid.name}")
                node.cni("DEL", AGENT_DELETED)
        elif kind == "policy add":
            pol = k8s_policies()[AGENT_POLICIES]
            world.policies[(pol.namespace, pol.name)] = pol

            def fn(node):
                node.reflect("Policy", f"{pol.namespace}/{pol.name}", pol)
        elif kind == "endpoints update":
            eps = k8s_endpoints(AGENT_MOVED, gen=r)
            world.eps[AGENT_MOVED] = eps

            def fn(node):
                node.reflect("Endpoints", f"{eps.namespace}/{eps.name}",
                             eps)
        elif kind == "peer leave":
            def fn(node):
                gone = node.agent.store.sweep_leases(
                    now=time.monotonic() + AGENT_LEAVING_TTL_S + 1)
                if gone != 1:
                    raise AssertionError(f"peer leave: {gone} keys expired")
        else:
            raise ValueError(kind)
        row = agent_commit(card, fn)
        fn(twin)
        return row

    rounds = {}
    now = AGENT_NOW
    for r, kind in enumerate(AGENT_ROUNDS):
        commit = churn(kind, r) if kind != "boot" else {}
        now += 10
        clock[0] = now
        rounds[kind] = dict(commit, **agent_check(nodes, world, r, seed,
                                                  now, kernels))
        say(f"agent round {kind}: {json.dumps(rounds[kind])}")
    if not any(v["reply_sess_hits"] for v in rounds.values()):
        raise AssertionError("agent: no reply hit a session")
    # the surface: a maintenance tick on each, the card's pages over HTTP
    for node in nodes:
        node.agent.maintenance_tick()
    t0 = time.perf_counter()
    text = http_get(card.agent.stats_http.port, "/stats")
    scrape_ms = (time.perf_counter() - t0) * 1e3
    ready = json.loads(http_get(card.agent.health_http.port, "/readiness"))
    mine = compared_exposition(text)
    want = compared_exposition(twin.agent.stats.registry.render("/stats"))
    if mine != want:
        diff = sorted(set(mine) ^ set(want))[:6]
        raise AssertionError(f"agent exposition differs from the twin's: "
                             f"{diff}")
    active = sample(text, "vpp_tpu_node_sessions_active")
    if active <= 0 or not ready.get("ready"):
        raise AssertionError(f"agent surface: sessions {active}, "
                             f"readiness {ready}")
    families = text.count("# TYPE ")
    metrics = dict(scrape_ms=scrape_ms, bytes=len(text.encode()),
                   families=families, sessions_active=active,
                   compared_lines=len(mine))
    say(f"agent metrics: GET /stats {scrape_ms:.2f} ms, {metrics['bytes']} "
        f"bytes, {families} families, {len(mine)} lines equal to the "
        f"twin's (left out: {sorted(AGENT_UNCOMPARED)} and the _bucket / "
        f"_sum lines of {list(AGENT_WALL_HISTOGRAMS)}); sessions active "
        f"{active:g}; readiness {json.dumps(ready)}")
    # restart to warm: close with a parting snapshot, boot on the same
    # store file and snapshot directory with the rings and a pump
    dp = card.agent.dataplane
    closing_pods = dict(dp.pod_if)
    closing_index = sorted((c.container_id, c.ip, c.if_index) for c in
                           card.agent.container_index.load_persisted())
    last_rep = agent_replies(snapshot(dp.process(
        packet_vector_from_numpy(agent_traffic(
            np.random.default_rng(seed), card.agent, world, 99)[0],
            dp.device),
        now=now + 5)))
    times = {}

    def timed(obj, name: str, key: str) -> None:
        fn = getattr(obj, name)

        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _sync(dev)
                times[key] = (time.perf_counter() - t) * 1e3
        setattr(obj, name, wrapper)

    dev = dp.device
    timed(card.agent.snapshotter, "final_snapshot", "snapshot_write_ms")
    closing = state_of(dp)
    t0 = time.perf_counter()
    card.close()
    times["close_ms"] = (time.perf_counter() - t0) * 1e3
    manifest = json.loads((root / "card" / "snaps" /
                           snapshot_mod.MANIFEST).read_text())
    clock2 = [5]
    cfg_io = agent_config(cfg, root / "card", True, io=True)
    t1 = time.perf_counter()
    agent = ContivAgent(cfg_io)
    agent.session_engine.capacity = AGENT_SESSION_RULES
    agent.dataplane.clock_ticks = lambda: clock2[0]
    timed(agent.snapshotter, "restore_into", "restore_ms")
    timed(agent.cni_server, "resync", "resync_ms")
    agent.start()
    _sync(dev)
    times["boot_ms"] = (time.perf_counter() - t1) * 1e3
    times["close_to_warm_ms"] = (time.perf_counter() - t0) * 1e3
    try:
        # the session columns (the sweep cursors moved: the pump's
        # warm-up steps each dispatch rung once)
        got = state_of(agent.dataplane)
        for f, v in closing.items():
            if f.endswith("_sweep_cursor"):
                continue
            want_v = (v - np.int32(manifest["now"]) if f.endswith("_time")
                      else v)
            if not np.array_equal(got[f], want_v):
                raise AssertionError(f"agent restart: {f} differs from "
                                     f"the planes at close")
        # the same pods on the same addresses, each on the interface its
        # persisted record names; the resync re-adds the pods in index
        # order, so a slot freed before the restart renumbers the pods
        # after it (the reference's resync does the same)
        live = agent.dataplane.pod_if
        persisted = agent.container_index.load_persisted()
        index = sorted((c.container_id, c.ip) for c in persisted)
        if set(live) != set(closing_pods) or index != [
                (cid, ip) for cid, ip, _ in closing_index] or any(
                live[(c.pod_namespace, c.pod_name)] != c.if_index
                for c in persisted):
            raise AssertionError("agent restart: the CNI resync gave back "
                                 "other pods, addresses or interfaces")
        renumbered = sum(live[p] != closing_pods[p] for p in live)
        new_if = {closing_pods[p]: live[p] for p in live}
        last_rep["rx_if"] = np.array([new_if.get(int(i), int(i))
                                      for i in last_rep["rx_if"]], np.int32)
        res = agent.dataplane.process(
            packet_vector_from_numpy(last_rep, agent.dataplane.device),
            now=clock2[0])
        hits, valid = int(res.stats.sess_hits), int(np.count_nonzero(
            last_rep["flags"]))
        if hits != valid:
            raise AssertionError(f"agent restart: {hits} of {valid} replies "
                                 f"hit a session")
        # one round of frames through the rings and the pump
        before = {k: WRAPPERS[k].launches for k in kernels}
        rng = np.random.default_rng(seed + 7)
        fwd, pairs, _ = agent_traffic(rng, agent, world, 100)
        frames = ring_frames(fwd)
        tx = []
        wall = exchange(agent.io_rings, frames, tx)
        ring_launched = {k: WRAPPERS[k].launches - before[k]
                         for k in kernels}
        verdicts = np.concatenate([f["disp"][:k] for f, k in tx])
        if len(tx) != len(frames) or verdicts.shape[0] != BIG_VEC:
            raise AssertionError("agent rings: frames lost")
        for k, (src, dst) in enumerate(pairs):
            if world.allowed(src, dst, int(fwd["dport"][k])) != (
                    verdicts[k] == int(Disposition.LOCAL)):
                raise AssertionError(f"agent rings: {src} -> {dst} "
                                     f"verdict {int(verdicts[k])} is not "
                                     f"the oracle's")
        agent.maintenance_tick()
        text = http_get(agent.stats_http.port, "/stats")
        pumped = sample(text, "vpp_tpu_pump_frames")
        if pumped < len(frames) or sample(text, "vpp_tpu_pump_packets") \
                < BIG_VEC or any(v <= 0 for v in ring_launched.values()):
            raise AssertionError(f"agent rings: pump frames {pumped}, "
                                 f"launches {ring_launched}")
        restart = dict(times, sess_hits=hits, replies=valid,
                       pods=len(live), renumbered=renumbered,
                       frames=len(frames), ring_wall_ms=wall * 1e3,
                       pump_frames=pumped, ring_launches=ring_launched,
                       snapshot_now=int(manifest["now"]),
                       generation=int(manifest["generation"]))
        say(f"agent restart: close to serving warm {times['close_to_warm_ms']:.1f} ms "
            f"(snapshot write {times['snapshot_write_ms']:.1f} ms in close "
            f"{times['close_ms']:.1f} ms; boot {times['boot_ms']:.1f} ms: "
            f"restore {times['restore_ms']:.1f} ms, CNI resync "
            f"{times['resync_ms']:.1f} ms); {len(live)} pods on their "
            f"addresses ({renumbered} renumbered); {hits} of {valid} "
            f"replies hit "
            f"their restored sessions; {len(frames)} frames through the rings "
            f"in {wall * 1e3:.1f} ms, vpp_tpu_pump_frames {pumped:g}")
    finally:
        agent.close()
        twin.close()
    _sync(dev)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    tmp.cleanup()
    summary = dict(boot_ms=card.boot_ms, boot_captures=card.boot_captures,
                   cni=cni, rounds=rounds, metrics=metrics, restart=restart,
                   kernels=list(kernels), launches=launches,
                   seconds=time.perf_counter() - t_phase)
    say(f"phase 4i: {summary['seconds']:.1f} s; launches {launches}")
    return summary, launches


# --- phase 4j: the agent's remote surfaces on the card -----------------

REMOTE_TTL_S = 2.0            # the witness lease of a store pair's primary
REMOTE_PROMOTE_S = 0.5        # a standby's claims start after this
REMOTE_WAIT_S = 120.0         # the longest a convergence may take
REMOTE_TOKEN = "smoke-token"  # the kubeconfig's bearer token
REMOTE_ADDED = 110            # the pod the pod-add round creates
REMOTE_MOVED = 5              # the service the dropped stream moves
REMOTE_RUNS = 20              # show run calls per row
# the kernels phase 4j must launch: the agents' ML stage, beside their
# rungs' (RUNG_KERNELS); and, with show run on phase 4's dataplane, these
REMOTE_ML_KERNELS = ("ml_score",)
REMOTE_KERNELS = ("sess_probe_ways", "bv_first_set", "lpm_fused_lookup",
                  "ml_score")
# the CLI commands phase 4j runs on both nodes, in order; `trace add 8`
# arms the tracer the next round's first step fills
REMOTE_CLI = ("show interface", "show sessions", "show kernels", "show ml",
              "show store", "show resilience", "trace add 8")
# (command, line prefix) -> why the card's line may differ from the twin's
REMOTE_CLI_DIFFERS = {
    ("show kernels", "kernel implementation ladders"):
        "names the device: the card, the twin's cpu",
    ("show store", "connected:"): "each node's own store endpoint and "
                                  "ping time",
    ("show store", "  endpoint"): "each node's own store endpoints",
    ("show store", "revision:"): "the card agent's maintenance thread "
                                 "writes on its own timer (liveness)",
}


class Relay:
    """A TCP forwarder standing in for the link between a node and one
    store server: ``cut`` resets every stream and stops listening, so a
    connect is refused (a partition, both ends alive); ``heal`` listens
    on the same port again."""

    def __init__(self, target_port: int):
        import threading

        self.target_port = target_port
        self._socks = set()
        self._lock = threading.Lock()
        self.port = 0
        self._listen()

    def _listen(self) -> None:
        import socket
        import threading

        ls = socket.socket()
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(("127.0.0.1", self.port))
        ls.listen(16)
        self.port = ls.getsockname()[1]
        self._ls = ls
        threading.Thread(target=self._accept_loop, args=(ls,),
                         daemon=True).start()

    def _accept_loop(self, ls) -> None:
        import socket
        import threading

        while True:
            try:
                a, _ = ls.accept()
            except OSError:
                return
            try:
                b = socket.create_connection(
                    ("127.0.0.1", self.target_port), timeout=5)
                b.settimeout(None)  # an idle link is not a dead one
            except OSError:
                a.close()
                continue
            with self._lock:
                self._socks.update((a, b))
            for src, dst in ((a, b), (b, a)):
                threading.Thread(target=self._pump, args=(src, dst),
                                 daemon=True).start()

    @staticmethod
    def _pump(src, dst) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass

    def cut(self) -> None:
        import socket

        try:  # wakes the blocked accept: a bare close would not
            self._ls.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._ls.close()
        with self._lock:
            socks, self._socks = self._socks, set()
        for s in socks:
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             b"\x01\x00\x00\x00\x00\x00\x00\x00")
                s.close()  # RST: both ends learn at once
            except OSError:
                pass

    def heal(self) -> None:
        self._listen()

    def close(self) -> None:
        self.cut()


class StorePair:
    """One node's cluster store: a primary ``KVServer`` and a standby
    following it (``Replicator``), each under an ``HaCoordinator`` fenced
    by a ``QuorumWitness``, all on localhost. ``url`` names both
    endpoints (through ``Relay`` links when ``relayed``: the node's side
    of the network can be cut)."""

    def __init__(self, root: Path, relayed: bool):
        from vpp_tpu_torch.kvstore.replica import HaCoordinator
        from vpp_tpu_torch.kvstore.server import KVServer
        from vpp_tpu_torch.kvstore.witness import QuorumWitness

        root.mkdir(parents=True, exist_ok=True)
        self.witness = QuorumWitness(
            persist_path=str(root / "witness.json")).start()
        self.servers, self.ha = [], []
        for role in ("primary", "standby"):
            srv = KVServer(host="127.0.0.1", port=0,
                           persist_path=str(root / f"{role}.json")).start()
            follow = (f"127.0.0.1:{self.servers[0].port}"
                      if role == "standby" else None)
            self.ha.append(HaCoordinator(
                srv, self.witness.address, f"127.0.0.1:{srv.port}",
                fence_ttl=REMOTE_TTL_S, promote_after=REMOTE_PROMOTE_S,
                follow=follow).start())
            self.servers.append(srv)
        ports = [s.port for s in self.servers]
        self.relays = [Relay(p) for p in ports] if relayed else []
        self.direct_url = "tcp://" + ",".join(f"127.0.0.1:{p}" for p in ports)
        self.url = ("tcp://" + ",".join(f"127.0.0.1:{r.port}"
                                        for r in self.relays)
                    if relayed else self.direct_url)

    def kill_primary(self) -> None:
        self.ha[0].stop()
        self.servers[0].close()

    def writable(self) -> bool:
        repl = self.ha[1].replicator
        return (repl is not None and repl.promoted.is_set()
                and not self.servers[1].read_only)

    def close(self) -> None:
        for r in self.relays:
            r.close()
        for ha, srv in zip(self.ha, self.servers):
            ha.stop()
            srv.close()
        self.witness.close()


class FakeApiServer:
    """A Kubernetes API server for KSR's list-watch sources (stdlib
    ``ThreadingHTTPServer``): a list GET answers from ``objects`` at
    resource version ``rv``; a watch GET streams chunked JSON lines from
    its path's queue (None ends the stream, as a server's watch timeout
    does). Every request must carry the kubeconfig's bearer token."""

    def __init__(self):
        import queue
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        self.objects, self.queues, self.lists = {}, {}, {}
        self.rv = 100
        self.denied = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.headers.get("Authorization") != \
                        f"Bearer {REMOTE_TOKEN}":
                    outer.denied += 1
                    self.send_response(401)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                url = urlparse(self.path)
                if parse_qs(url.query).get("watch") == ["true"]:
                    self._watch(url.path)
                    return
                outer.lists[url.path] = outer.lists.get(url.path, 0) + 1
                body = json.dumps({
                    "kind": "List",
                    "metadata": {"resourceVersion": str(outer.rv)},
                    "items": list(outer.objects.get(url.path, {})
                                  .values())}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _watch(self, path):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                q = outer.queues.setdefault(path, queue.Queue())
                while True:
                    ev = q.get()
                    if ev is None:
                        self.wfile.write(b"0\r\n\r\n")
                        return
                    data = json.dumps(ev).encode() + b"\n"
                    try:
                        self.wfile.write(f"{len(data):x}\r\n".encode()
                                         + data + b"\r\n")
                        self.wfile.flush()
                    except OSError:
                        return

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def _queue(self, path):
        import queue

        return self.queues.setdefault(path, queue.Queue())

    def put(self, path: str, key: str, obj: dict, event=None) -> None:
        """Store ``obj`` (a new resource version); ``event`` ADDED or
        MODIFIED also streams it to the watchers."""
        self.rv += 1
        obj["metadata"]["resourceVersion"] = str(self.rv)
        self.objects.setdefault(path, {})[key] = obj
        if event:
            self._queue(path).put({"type": event, "object": obj})

    def delete(self, path: str, key: str) -> None:
        self.rv += 1
        obj = self.objects[path].pop(key)
        obj["metadata"]["resourceVersion"] = str(self.rv)
        self._queue(path).put({"type": "DELETED", "object": obj})

    def drop_stream(self, path: str) -> None:
        """410 Gone: the watch's continuity is lost; the client must
        re-list and diff."""
        q = self._queue(path)
        q.put({"type": "ERROR", "object": {
            "kind": "Status", "code": 410,
            "message": "too old resource version"}})
        q.put(None)

    def close(self) -> None:
        for q in self.queues.values():
            q.put(None)
        self.server.shutdown()
        self.server.server_close()


def raw_selector(sel) -> dict:
    out = {"matchLabels": dict(sel.match_labels)}
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, "values": list(e.values)}
            for e in sel.match_expressions]
    return out


def raw_object(obj) -> dict:
    """The Kubernetes API JSON of a ``ksr.model`` object, as an API server
    serves it (``ksr/k8s_client.py`` converts it back)."""
    meta = {"name": obj.name}
    if getattr(obj, "namespace", ""):
        meta["namespace"] = obj.namespace
    if getattr(obj, "labels", None):
        meta["labels"] = dict(obj.labels)
    if isinstance(obj, km.Namespace):
        return {"metadata": meta}
    if isinstance(obj, km.Pod):
        return {"metadata": meta, "spec": {"containers": []},
                "status": {"podIP": obj.ip_address,
                           "hostIP": obj.host_ip_address}}
    if isinstance(obj, km.Policy):
        def peer(p):
            out = {}
            if p.pods is not None:
                out["podSelector"] = raw_selector(p.pods)
            if p.namespaces is not None:
                out["namespaceSelector"] = raw_selector(p.namespaces)
            if p.ip_block is not None:
                out["ipBlock"] = {"cidr": p.ip_block.cidr,
                                  "except": list(p.ip_block.except_cidrs)}
            return out

        types = {km.POLICY_INGRESS: ["Ingress"], km.POLICY_EGRESS: ["Egress"],
                 km.POLICY_BOTH: ["Ingress", "Egress"]}
        spec = {"podSelector": raw_selector(obj.pods),
                "ingress": [{"from": [peer(p) for p in r.peers],
                             "ports": [{"protocol": p.protocol,
                                        "port": p.port if p.port is not None
                                        else p.port_name} for p in r.ports]}
                            for r in obj.ingress_rules]}
        if obj.policy_type in types:
            spec["policyTypes"] = types[obj.policy_type]
        return {"metadata": meta, "spec": spec}
    if isinstance(obj, km.Service):
        return {"metadata": meta, "spec": {
            "clusterIP": obj.cluster_ip, "type": obj.service_type,
            "externalTrafficPolicy": obj.external_traffic_policy,
            "selector": dict(obj.selector),
            "externalIPs": list(obj.external_ips),
            "ports": [{"name": p.name, "protocol": p.protocol,
                       "port": p.port, "targetPort": p.target_port,
                       "nodePort": p.node_port} for p in obj.ports]}}
    if isinstance(obj, km.Endpoints):
        return {"metadata": meta, "subsets": [{
            "addresses": [{"ip": a.ip, "nodeName": a.node_name}
                          for a in s.addresses],
            "notReadyAddresses": [{"ip": a.ip, "nodeName": a.node_name}
                                  for a in s.not_ready_addresses],
            "ports": [{"name": p.name, "port": p.port,
                       "protocol": p.protocol} for p in s.ports]}
            for s in obj.subsets]}
    raise TypeError(type(obj))


def api_put(fake: FakeApiServer, obj, event=None) -> None:
    """``obj`` onto the fake API server at its resource's path, checked
    to convert back to itself through the port's client."""
    from vpp_tpu_torch.ksr import k8s_client

    res = k8s_client.RESOURCES[obj.TYPE]
    raw = raw_object(obj)
    if res.convert(raw).to_dict() != obj.to_dict():
        raise AssertionError(f"{obj.key()}: the API JSON does not convert "
                             f"back to the object")
    fake.put(res.path, obj.key(), raw, event)


class RemoteNode(AgentNode):
    """A phase 4j node: a phase 4i node whose agent keeps its state in a
    ``StorePair`` (``store_url``), serves its debug CLI on a socket (the
    card's), loads its ML model from an artifact, and whose KSR reflects
    a ``FakeApiServer`` through ``make_k8s_sources(kubeconfig=...)``
    from a process-separate store client."""

    def __init__(self, config: AgentConfig, clock: list, pair: StorePair,
                 kubeconfig: str, fake: FakeApiServer, device=None):
        self.pair, self.fake, self.kubeconfig = pair, fake, kubeconfig
        super().__init__(config, clock, device)
        self._seen = []
        self._n = 0
        self.agent.store.watch("smoke/", lambda ev: self._seen.append(
            ev.value))

    def start_ksr(self):
        """None at boot: ``list_world`` starts KSR once the API server
        holds the world."""
        return None

    def list_world(self) -> None:
        """KSR over the fake API server (``make_k8s_sources`` from the
        kubeconfig) and a store client of its own."""
        from vpp_tpu_torch.ksr.k8s_client import make_k8s_sources

        sources = make_k8s_sources(kubeconfig=self.kubeconfig)
        for lw in sources.values():
            lw.RECONNECT_BACKOFF = (0.05, 0.2)
        self.ksr = KsrAgent(store_url=self.pair.direct_url, sources=sources,
                            serve_http=False)
        self.ksr.start()

    def settle(self, what: str, pred=None) -> float:
        """Wait for ``pred()`` (over the store, as KSR wrote it), then for
        the agent to have handled every store event before a barrier
        write: its client dispatches events in revision order, so once
        the agent's own watch hears the barrier, every earlier event has
        run its handler. Returns the wait in ms."""
        t0 = time.perf_counter()
        deadline = time.monotonic() + REMOTE_WAIT_S
        while pred is not None and not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: the store never converged")
            time.sleep(0.005)
        first = self._n + 1
        while not any(v >= first for v in self._seen):
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: the agent never caught up")
            self._n += 1
            self.ksr.store.put("smoke/barrier", self._n)
            step = time.monotonic() + 1.0
            while time.monotonic() < step and not any(
                    v >= first for v in self._seen):
                time.sleep(0.002)
        return (time.perf_counter() - t0) * 1e3

    def keys(self, prefix: str) -> int:
        return len(self.ksr.store.list_keys(prefix))

    def close(self) -> None:
        if self.ksr is not None:
            for lw in self.ksr.sources.values():
                lw.stop()
            self.ksr.close()
            self.ksr.store.close()
        self.agent.close()
        self.agent.store.close()


def remote_config(cfg: DataplaneConfig, root: Path, card: bool, url: str,
                  model: Path) -> AgentConfig:
    """A phase 4j node's configuration: phase 4i's with the store at
    ``url``, the card's CLI socket, the ML stage enforcing the artifact
    at ``model`` (the trainer's default action, mark: flags, no drops),
    no session snapshots and no local store file."""
    c = agent_config(cfg, root, card)
    dp = c.dataplane._replace(ml_stage="enforce", ml_hidden=16)
    return dataclasses.replace(
        c, store_url=url, persist_path=None, snapshot_path="",
        cli_socket=str(root / "cli.sock") if card else "",
        ml_model_path=str(model), dataplane=dp)


def publish_artifact(path: Path, tmp: Path) -> None:
    """Move ``tmp`` onto ``path`` in one rename, its mtime past the old
    file's: a loader's poll sees the old file or the new one, and one
    change."""
    import os

    if path.exists():
        old = path.stat().st_mtime
        os.utime(tmp, (old + 1, old + 1))
    tmp.replace(path)


def train_artifact(path: Path, seed: int, version: int) -> float:
    """``vpp-tpu-torch-ml-train --kind mlp --hidden 16`` in its own
    process, then published onto ``path``. Returns its wall ms."""
    tmp = path.with_suffix(".new")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "vpp_tpu_torch.ml.train", "--out", str(tmp),
         "--kind", "mlp", "--hidden", "16", "--seed", str(seed),
         "--version", str(version)],
        check=True, capture_output=True, text=True, timeout=300,
        cwd=str(Path(__file__).resolve().parent))
    publish_artifact(path, tmp)
    return (time.perf_counter() - t0) * 1e3


def ml_tick(nodes, outcome: str, count: int) -> float:
    """Tick both agents (their loaders poll the artifact) and wait until
    each counted ``count`` of ``outcome`` (the card's maintenance thread
    may poll first). Returns the card's ms."""
    out = {}
    for node in nodes:
        t0 = time.perf_counter()
        node.agent.maintenance_tick()
        deadline = time.monotonic() + REMOTE_WAIT_S
        src = node.agent.ml_source
        while src.stats_snapshot()["outcomes"][outcome] < count:
            if time.monotonic() > deadline:
                raise AssertionError(f"ml {outcome}: {src.stats_snapshot()}")
            time.sleep(0.005)
        _sync(node.agent.dataplane.device)
        out[node] = (time.perf_counter() - t0) * 1e3
    return out[nodes[0]]


def cli_pairs(world: K8sWorld):
    """One denied and one allowed (src, dst, port) pod pair of the
    NetworkPolicy oracle (TCP; the sources' and destinations' first
    pairs in pod order)."""
    pids = sorted(world.pods)
    found = {}
    for dst in pids:
        for src in pids:
            if src == dst:
                continue
            for port in K8S_PORTS:
                ok = world.allowed(src, dst, port)
                found.setdefault(ok, (src, dst, port))
            if len(found) == 2:
                return found[False], found[True]
    raise AssertionError("no denied and allowed pod pair")


def remote_cli(card: RemoteNode, twin: RemoteNode, world: K8sWorld,
               lines) -> dict:
    """``lines`` through ``vpp-tpu-torch-ctl`` on the card's CLI socket
    and through the twin's CLI in process (the handles its agent gives
    its own): each text equal but for ``REMOTE_CLI_DIFFERS``. Returns
    {line: (card text, round-trip ms)}."""
    from vpp_tpu_torch.cli import DebugCLI
    from vpp_tpu_torch.cmd import ctl

    a = twin.agent
    tcli = DebugCLI(a.dataplane, stats=a.stats, pump=a.io_pump,
                    session_engine=a.session_engine, store=a.store,
                    snapshotter=a.snapshotter, ml_source=a.ml_source)

    def kept(cmd, text):
        return [ln for ln in text.splitlines()
                if not any(c == cmd and ln.startswith(p)
                           for c, p in REMOTE_CLI_DIFFERS)]

    out = {}
    for line in lines:
        t0 = time.perf_counter()
        got = ctl.run_line(card.agent.config.cli_socket, line, 60.0)
        ms = (time.perf_counter() - t0) * 1e3
        want = tcli.run(line)
        cmd = " ".join(line.split()[:2])
        if kept(cmd, got) != kept(cmd, want):
            raise AssertionError(f"cli {line!r}: the card's text differs "
                                 f"from the twin's:\n{got}\n---\n{want}")
        out[line] = (got, ms)
    return out


def remote_phase(cfg: DataplaneConfig, gpu: Dataplane, up: int, seed: int):
    """Phase 4j (module doc). Returns (summary, launches)."""
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_remote_")
    root = Path(tmp.name)
    clock = [AGENT_NOW]
    for w in WRAPPERS.values():
        w.launches = 0
    model = root / "model.json"
    train_ms = {"v1": train_artifact(model, seed, 1)}
    nodes, pairs, fakes = [], [], []
    try:
        for name, card in (("card", True), ("twin", False)):
            pair = StorePair(root / name / "store", relayed=card)
            fake = FakeApiServer()
            kc = root / name / "kubeconfig"
            kc.write_text(json.dumps({
                "current-context": "smoke",
                "contexts": [{"name": "smoke", "context": {
                    "cluster": "smoke", "user": "ksr"}}],
                "clusters": [{"name": "smoke",
                              "cluster": {"server": fake.url}}],
                "users": [{"name": "ksr", "user": {"token": REMOTE_TOKEN}}],
            }))
            pairs.append(pair)
            fakes.append(fake)
            nodes.append(RemoteNode(
                remote_config(cfg, root / name, card, pair.url, model),
                clock, pair, str(kc), fake,
                device=None if card else "cpu"))
        card, twin = nodes
        for node in nodes:
            src = node.agent.ml_source.stats_snapshot()
            if src["outcomes"]["loaded"] != 1 or src["loaded_version"] != 1:
                raise AssertionError(f"ml boot load: {src}")
        say(f"remote boot: card {card.boot_ms:.1f} ms to serving on "
            f"{card.pair.url} (ML v1 loaded; trainer "
            f"{train_ms['v1']:.0f} ms), {card.boot_captures} captures; "
            f"CPU twin {twin.boot_ms:.1f} ms")
        world = K8sWorld([])
        world.pods = {}
        world.policies = dict(list(world.policies.items())[:AGENT_POLICIES])
        for i in range(AGENT_PODS):
            ip = card.cni("ADD", i)
            if twin.cni("ADD", i) != ip:
                raise AssertionError(f"remote cni pod{i}: addresses differ")
            pid, labels, _ = k8s_pod(i)
            world.pods[pid] = (labels, ip)
        # the API servers' world (without the policies), then KSR: one
        # list per resource
        objs = (world.namespaces() + world.pod_objects()
                + [world.services[s] for s in sorted(world.services)]
                + [world.eps[s] for s in sorted(world.services)])
        timing = {}
        for node in nodes:
            for obj in objs:
                api_put(node.fake, obj)
            t0 = time.perf_counter()
            node.list_world()
            node.settle("list", lambda n=node: n.keys("ksr/") == len(objs))
            timing[node] = (time.perf_counter() - t0) * 1e3
            node.publish_peers()
            node.settle("peers")
        list_ms = timing[card]
        # the policies stream as watch events
        for node in nodes:
            t0 = time.perf_counter()
            for pol in world.policies.values():
                api_put(node.fake, pol, "ADDED")
            node.settle("policies", lambda n=node: n.keys(
                "ksr/k8s/policy/") == len(world.policies))
            timing[node] = (time.perf_counter() - t0) * 1e3
        rungs = {node: agent_rungs(node.agent.dataplane) for node in nodes}
        if rungs[twin] != rungs[card]:
            raise AssertionError(f"remote: the twin resolved {rungs[twin]}")
        kernels = tuple(sorted({RUNG_KERNELS[r] for r in rungs[card].items()
                                if r in RUNG_KERNELS}
                               | set(REMOTE_ML_KERNELS)))
        say(f"remote staged: KSR list of {len(objs)} objects from the fake "
            f"API server {list_ms:.1f} ms to the card agent's commit; "
            f"{len(world.policies)} policies as watch events "
            f"{timing[card]:.1f} ms (twin {timing[twin]:.1f} ms); "
            f"{json.dumps(k8s_staged(card.agent.dataplane))}; rungs "
            f"{json.dumps(rungs[card])} -> kernels {list(kernels)}")

        rounds = {}
        now = AGENT_NOW

        def round_(kind: str, extra=None) -> None:
            nonlocal now
            now += 10
            clock[0] = now
            r = len(rounds)
            rounds[kind] = dict(extra or {}, **agent_check(
                nodes, world, r, seed + 31, now, kernels))
            say(f"remote round {kind}: {json.dumps(rounds[kind])}")

        def watched(kind: str, fn, pred) -> dict:
            """``fn(node)`` on each node's API server; the card's time
            from the first event to the agent's commit."""
            out = {}
            for node in nodes:
                t0 = time.perf_counter()
                fn(node)
                node.settle(kind, lambda n=node: pred(n))
                out[node] = (time.perf_counter() - t0) * 1e3
            return dict(watch_ms=out[card], twin_watch_ms=out[twin])

        round_("boot")
        # a pod added through CNI and its object's ADDED event
        pid, labels, _ = k8s_pod(REMOTE_ADDED)
        ips = {node: node.cni("ADD", REMOTE_ADDED) for node in nodes}
        if ips[card] != ips[twin]:
            raise AssertionError("remote pod add: addresses differ")
        world.pods[pid] = (labels, ips[card])
        pod = km.Pod(name=pid.name, namespace=pid.namespace, labels=labels,
                     ip_address=ips[card], host_ip_address=K8S_NODE_IP)
        round_("pod add", watched(
            "pod add", lambda n: api_put(n.fake, pod, "ADDED"),
            lambda n: n.ksr.store.get("ksr/" + pod.key()) is not None))
        # a policy's ADDED event
        pol = k8s_policies()[AGENT_POLICIES]
        world.policies[(pol.namespace, pol.name)] = pol
        round_("policy add", watched(
            "policy add", lambda n: api_put(n.fake, pol, "ADDED"),
            lambda n: n.ksr.store.get("ksr/" + pol.key()) is not None))
        # an endpoints update the dropped stream hides: 410 Gone, then
        # the re-list must diff it in
        eps = k8s_endpoints(REMOTE_MOVED, gen=7)
        world.eps[REMOTE_MOVED] = eps
        path = "/api/v1/endpoints"
        lists = {node: node.fake.lists.get(path, 0) for node in nodes}

        def drop(node):
            api_put(node.fake, eps)
            node.fake.drop_stream(path)
        row = watched("endpoints re-list", drop, lambda n: n.ksr.store.get(
            "ksr/" + eps.key()) == eps.to_dict())
        for node in nodes:
            if node.fake.lists.get(path, 0) != lists[node] + 1:
                raise AssertionError("remote: the dropped stream did not "
                                     "re-list")
        round_("endpoints re-list", row)
        # the ML model: a corrupt artifact is refused (v1 keeps serving),
        # then a good v2 loads without a capture
        bad = model.with_suffix(".bad")
        bad.write_text("{ not a model")
        publish_artifact(model, bad)
        refused_ms = ml_tick(nodes, "corrupt", 1)
        for node in nodes:
            src = node.agent.ml_source.stats_snapshot()
            node.agent.stats.publish()
            text = node.agent.stats.registry.render("/stats")
            if not src["degraded"] or int(
                    node.agent.dataplane.tables.glb_ml_version) != 1 or \
                    sample(text, "vpp_tpu_degraded", component="ml") != 1:
                raise AssertionError(f"ml refusal: {src}")
        round_("ml refused", dict(refused_ms=refused_ms, serving_version=1))
        captures = dict(capture.capture_counts())
        train_ms["v2"] = train_artifact(model, seed + 1, 2)
        load_ms = ml_tick(nodes, "loaded", 2)
        for node in nodes:
            if int(node.agent.dataplane.tables.glb_ml_version) != 2 or \
                    node.agent.ml_source.degraded:
                raise AssertionError("ml v2 did not load")
        round_("ml v2", dict(load_ms=load_ms, trainer_ms=train_ms["v2"]))
        if dict(capture.capture_counts()) != captures:
            raise AssertionError("ml v2: a program was captured")
        ml = dict(train_ms=train_ms, refused_ms=refused_ms,
                  load_ms=load_ms, outcomes=card.agent.ml_source
                  .stats_snapshot()["outcomes"])
        say(f"remote ml: trainer v1 {train_ms['v1']:.0f} ms, v2 "
            f"{train_ms['v2']:.0f} ms (own process); corrupt artifact "
            f"refused in {refused_ms:.2f} ms (v1 kept serving, "
            f"vpp_tpu_degraded{{component=\"ml\"}} 1); v2 loaded in "
            f"{load_ms:.2f} ms with no capture; outcomes "
            f"{json.dumps(ml['outcomes'])}")

        # the CLI over the card's socket against the twin's
        cli = remote_cli(card, twin, world, REMOTE_CLI)
        round_("traced")
        cli.update(remote_cli(card, twin, world, ("show trace",)))
        if "Packet (frame" not in cli["show trace"][0]:
            raise AssertionError("cli: trace add 8 traced nothing")
        for (src, dst, port), want in zip(cli_pairs(world),
                                          ("DROPPED", "FORWARDED")):
            line = (f"test connectivity {world.pods[src][1]} "
                    f"{world.pods[dst][1]} tcp {port}")
            got = remote_cli(card, twin, world, (line,))
            verdict = got[line][0].splitlines()[-1]
            if not verdict.startswith(f"verdict: {want}"):
                raise AssertionError(f"cli {line}: {verdict}, the oracle "
                                     f"says {want}")
            cli.update(got)
        cli_ms = {line: ms for line, (_, ms) in cli.items()}
        say(f"remote cli: {len(cli)} commands through vpp-tpu-torch-ctl, "
            f"each equal to the twin's (but {sorted(REMOTE_CLI_DIFFERS)}); "
            f"round trip ms {json.dumps(cli_ms)}")

        # the card's node loses its store links: it serves its last
        # epoch, degraded; then both primaries die and their standbys
        # promote through the witnesses; the link heals onto the new
        # primary and a policy commits on both nodes
        for relay in card.pair.relays:
            relay.cut()
        t0 = time.monotonic()
        while not card.agent.store.degraded:
            if time.monotonic() - t0 > REMOTE_WAIT_S:
                raise AssertionError("the cut store link never degraded")
            time.sleep(0.005)
        from vpp_tpu_torch.cmd import ctl

        ctl_page = ctl.run_line(card.agent.config.cli_socket,
                                "show resilience", 60.0)
        page = ctl_page.splitlines()[0]
        if "kvstore (serving last-adopted epoch" not in page:
            raise AssertionError(f"show resilience while cut: {ctl_page}")
        card.agent.stats.publish()
        text = card.agent.stats.registry.render("/stats")
        if sample(text, "vpp_tpu_degraded", component="kvstore") != 1:
            raise AssertionError("the cut store link is not degraded{kvstore}")
        round_("store cut", dict(resilience=page))
        t_kill = time.perf_counter()
        for pair in pairs:
            pair.kill_primary()
        writable = {}
        while len(writable) < len(pairs):
            for i, pair in enumerate(pairs):
                if i not in writable and pair.writable():
                    writable[i] = (time.perf_counter() - t_kill) * 1e3
            if time.perf_counter() - t_kill > REMOTE_WAIT_S:
                raise AssertionError("no standby promoted")
            time.sleep(0.002)
        # the link to the standby heals; the dead primary's stays down
        # (a relay would accept on behalf of a server that is gone)
        t_heal = time.perf_counter()
        card.pair.relays[1].heal()
        card.settle("reconnect")
        reconnect_ms = (time.perf_counter() - t_heal) * 1e3
        pol = k8s_policies()[AGENT_POLICIES + 1]
        world.policies[(pol.namespace, pol.name)] = pol
        epochs = {node: node.agent.dataplane.epoch for node in nodes}
        row = watched(
            "failover policy add", lambda n: api_put(n.fake, pol, "ADDED"),
            lambda n: n.ksr.store.get("ksr/" + pol.key()) is not None)
        for node in nodes:
            if node.agent.dataplane.epoch == epochs[node]:
                raise AssertionError("failover: the policy did not commit")
            if node.pair.servers[1].store.fencing_epoch != 1:
                raise AssertionError(
                    f"failover: fencing epoch "
                    f"{node.pair.servers[1].store.fencing_epoch}")
        # the card's timeline: the cut held until both standbys were
        # writable, its reconnect, then the event to its commit
        commit_ms = ((t_heal - t_kill) * 1e3 + reconnect_ms
                     + row["watch_ms"])
        failover = dict(writable_ms=writable[0], twin_writable_ms=writable[1],
                        held_cut_ms=(t_heal - t_kill) * 1e3,
                        reconnect_ms=reconnect_ms,
                        policy_watch_ms=row["watch_ms"],
                        first_commit_ms=commit_ms)
        round_("failover policy add", row)
        say(f"remote failover: primary down -> standby writable "
            f"{writable[0]:.1f} ms (witness ttl {REMOTE_TTL_S} s; twin's "
            f"pair {writable[1]:.1f} ms); link healed -> card reconnected "
            f"{reconnect_ms:.1f} ms; policy event -> card commit "
            f"{row['watch_ms']:.1f} ms; primary down -> first commit on "
            f"the card {commit_ms:.1f} ms")
        # the commits over the remote store beside phase 4i's in-process
        commits = {k: v["watch_ms"] for k, v in rounds.items()
                   if "watch_ms" in v}
        say(f"remote commits (event to the card agent's commit, through "
            f"the fake API server, KSR, the store pair and the agent's "
            f"watch): {json.dumps(commits)}")
    finally:
        for node in nodes:
            node.close()
        for pair in pairs:
            pair.close()
        for fake in fakes:
            fake.close()
    # show run: per-stage device time of phase 4's dataplane
    from vpp_tpu_torch.trace import format_show_run, profile_stages

    show_run = {}
    for n in sorted({VEC, BIG_VEC}):
        vec = packet_vector_from_numpy(forward_traffic(n, up, seed + 17),
                                       gpu.device)
        rows = profile_stages(gpu, vec, now=clock[0], iters=REMOTE_RUNS)
        if [t.node for t in rows][-3:] != ["FUSED pipeline-step",
                                           "acl-classify-global-bv",
                                           "acl-classify-local-bv"]:
            raise AssertionError(f"show run rows {[t.node for t in rows]}")
        show_run[f"P={n}"] = {t.node: t.seconds_per_call * 1e6
                              for t in rows}
        say(f"show run P={n} (phase 4 dataplane: pallas rungs, LPM FIB; "
            f"CUDA events, us per call):")
        for line in format_show_run(rows).splitlines():
            say(f"  {line}")
    _sync(gpu.device)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    tmp.cleanup()
    for k in REMOTE_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"phase 4j: {k} never launched")
    summary = dict(rounds=rounds, ml=ml, failover=failover, cli_ms=cli_ms,
                   list_ms=list_ms, show_run_us=show_run,
                   launches=launches, seconds=time.perf_counter() - t_phase)
    say(f"phase 4j: {summary['seconds']:.1f} s; launches {launches}")
    return summary, launches


# --- phase 4k: the node's wire -----------------------------------------

WIRE_PODS = tuple(range(0, AGENT_PODS, 7))  # the 16 pods with a socket
WIRE_CHUNK = 128       # frames sent from one socket before the wait
WIRE_DEADLINE = 60.0   # the longest a chunk may take to be accounted
WIRE_IP_LEN = 512      # every frame's IPv4 total length (pkt_len)
WIRE_KERNELS = ("sess_probe_ways", "bv_first_set", "lpm_fused_lookup")
WIRE_DENY = ("ns4", "wire-deny", "cache", 22)  # ns, name, app, its port
WIRE_NOW = 600_000     # the pinned step clock (past phase 4i's)
WIRE_VXLAN = 50        # outer Ethernet + IPv4 + UDP + VXLAN bytes


def wire_config(cfg: DataplaneConfig, root: Path, card: bool) -> AgentConfig:
    """Phase 4k's node: phase 4i's with the FIB pinned to the LPM kernel
    rung and the packet rings on; the card's rings in shared memory, its
    IO plan file and the daemon's control socket (the twin's rings are
    in process, its daemon an in-process ``IODaemon``)."""
    c = agent_config(cfg, root, card, io=True)
    c.dataplane = c.dataplane._replace(fib_impl="pallas")
    if card:
        c.io = dataclasses.replace(
            c.io, shm_name=f"vpp_tpu_torch_wire_{root.name}",
            plan_path=str(root / "io-plan.json"),
            control_socket=str(root / "io-ctl.sock"))
    return c


def wire_pair():
    """One interface's socketpair: (the daemon's end, the wire's end)."""
    import socket

    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
    for s in (a, b):
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    b.setblocking(True)
    return a, b


def pod_mac(ip: int) -> bytes:
    return b"\x02\x00" + int(ip).to_bytes(4, "big")


def wire_frame(src: int, dst: int, sport: int, dport: int, fid: int,
               dmac: bytes = b"\x02\xfe\x00\x00\x00\x01") -> bytes:
    """Ethernet + IPv4 (total length ``WIRE_IP_LEN``, a valid header
    checksum) + TCP whose sequence number is the frame's id."""
    import struct

    hdr = struct.pack("!BBHHHBBH4s4s", 0x45, 0, WIRE_IP_LEN, fid & 0xFFFF,
                      0x4000, 64, 6, 0, int(src).to_bytes(4, "big"),
                      int(dst).to_bytes(4, "big"))
    s = sum(struct.unpack("!10H", hdr))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    hdr = hdr[:10] + struct.pack("!H", ~s & 0xFFFF) + hdr[12:]
    tcp = struct.pack("!HHIIBBHHH", sport, dport, fid, 0, 5 << 4, 0x10,
                      8192, 0, 0)
    return (dmac + pod_mac(src) + b"\x08\x00" + hdr + tcp
            + bytes(WIRE_IP_LEN - 40))


def frame_key(raw: bytes):
    """(src, dst, sport, dport, id) of a frame's (inner) IPv4 / TCP
    header, and whether it came VXLAN-encapsulated."""
    off = 0
    if raw[23] == 17 and int.from_bytes(raw[36:38], "big") == 4789:
        off = WIRE_VXLAN
    ip = raw[off + 14:off + 34]
    l4 = raw[off + 34:off + 42]
    return (int.from_bytes(ip[12:16], "big"), int.from_bytes(ip[16:20], "big"),
            int.from_bytes(l4[0:2], "big"), int.from_bytes(l4[2:4], "big"),
            int.from_bytes(l4[4:8], "big"), bool(off))


class WireEnd:
    """One node's wire: a socketpair per interface (the daemon's end and
    the end the phase plays), a thread receiving from every wire end,
    the daemon's counters (``stats``: a callable) and the agent's pump
    (its ICMP errors and its drop counters)."""

    def __init__(self, names, stats, pump):
        import threading

        self.pairs = {w: wire_pair() for w in names}
        self.names = {b.fileno(): w for w, (_a, b) in self.pairs.items()}
        self.stats = stats
        self.pump = pump
        self.got = {w: [] for w in names}
        self.sent_at = {}
        self.chunk_s = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._recv, daemon=True,
                                        name="wire-recv")
        self._thread.start()

    def _recv(self) -> None:
        import select

        socks = [b for _a, b in self.pairs.values()]
        while not self._stop.is_set():
            ready, _, _ = select.select(socks, [], [], 0.05)
            for s in ready:
                s.setblocking(False)
                try:
                    while True:
                        raw = s.recv(65535)
                        self.got[self.names[s.fileno()]].append(
                            (time.perf_counter(), raw))
                except BlockingIOError:
                    pass
                s.setblocking(True)

    def received(self) -> int:
        return sum(len(v) for v in self.got.values())

    def counters(self) -> dict:
        """``taken``: frames the daemon took off its sockets (pushed to
        the rx ring, or dropped on a full one: ``rx_full``); ``out``:
        packets the tx side accounted for (sent, dropped, punted,
        truncated) and those the pump lost; ``icmp``: the pump's ICMP
        errors, which enter the tx ring too."""
        s = self.stats()
        ps = self.pump.stats
        lost = sum(ps.get(k, 0) for k in PUMP_DROP_KEYS
                   if k != "drops_tenant_quota")  # a verdict, not a loss
        return dict(taken=s["rx_pkts"] + s["drops_rx_full"],
                    rx=s["rx_pkts"], rx_full=s["drops_rx_full"],
                    out=s["tx_pkts"] + s["tx_drops"] + s["tx_punts"]
                    + s["trunc_drops"] + lost, lost=lost, tx=s["tx_pkts"],
                    icmp=ps.get("icmp_errors", 0))

    @staticmethod
    def accounted(base: dict, c: dict, n: int) -> bool:
        return (c["taken"] - base["taken"] == n
                and c["out"] - base["out"]
                == c["rx"] - base["rx"] + c["icmp"] - base["icmp"])

    def push(self, wire: str, frames) -> None:
        """Send ``frames`` from ``wire``; wait until the daemon received
        every one and its tx counters account for each (and for every
        ICMP error the pump made meanwhile)."""
        base = self.counters()
        t0 = time.perf_counter()
        sock = self.pairs[wire][1]
        for fid, raw in frames:
            self.sent_at[fid] = time.perf_counter()
            sock.send(raw)
        deadline = t0 + WIRE_DEADLINE
        while True:
            c = self.counters()
            if self.accounted(base, c, len(frames)):
                if c["rx_full"] != base["rx_full"] or c["lost"] != base[
                        "lost"]:
                    raise AssertionError(f"wire {wire}: frames lost in a "
                                         f"chunk: {base} -> {c}")
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"wire {wire}: {len(frames)} frames "
                                     f"sent, counters {base} -> {c}")
            # each poll of the card's daemon is a control-socket round
            # trip served beside its rx and tx threads: not too often
            time.sleep(0.002)
        self.chunk_s.append((len(frames), time.perf_counter() - t0))

    def blast(self, sends) -> dict:
        """Every frame of ``sends`` at once, the sockets in turn one
        frame each, then the wait until the daemon accounted for all:
        the delivered rate and latency of a backlog."""
        base = self.counters()
        n0 = self.received()
        queues = {w: list(v) for w, v in sends.items()}
        total = sum(len(v) for v in queues.values())
        t0 = time.perf_counter()
        while queues:
            for w in list(queues):
                fid, raw = queues[w].pop(0)
                self.sent_at[fid] = time.perf_counter()
                self.pairs[w][1].send(raw)
                if not queues[w]:
                    del queues[w]
        deadline = time.perf_counter() + WIRE_DEADLINE
        while True:
            c = self.counters()
            if self.accounted(base, c, total):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"wire blast: {total} frames sent, "
                                     f"counters {base} -> {c}")
            time.sleep(0.002)
        self.settle(n0 + c["tx"] - base["tx"])
        times = [t for got in self.got.values() for t, raw in got
                 if self.sent_at.get(frame_key(raw)[4], 1e30) >= t0]
        lat = [t - self.sent_at[frame_key(raw)[4]] for got in
               self.got.values() for t, raw in got
               if self.sent_at.get(frame_key(raw)[4], 1e30) >= t0]
        span = max(times) - t0
        lat_us = np.asarray(lat) * 1e6
        return dict(sent=total, delivered=len(times),
                    not_delivered=total - len(times),
                    rx_full=c["rx_full"] - base["rx_full"],
                    pump_lost=c["lost"] - base["lost"],
                    span_s=span, mpps=len(times) / span / 1e6,
                    latency_us=dict(p50=float(np.percentile(lat_us, 50)),
                                    p99=float(np.percentile(lat_us, 99))))

    def settle(self, want_tx: int) -> None:
        """Wait until the wire ends hold every frame the daemon sent."""
        deadline = time.perf_counter() + WIRE_DEADLINE
        while self.received() < want_tx:
            if time.perf_counter() > deadline:
                raise AssertionError(f"wire: {self.received()} of "
                                     f"{want_tx} frames reached the wire")
            time.sleep(0.001)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        for a, b in self.pairs.values():
            a.close()
            b.close()


def wire_compare(ends, marks, what: str) -> dict:
    """The frames each wire end received since ``marks``: equal on both
    nodes as a multiset per socket, byte for byte but for the Ethernet
    source MAC (each daemon's transport MAC, which a daemon process
    draws at random: it must be one value per socket)."""
    out = {}
    per = {}
    for side, end in ends.items():
        rows = {}
        for w, got in end.got.items():
            frames = [raw for _t, raw in got[marks[side][w]:]]
            macs = {raw[6:12] for raw in frames}
            if len(macs) > 1:
                raise AssertionError(f"{what}: {side} socket {w} sent from "
                                     f"{len(macs)} MACs")
            rows[w] = sorted(raw[:6] + raw[12:] for raw in frames)
        per[side] = rows
    for w in per["card"]:
        if per["card"][w] != per["twin"][w]:
            raise AssertionError(
                f"{what}: socket {w} received {len(per['card'][w])} frames "
                f"on the card, {len(per['twin'][w])} from the twin, or "
                f"other bytes")
        if per["card"][w]:
            out[w] = len(per["card"][w])
    return out


def wire_traffic(rng, node: AgentNode, world: K8sWorld, wired, r: int,
                 fid0: int, vtep: int):
    """A round's 4,096 frames by ingress socket: half pod to pod between
    the wired pods, a quarter from them to the cluster IPs, a quarter
    from the uplink (phase 4i's uplink mix; a quarter of those are VXLAN
    frames from the peer nodes' VTEPs, from their pods: the replies
    leave encapsulated). Returns ({wire: [(id, bytes)]}, the pod-to-pod
    frames as (id, src pod, dst pod, port), the next frame id)."""
    agent = node.agent
    pids = [k8s_pod(i)[0] for i in wired]
    name = {p: f"pod{i}" for p, i in zip(pids, wired)}
    ip = {p: ip4(world.pods[p][1]) for p in pids}
    n = BIG_VEC
    a = rng.integers(0, len(pids), n // 2)
    b = (a + rng.integers(1, len(pids), n // 2)) % len(pids)
    ports = np.array(K8S_PORTS)[rng.integers(0, len(K8S_PORTS), n // 2)]
    svcs = sorted(world.services)
    vips = [ip4(world.services[svcs[j]].cluster_ip)
            for j in rng.integers(0, len(svcs), n // 4)]
    c = rng.integers(0, len(pids), n // 4)
    up, _ = k8s_uplink_traffic(rng, n // 4, agent.uplink_if, world,
                               str(agent.ipam.node_ip_address()))
    # the peers hold node ids 2..16 (the card is 1): their VTEPs and a
    # pod of each
    peers = [(ip4(str(agent.ipam.vxlan_ip_address(k + 2))),
              ip4(str(agent.ipam.other_node_pod_network(k + 2)[10 + k])))
             for k in range(AGENT_PEERS)]
    codec = PacketCodec()
    sends = {}
    pairs = []
    fid = fid0
    sport0 = 20000 + r * n
    for k in range(n // 2):
        sp, dp_ = pids[a[k]], pids[b[k]]
        sends.setdefault(name[sp], []).append(
            (fid, wire_frame(ip[sp], ip[dp_], sport0 + k, int(ports[k]),
                             fid)))
        pairs.append((fid, sp, dp_, int(ports[k])))
        fid += 1
    for k in range(n // 4):
        sp = pids[c[k]]
        sends.setdefault(name[sp], []).append(
            (fid, wire_frame(ip[sp], vips[k], sport0 + n // 2 + k, 80, fid)))
        fid += 1
    for k in range(n // 4):
        peer, peer_pod = peers[k % len(peers)]
        src = peer_pod if k % 4 == 3 else int(up["src_ip"][k])
        raw = wire_frame(src, int(up["dst_ip"][k]), int(up["sport"][k]),
                         int(up["dport"][k]), fid)
        if k % 4 == 3:
            arr = np.frombuffer(raw, np.uint8)
            raw = codec.encap(np.ascontiguousarray(arr), len(raw), peer,
                              vtep, 49152 + k, 10, pod_mac(peer),
                              b"\x02\xfe\x00\x00\x00\x01")
        sends.setdefault("uplink", []).append((fid, raw))
        fid += 1
    return sends, pairs, fid


def wire_replies(end: WireEnd, marks, vtep: int, fid0: int):
    """The replies of the frames each wire end received since ``marks``
    (the twin's, equal to the card's), each from the socket its forward
    frame left by: endpoints swapped; a VXLAN frame's reply comes back
    encapsulated from the VTEP it was sent to. ICMP errors get none."""
    codec = PacketCodec()
    sends = {}
    fid = fid0
    for w, got in end.got.items():
        for _t, raw in got[marks[w]:]:
            if raw[WIRE_VXLAN + 23 if frame_key(raw)[5] else 23] != 6:
                continue  # an ICMP error the pump made: no reply
            src, dst, sport, dport, _id, encap = frame_key(raw)
            rep = wire_frame(dst, src, dport, sport, fid)
            if encap:
                peer = int.from_bytes(raw[30:34], "big")
                arr = np.frombuffer(rep, np.uint8)
                rep = codec.encap(np.ascontiguousarray(arr), len(rep), peer,
                                  vtep, 49152 + (fid & 0x3FFF), 10,
                                  pod_mac(peer), b"\x02\xfe\x00\x00\x00\x01")
            sends.setdefault(w, []).append((fid, rep))
            fid += 1
    return sends, fid


def wire_phase(cfg: DataplaneConfig, seed: int, device=None):
    """Phase 4k (i) (module doc). ``device`` "cpu" rehearses the phase
    with both nodes on the CPU. Returns (summary, launches)."""
    import os
    import signal

    from vpp_tpu_torch.cmd.init_main import InitSupervisor
    from vpp_tpu_torch.io.control import IOControlClient
    from vpp_tpu_torch.io.daemon import IODaemon
    from vpp_tpu_torch.io.transport import SocketPairTransport

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_wire_")
    root = Path(tmp.name)
    (root / "card").mkdir()
    (root / "twin").mkdir()
    clock = [WIRE_NOW]
    card_cfg = wire_config(cfg, root / "card", True)
    card = AgentNode(card_cfg, clock, device=device)
    twin = AgentNode(wire_config(cfg, root / "twin", False), clock,
                     device="cpu")
    nodes = (card, twin)
    dev = card.agent.dataplane.device
    procs = []
    ends = {}
    twin_daemon = None
    try:
        world = K8sWorld([])
        world.pods = {}
        world.policies = dict(list(world.policies.items())[:AGENT_POLICIES])
        for node in nodes:
            for ns in world.namespaces():
                node.reflect("Namespace", ns.name, ns)
        # the pods through the CNI server, config only (no netns: the
        # wired pods' interfaces are the daemon's socketpairs)
        for i in range(AGENT_PODS):
            pid, labels, _ = k8s_pod(i)
            req = CNIRequest(container_id=f"c-pod{i}", netns="",
                             if_name="eth0",
                             extra_args={"K8S_POD_NAMESPACE": pid.namespace,
                                         "K8S_POD_NAME": pid.name})
            ips = []
            for node in nodes:
                reply = node.agent.cni_server.add(req)
                if reply.result != 0:
                    raise AssertionError(f"wire cni pod{i}: {reply}")
                ips.append(reply.interfaces[0].ip_addresses[0]
                           .address.split("/")[0])
            if ips[0] != ips[1]:
                raise AssertionError(f"wire cni pod{i}: addresses differ")
            world.pods[pid] = (labels, ips[0])
        if card.agent.dataplane.pod_if != twin.agent.dataplane.pod_if:
            raise AssertionError("wire cni: interfaces differ")
        for node in nodes:
            for pod in world.pod_objects():
                node.reflect("Pod", f"{pod.namespace}/{pod.name}", pod)
            for s in sorted(world.services):
                svc = world.services[s]
                node.reflect("Service", f"{svc.namespace}/{svc.name}", svc)
                node.reflect("Endpoints", f"{svc.namespace}/{svc.name}",
                             world.eps[s])
            node.publish_peers()
            for pol in world.policies.values():
                node.reflect("Policy", f"{pol.namespace}/{pol.name}", pol)
        rungs = {n: agent_rungs(n.agent.dataplane) for n in nodes}
        if rungs[card] != rungs[twin] or rungs[card]["fib"] != "pallas":
            raise AssertionError(f"wire rungs {rungs[card]} {rungs[twin]}")
        plan = json.loads(Path(card_cfg.io.plan_path).read_text())
        vtep, vni = int(plan["vtep"]), int(plan["vni"])
        # the wires: the uplink and the 16 wired pods, on each node
        names = ["uplink"] + [f"pod{i}" for i in WIRE_PODS]
        dp = card.agent.dataplane
        if_of = {"uplink": card.agent.uplink_if}
        for i in WIRE_PODS:
            if_of[f"pod{i}"] = dp.pod_if[k8s_pod(i)[0]]
        ctl = IOControlClient(card_cfg.io.control_socket, timeout=5.0)

        def ctl_stats():
            while True:
                try:
                    return ctl.stats()
                except OSError:  # the daemon binds its socket at start
                    time.sleep(0.005)

        ends["card"] = WireEnd(names, ctl_stats, card.agent.io_pump)
        specs = [f"--if={if_of[w]}:fd:{ends['card'].pairs[w][0].fileno()}"
                 for w in names]
        fds = [ends["card"].pairs[w][0].fileno() for w in names]

        def spawn(argv):
            p = subprocess.Popen(argv + specs, pass_fds=fds,
                                 cwd=str(Path(__file__).resolve().parent))
            procs.append(p)
            return p

        sup = InitSupervisor(card_cfg, None, spawn=spawn, plan_timeout_s=30)
        t0 = time.perf_counter()
        if not sup._spawn_io():
            raise AssertionError("wire: no IO plan from the card agent")
        ctl_stats()
        daemon_boot_ms = (time.perf_counter() - t0) * 1e3
        pid = sup.procs["io"].pid
        maps = Path(f"/proc/{pid}/maps").read_text()
        if "libcuda" in maps or "libtorch" in maps:
            raise AssertionError("wire: the daemon process mapped "
                                 "torch or the CUDA driver")
        ta = twin.agent
        tw = ends["twin"] = WireEnd(
            names, lambda: dict(twin_daemon.stats), ta.io_pump)
        tw_transports = {if_of[w]: SocketPairTransport(tw.pairs[w][0], w)
                         for w in names}

        def twin_io():
            """The twin's daemon, in process, and the wired pods' static
            MACs on both (as VethPodWirer pins them at a wire and
            re-pins them at a re-attach: a new daemon's neighbour
            table starts empty)."""
            d = IODaemon(ta.io_rings, tw_transports, uplink_if=ta.uplink_if,
                         host_if=ta.host_if, vtep_ip=vtep, vni=vni).start()
            for i in WIRE_PODS:
                pip = ip4(world.pods[k8s_pod(i)[0]][1])
                ctl.set_mac(pip, pod_mac(pip))
                d.set_static_mac(pip, pod_mac(pip))
            return d

        twin_daemon = twin_io()
        say(f"wire boot: daemon process {pid} serving in "
            f"{daemon_boot_ms:.1f} ms from the plan ({' '.join(sup.io_argv(plan)[1:])} "
            f"+ {len(specs)} --if fd specs); no torch, no CUDA driver mapped")

        for w in WRAPPERS.values():
            w.launches = 0
        rounds = {}
        fid = 1
        lat = []

        def run_round(kind: str, sends, pairs=None, old=None):
            marks = {s: {w: len(e.got[w]) for w in names}
                     for s, e in ends.items()}
            base = {s: e.counters() for s, e in ends.items()}
            for w in sorted(sends):
                frames = sends[w]
                for o in range(0, len(frames), WIRE_CHUNK):
                    for side in ("card", "twin"):
                        ends[side].push(w, frames[o:o + WIRE_CHUNK])
            for side, e in ends.items():
                c = e.counters()
                e.settle(sum(marks[side].values()) + c["tx"]
                         - base[side]["tx"])
            counts = wire_compare(ends, marks, f"wire {kind}")
            sent = sum(len(v) for v in sends.values())
            c0, c1 = base["card"], ends["card"].counters()
            got = sum(counts.values())
            if got != c1["tx"] - c0["tx"] or c1["rx"] - c0["rx"] != sent:
                raise AssertionError(f"wire {kind}: {sent} sent, {got} "
                                     f"received, counters {c0} -> {c1}")
            # the pod-to-pod verdicts against the NetworkPolicy oracle
            seen = {}
            for w, got_w in ends["card"].got.items():
                for t, raw in got_w[marks["card"][w]:]:
                    k = frame_key(raw)
                    seen[k[4]] = w
                    if k[4] in ends["card"].sent_at:
                        lat.append(t - ends["card"].sent_at[k[4]])
            denied = cut = 0
            for f, sp, dp_, port in pairs or ():
                want = world.allowed(sp, dp_, port)
                where = seen.get(f)
                if want != (where == f"pod{int(dp_.name[3:])}"):
                    raise AssertionError(
                        f"wire {kind}: {sp} -> {dp_}:{port} oracle "
                        f"{'allow' if want else 'deny'}, left on {where}")
                denied += not want
                if old is not None and not want and old(sp, dp_, port):
                    cut += 1
            row = dict(sent=sent, received=got, by_socket=counts,
                       pod_to_pod=len(pairs or ()),
                       pod_denied=denied, icmp=c1["icmp"] - c0["icmp"])
            if old is not None:
                row["cut_by_the_deny"] = cut
            return row, marks

        rng = np.random.default_rng(seed + 14)
        sends, pairs, fid = wire_traffic(rng, twin, world, WIRE_PODS, 0,
                                         fid, vtep)
        s0 = ctl_stats()
        rounds["forward"], marks = run_round("forward", sends, pairs)
        replies, fid = wire_replies(ends["twin"], marks["twin"], vtep, fid)
        rounds["replies"], _ = run_round("replies", replies)
        # a deny: ns4's cache pods take TCP 22 only
        ns, pname, app, port = WIRE_DENY
        old_pols = list(world.policies.values())
        pol = _policy(ns, pname, app, [_peer_pods(ns_env="")], [port])
        world.policies[(ns, pname)] = pol
        for node in nodes:
            node.reflect("Policy", f"{ns}/{pname}", pol)
        s1 = ctl_stats()
        # the daemon dies (SIGKILL) and comes back from its plan, as the
        # supervisor's respawn does: it must attach to the same rings
        killed = sup.procs["io"]
        t_kill = time.perf_counter()
        os.kill(killed.pid, signal.SIGKILL)
        if killed.wait(timeout=30) != -signal.SIGKILL:
            raise AssertionError("wire: the daemon outlived SIGKILL")
        sup._respawn_one_io("io")
        if sup.procs["io"] is killed:
            raise AssertionError("wire: the supervisor did not respawn")
        ctl_stats()
        # the twin's daemon restarts at the same point: both neighbour
        # tables start again from the pinned pods
        if not twin_daemon.stop():
            raise AssertionError("wire: the twin's daemon did not stop")
        twin_daemon = twin_io()
        labels = {p: lab for p, (lab, _ip) in world.pods.items()}
        nsl = {f"ns{k}": k8s_ns_labels(k) for k in range(K8S_NAMESPACES)}

        def old(sp, dp_, prt):
            return k8s_allowed(old_pols, None, labels, sp, dp_, prt, nsl,
                               world.pods[sp][1])

        sends, pairs, fid = wire_traffic(rng, twin, world, WIRE_PODS, 2,
                                         fid, vtep)
        first = min(min(f for f, _ in v) for v in sends.values())
        rounds["forward after deny"], marks = run_round(
            "forward after deny", sends, pairs, old)
        firsts = [t for got in ends["card"].got.values()
                  for t, raw in got[0:] if frame_key(raw)[4] >= first]
        respawn_ms = (min(firsts) - t_kill) * 1e3
        if rounds["forward after deny"]["cut_by_the_deny"] <= 0:
            raise AssertionError("wire: the deny cut no frame")
        # a backlog on the card alone (the twin has done its part): fresh
        # pod-to-pod flows the oracle allows, every socket at once
        pids = [k8s_pod(i)[0] for i in WIRE_PODS]
        blast = {}
        for k in range(BIG_VEC):
            a, b = rng.choice(len(pids), 2, replace=False)
            port = int(rng.choice(K8S_PORTS))
            if not world.allowed(pids[a], pids[b], port):
                continue
            blast.setdefault(f"pod{WIRE_PODS[a]}", []).append((fid, wire_frame(
                ip4(world.pods[pids[a]][1]), ip4(world.pods[pids[b]][1]),
                60000 - k % 5000, port, fid)))
            fid += 1
        steady = ends["card"].blast(blast)
        _sync(dev)
        launched = {k: WRAPPERS[k].launches for k in WIRE_KERNELS}
        if device is None and any(v <= 0 for v in launched.values()):
            raise AssertionError(f"wire: launches {launched}")
        s2 = ctl_stats()
        daemon = {k: (s1[k] - s0[k]) + s2[k] for k in (
            "rx_pkts", "tx_pkts", "tx_drops", "tx_punts", "trunc_drops",
            "vxlan_encap", "vxlan_decap", "drops_rx_full", "rx_ring_waits")}
        # the rx_full drop cause on the card's /stats reads the daemon's
        card.agent.stats._daemon_retry_at = 0.0
        card.agent.maintenance_tick()
        text = http_get(card.agent.stats_http.port, "/stats")
        rx_full = sample(text, "vpp_tpu_pump_drops_total", reason="rx_full")
        want_rx_full = (card.agent.io_pump.stats["drops_rx_full"]
                        + s2["drops_rx_full"])
        if rx_full != want_rx_full:
            raise AssertionError(f"wire: rx_full {rx_full} on /stats, "
                                 f"{want_rx_full} counted")
        pump_drops = {k: card.agent.io_pump.stats.get(k, 0)
                      for k in PUMP_DROP_KEYS}
        frames = sum(n for n, _ in ends["card"].chunk_s)
        busy = sum(s for _, s in ends["card"].chunk_s)
        lat_us = np.asarray(lat) * 1e6
        summary = dict(
            rounds=rounds, daemon=daemon, pump_drops=pump_drops,
            backlog=steady,
            rx_full=rx_full, daemon_boot_ms=daemon_boot_ms,
            respawn_ms=respawn_ms, frames=frames, chunk_s=busy,
            mpps=frames / busy / 1e6,
            latency_us=dict(p50=float(np.percentile(lat_us, 50)),
                            p99=float(np.percentile(lat_us, 99)),
                            n=int(lat_us.size)),
            launches=launched)
        for kind, row in rounds.items():
            say(f"wire round {kind}: {json.dumps(row)}")
        say(f"wire daemon: {json.dumps(daemon)}; pump drops "
            f"{json.dumps(pump_drops)}; /stats rx_full {rx_full:g}")
        say(f"wire: {frames} frames in chunks of {WIRE_CHUNK} from one "
            f"socket at a time, each waited for until the daemon "
            f"accounted for it: {summary['mpps']:.4f} Mpps through the "
            f"daemon process ({busy:.3f} s in chunks); frame latency "
            f"socket to socket p50 {summary['latency_us']['p50']:.1f} us, "
            f"p99 {summary['latency_us']['p99']:.1f} us over "
            f"{lat_us.size} frames; respawn (SIGKILL to the first frame "
            f"through the new daemon) {respawn_ms:.1f} ms")
        say(f"wire backlog: {steady['sent']} frames of allowed pod-to-pod "
            f"flows from the 16 pod sockets at once: {steady['delivered']} "
            f"delivered in {steady['span_s'] * 1e3:.1f} ms, "
            f"{steady['mpps']:.4f} Mpps wire to wire; latency p50 "
            f"{steady['latency_us']['p50']:.1f} us, p99 "
            f"{steady['latency_us']['p99']:.1f} us; "
            f"{steady['not_delivered']} not delivered (rx_full "
            f"{steady['rx_full']}, lost in the pump {steady['pump_lost']})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=30)
        if twin_daemon is not None:
            twin_daemon.stop()
        for e in ends.values():
            e.close()
        card.close()
        twin.close()
    _sync(dev)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    tmp.cleanup()
    summary["seconds"] = time.perf_counter() - t_phase
    say(f"phase 4k (i): {summary['seconds']:.1f} s; launches {launches}")
    return summary, launches


WIRE_KERNEL_PODS = 8           # pods the kernel-interface part adds
WIRE_KERNEL_NS = "vpptk-pod"   # their netns: vpptk-pod0 .. vpptk-pod7
# the part's own subnets: the host interconnect routes them in the host
WIRE_KERNEL_IPAM = {"pod_subnet_cidr": "10.71.0.0/16",
                    "vpp_host_subnet_cidr": "172.29.0.0/16",
                    "service_cidr": "10.112.0.0/12"}


def ip_probe() -> str | None:
    """None where ``ip netns add`` succeeds, else why it failed."""
    import os

    name = f"vpptk-probe{os.getpid()}"
    try:
        r = subprocess.run(["ip", "netns", "add", name], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if r.returncode != 0:
        return r.stderr.strip() or f"rc {r.returncode}"
    subprocess.run(["ip", "netns", "del", name], capture_output=True,
                   timeout=30)
    return None


def in_netns(ns, code: str, timeout: float = 60.0, wait: bool = True):
    """Python ``code`` in netns ``ns`` (the host's with ``ns`` None)."""
    argv = [sys.executable, "-c", code]
    if ns is not None:
        argv = ["ip", "netns", "exec", ns] + argv
    if not wait:
        return subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    return subprocess.run(argv, capture_output=True, text=True,
                          timeout=timeout)


def udp_delivered(ns_from, ns_to, dst: str, port: int, tries: int = 20):
    """UDP datagrams from ``ns_from`` to ``dst``:``port`` in ``ns_to``
    until one arrives or ``tries`` were sent: True if one arrived."""
    recv = in_netns(ns_to, (
        "import socket\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
        f"s.bind(('0.0.0.0', {port}))\n"
        "print('bound', flush=True)\n"
        f"s.settimeout({0.1 * tries + 2})\n"
        "try:\n"
        "    print(s.recvfrom(4096)[0].decode(), flush=True)\n"
        "except OSError:\n"
        "    print('none', flush=True)\n"), wait=False)
    if recv.stdout.readline().strip() != "bound":
        raise AssertionError(f"wire kernel: receiver {recv.stderr.read()}")
    in_netns(ns_from, (
        "import socket, time\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
        f"for _ in range({tries}):\n"
        f"    s.sendto(b'wire', ('{dst}', {port}))\n"
        "    time.sleep(0.1)\n"))
    out, _ = recv.communicate(timeout=60)
    return "wire" in out


def tcp_exchange(ns_from, ns_to, dst: str, port: int) -> bool:
    srv = in_netns(ns_to, (
        "import socket\n"
        "ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
        "ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)\n"
        f"ls.bind(('0.0.0.0', {port}))\n"
        "ls.listen(4)\n"
        "print('bound', flush=True)\n"
        "ls.settimeout(30)\n"
        "c, _ = ls.accept()\n"
        "c.sendall(b'pong:' + c.recv(64))\n"), wait=False)
    try:
        if srv.stdout.readline().strip() != "bound":
            raise AssertionError(f"wire kernel: server {srv.stderr.read()}")
        cli = in_netns(ns_from, (
            "import socket\n"
            "s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
            "s.settimeout(20)\n"
            f"s.connect(('{dst}', {port}))\n"
            "s.sendall(b'wire')\n"
            "print(s.recv(64).decode(), flush=True)\n"))
        return "pong:wire" in cli.stdout
    finally:
        srv.kill()
        srv.wait(timeout=30)


def ping(ns, dst: str, count: int) -> int:
    """ICMP echo requests on a raw socket from ``ns``: replies counted."""
    res = in_netns(ns, (
        "import os, socket, struct, time\n"
        "def csum(b):\n"
        "    s = sum(struct.unpack('>%dH' % (len(b) // 2), b))\n"
        "    s = (s & 0xFFFF) + (s >> 16)\n"
        "    return ~((s & 0xFFFF) + (s >> 16)) & 0xFFFF\n"
        "ident = os.getpid() & 0xFFFF\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_RAW,\n"
        "                  socket.IPPROTO_ICMP)\n"
        "s.settimeout(2)\n"
        "got = 0\n"
        f"for seq in range({count}):\n"
        "    pay = b'vpp-tpu-torch-wire'\n"
        "    hdr = struct.pack('>BBHHH', 8, 0, 0, ident, seq)\n"
        "    s.sendto(struct.pack('>BBHHH', 8, 0, csum(hdr + pay), ident,\n"
        f"                         seq) + pay, ('{dst}', 0))\n"
        "    end = time.monotonic() + 2\n"
        "    while time.monotonic() < end:\n"
        "        try:\n"
        "            d, peer = s.recvfrom(4096)\n"
        "        except OSError:\n"
        "            break\n"
        "        h = (d[0] & 0xF) * 4\n"
        "        t, _, _, i, q = struct.unpack('>BBHHH', d[h:h + 8])\n"
        f"        if t == 0 and i == ident and q == seq and peer[0] == '{dst}':\n"
        "            got += 1\n"
        "            break\n"
        "print(got, flush=True)\n"))
    return int(res.stdout.strip() or 0)


def wire_kernel_phase(cfg: DataplaneConfig, seed: int, spawn=None) -> dict:
    """Phase 4k (ii) (module doc): where ``ip netns add`` succeeds, the
    node on kernel interfaces, booted by the init supervisor (the agent
    and the IO daemon as processes; ``spawn`` starts them, Popen by
    default); elsewhere the line says why it did not run."""
    import os

    from vpp_tpu_torch.cmd.init_main import InitSupervisor
    from vpp_tpu_torch.cni.wiring import host_ifname
    from vpp_tpu_torch.health.stn import STNDaemon, Watchdog
    from vpp_tpu_torch.health.stn_netlink import LinuxNetlink
    from vpp_tpu_torch.kvstore.server import KVServer

    why = ip_probe()
    if why is not None:
        say(f"wire kernel: not permitted ({why})")
        return {"ran": False, "reason": why}
    say("wire kernel: ran")
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_wirek_")
    root = Path(tmp.name)
    nss = [f"{WIRE_KERNEL_NS}{k}" for k in range(WIRE_KERNEL_PODS)]
    ip_ = lambda *a: subprocess.run(  # noqa: E731
        ["ip", *a], capture_output=True, text=True, timeout=30)
    for ns in nss:
        ip_("netns", "del", ns)
        if ip_("netns", "add", ns).returncode:
            raise AssertionError(f"wire kernel: netns {ns}")
    kv = KVServer(host="127.0.0.1", port=0).start()
    dp = cfg._replace(classifier="auto", fastpath=True, fib_impl="pallas",
                      session_impl="auto", nat_mappings=K8S_NAT_MAPPINGS,
                      max_ifaces=128)
    conf = {"node_name": K8S_NODE, "serve_http": True, "stats_port": 0,
            "health_port": 0, "http_host": "127.0.0.1",
            "store_url": f"tcp://127.0.0.1:{kv.port}",
            "cni_socket": str(root / "cni.sock"),
            "ipam": WIRE_KERNEL_IPAM, "dataplane": dp._asdict(),
            "io": {"enabled": True, "pump_mode": "dispatch",
                   "snap": PUMP_SNAP, "shm_name": f"vpptk_{os.getpid()}",
                   "plan_path": str(root / "io-plan.json"),
                   "control_socket": str(root / "io-ctl.sock"),
                   "host_interconnect": True}}
    path = root / "agent.yaml"
    path.write_text(json.dumps(conf))
    from vpp_tpu_torch.cmd.config import load_config

    sup = InitSupervisor(load_config(str(path)), str(path), spawn=spawn,
                         plan_timeout_s=300.0)
    ksr = None
    out = {"ran": True}
    pods = {}
    try:
        t0 = time.perf_counter()
        sup.start()
        ksr = KsrAgent(store_url=f"tcp://127.0.0.1:{kv.port}",
                       serve_http=False)
        ksr.start()
        for ns in K8sWorld([]).namespaces():
            ksr.sources[km.Namespace.TYPE].add(ns.name, ns)
        conf_cni = {"cniVersion": cni_shim.CNI_VERSION, "name": "vpp-tpu",
                    "type": "vpp-tpu-torch-cni",
                    "grpcServer": conf["cni_socket"]}

        def cni(command: str, k: int):
            env = {"CNI_COMMAND": command, "CNI_CONTAINERID": f"wirek{k:04d}",
                   "CNI_NETNS": f"/var/run/netns/{nss[k]}",
                   "CNI_IFNAME": "eth0",
                   "CNI_ARGS": f"IgnoreUnknown=1;K8S_POD_NAMESPACE=ns4;"
                               f"K8S_POD_NAME=wk{k}"}
            return cni_shim.run(env, json.dumps(conf_cni).encode())

        add_ms = []
        deadline = time.monotonic() + 300.0
        for k in range(WIRE_KERNEL_PODS):
            while True:
                t1 = time.perf_counter()
                reply, code = cni("ADD", k)
                if code == 0:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"wire kernel: CNI ADD {k}: {reply}")
                time.sleep(0.5)
            add_ms.append((time.perf_counter() - t1) * 1e3)
            pods[k] = json.loads(reply)["ips"][0]["address"].split("/")[0]
            if k == 0:
                out["boot_to_first_pod_s"] = time.perf_counter() - t0
            labels = {"app": "cache" if k == 1 else "web", "tier": "back"}
            ksr.sources[km.Pod.TYPE].add(f"ns4/wk{k}", km.Pod(
                name=f"wk{k}", namespace="ns4", labels=labels,
                ip_address=pods[k], host_ip_address=K8S_NODE_IP))
        a, b = nss[0], nss[1]
        if not udp_delivered(a, b, pods[1], 5354):
            raise AssertionError("wire kernel: UDP pod to pod lost")
        if not tcp_exchange(a, b, pods[1], 8080):
            raise AssertionError("wire kernel: TCP handshake failed")
        ping(None, pods[1], 2)  # the host's first ARP on the interconnect
        host_ping = ping(None, pods[1], 5)
        if host_ping != 5:
            raise AssertionError(f"wire kernel: host ping {host_ping}/5")
        # a deny: wk1 (app cache) takes TCP 8080 only; UDP 5355 is cut
        ksr.sources[km.Policy.TYPE].add("ns4/wire-deny", _policy(
            "ns4", "wire-deny", "cache", [_peer_pods(ns_env="")], [8080]))
        deadline = time.monotonic() + 60.0
        while udp_delivered(a, b, pods[1], 5355, tries=5):
            if time.monotonic() > deadline:
                raise AssertionError("wire kernel: the deny never cut")
        if not tcp_exchange(a, b, pods[1], 8080):
            raise AssertionError("wire kernel: the deny cut its allowed port")
        # CNI DEL removes the veth
        if cni("DEL", 0)[1] != 0 or ip_("link", "show",
                                        host_ifname("wirek0000")).returncode == 0:
            raise AssertionError("wire kernel: CNI DEL left the veth")
        # STN: steal and revert a veth's addressing through LinuxNetlink
        ip_("link", "del", "vpptkstn0")
        ip_("link", "add", "vpptkstn0", "type", "veth", "peer", "name",
            "vpptkstn1")
        ip_("addr", "add", "10.87.0.2/24", "dev", "vpptkstn0")
        stn = STNDaemon(LinuxNetlink(), persist_path=str(root / "stn.json"))
        info = stn.steal("vpptkstn0")
        gone = "10.87.0.2" not in ip_("-o", "addr", "show", "dev",
                                      "vpptkstn0").stdout
        dog = Watchdog(stn, probe=lambda: False, grace_failures=1)
        dog.tick()
        back = "10.87.0.2/24" in ip_("-o", "addr", "show", "dev",
                                     "vpptkstn0").stdout
        ip_("link", "del", "vpptkstn0")
        if not (gone and back and "10.87.0.2/24" in info.ip_addresses):
            raise AssertionError("wire kernel: STN steal / revert")
        p = np.asarray(add_ms[1:] or add_ms)
        out.update(pods=len(pods), cni_add_ms=dict(
            p50=float(np.percentile(p, 50)), p99=float(np.percentile(p, 99))),
            host_ping=host_ping, seconds=time.perf_counter() - t_phase)
        say(f"wire kernel: {len(pods)} pods wired through the CNI shim, "
            f"add p50 {out['cni_add_ms']['p50']:.2f} ms, p99 "
            f"{out['cni_add_ms']['p99']:.2f} ms (phase 4i's config-only "
            f"adds beside); UDP and a TCP handshake pod to pod, the host "
            f"pinged a pod ({host_ping}/5), a deny cut UDP 5355 and kept "
            f"TCP 8080, CNI DEL removed the veth, STN steal and revert")
    finally:
        if ksr is not None:
            ksr.close()
            ksr.store.close()
        sup.stop()
        kv.close()
        for ns in nss:
            ip_("netns", "del", ns)
        for k in range(WIRE_KERNEL_PODS):
            ip_("link", "del", host_ifname(f"wirek{k:04d}"))
        tmp.cleanup()
    return out


# --- phase 4l: the VCL host stack and the gateway fleet --------------------

VCL_FILLER = 996          # bench.py hoststack_bench's gen-policy filler
VCL_CAPACITY = 2048       # the bench's engine capacity
VCL_CHECKS = 4096         # batched connect decisions held against the twin
VCL_CONNS = 50            # the wrk harness's connections (RPS.sh, CPS.sh)
VCL_CPS_WAVE = 32         # connects admitted per engine batch (CPS)
VCL_WINDOW_S = 2.5        # each of the RPS and CPS windows
VCL_BULK_MB = 256         # bench.py vcl_iperf_bench's transfer
VCL_NS = {"client": 1, "proxy": 2, "backend": 3}
VCL_DEADLINE = 120.0      # the longest a child process may take
FLEET_SLOTS = 1 << 18     # bench.py fleet_bench: session slots an instance
FLEET_RANGES = 64         # hash ranges
FLEET_FRAMES = 64         # frames of the scale-out offered load
FLEET_FRAME = 1024        # packets a frame
FLEET_RUNGS = (1, 2, 4)   # instances per scale-out rung
FLEET_TURNS = 3           # interleaved timed passes per rung
FLEET_FLOWS = 8192        # flows of the live rebalance
FLEET_WIDTH = 256         # the rebalance pump's frame width
FLEET_NOW = 800_000       # the pinned step clock (past phase 4k's)
FLEET_KERNELS = ("sess_probe_ways", "bv_first_set", "lpm_fused_lookup")

VCL_CONNECT_CODE = """
import socket, sys
s = socket.socket()
s.settimeout(30)
try:
    s.connect(("127.0.0.1", int(sys.argv[1])))
    print("CONNECTED")
except ConnectionRefusedError:
    print("REFUSED")
"""
VCL_SINK_CODE = """
import socket
ls = socket.socket()
ls.bind(("127.0.0.1", 0))
ls.listen(1)
print(ls.getsockname()[1], flush=True)
c, _ = ls.accept()
buf = memoryview(bytearray(1 << 20))
n = 0
while True:
    r = c.recv_into(buf)
    if not r:
        break
    n += r
print(n, flush=True)
"""
VCL_SOURCE_CODE = """
import socket, sys, time
total = int(sys.argv[2])
c = socket.create_connection(("127.0.0.1", int(sys.argv[1])), timeout=30)
chunk = b"x" * (1 << 20)
t0 = time.perf_counter()
sent = 0
while sent < total:
    c.sendall(chunk)
    sent += len(chunk)
c.close()
print(time.perf_counter() - t0)
"""


def vcl_admit(port: int, ns: int):
    """A LOCAL admit of ``ns``'s connects to loopback ``port`` and a
    GLOBAL admit of accepts on it: over phase 4l's deny-alls, both
    verdicts are load-bearing."""
    from vpp_tpu_torch.hoststack.session_rules import (
        RuleAction, RuleScope, SessionRule)

    loop = ip4("127.0.0.1")
    return [SessionRule(scope=int(RuleScope.LOCAL), appns_index=ns,
                        transport_proto=6, lcl_net=0, lcl_plen=0,
                        rmt_net=loop, rmt_plen=32, lcl_port=0,
                        rmt_port=port, action=int(RuleAction.ALLOW)),
            SessionRule(scope=int(RuleScope.GLOBAL), appns_index=-1,
                        transport_proto=6, lcl_net=loop, lcl_plen=32,
                        rmt_net=0, rmt_plen=0, lcl_port=port, rmt_port=0,
                        action=int(RuleAction.ALLOW))]


def vcl_connects(rng, n: int):
    """``n`` connect checks that land on the filler's nets and ports in
    its namespaces, and on the proxy chain's (allowed and denied)."""
    loop = ip4("127.0.0.1")
    i = rng.integers(0, VCL_FILLER, n)
    net = (10 << 24) | (((i // 250) % 64) << 16) | ((i % 250) << 8)
    rmt = np.where(rng.random(n) < 0.8, net + rng.integers(0, 256, n),
                   loop)
    ns = np.where(rng.random(n) < 0.75, 5 + i % 3,
                  rng.integers(0, 4, n))
    port = np.where(rng.random(n) < 0.85, 8000 + rng.integers(0, 40, n),
                    rng.integers(1, 65536, n))
    lport = rng.integers(1024, 65536, n)
    return [(int(a), 6, int(loop), int(b), int(c), int(d))
            for a, b, c, d in zip(ns, lport, rmt, port)]


def vcl_child(code: str, env, *argv) -> str:
    out = subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                         env=env, capture_output=True, text=True,
                         timeout=VCL_DEADLINE)
    if out.returncode != 0:
        raise AssertionError(f"vcl child: {out.stderr[-500:]}")
    return out.stdout.strip()


def vcl_bulk(env_sink, env_source, admit=None) -> float:
    """Gbps of one VCL_BULK_MB loopback transfer between two children
    (bench.py vcl_iperf_bench's, every port the kernel's); ``admit``
    takes the sink's port before the source connects."""
    total = VCL_BULK_MB << 20
    sink = subprocess.Popen([sys.executable, "-c", VCL_SINK_CODE],
                            env=env_sink, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = int(sink.stdout.readline())
        if admit is not None:
            admit(port)
        dt = float(vcl_child(VCL_SOURCE_CODE, env_source, port, total))
        got = int(sink.stdout.readline())
        if got != total:
            raise AssertionError(f"vcl bulk: {got} of {total} bytes")
        return total * 8 / dt / 1e9
    finally:
        sink.kill()
        sink.wait(timeout=30)


def vcl_rps_cps(engine) -> dict:
    """bench.py hoststack_bench's RPS (50 persistent connections) and
    CPS (32-wide admission waves of connect, request, close) through
    ``HostStackApp`` over ``engine``, the server's accepts admitted in
    waves too."""
    import threading

    from vpp_tpu_torch.hoststack.vcl import HostStackApp

    server = HostStackApp(engine, appns_index=VCL_NS["backend"])
    srv = server.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(256)
    port = srv.getsockname()[1]
    engine.apply(add=vcl_admit(port, VCL_NS["client"]))
    client = HostStackApp(engine, appns_index=VCL_NS["client"])
    stop = threading.Event()

    def serve_conn(conn):
        try:
            while conn.recv(64):
                conn.sendall(b"HTTP/1.1 200 OK\r\n\r\nok")
        except OSError:
            pass
        finally:
            conn.close()

    def acceptor():
        while not stop.is_set():
            try:
                wave = srv.accept_batch(max_n=64, first_timeout=0.01)
            except OSError:
                return
            for fconn, _peer in wave:
                threading.Thread(target=serve_conn, args=(fconn.sock,),
                                 daemon=True).start()

    acc = threading.Thread(target=acceptor, daemon=True)
    acc.start()
    out = {}
    try:
        conns = [c for c in client.connect_batch(
            [("127.0.0.1", port)] * VCL_CONNS) if c is not None]
        if len(conns) != VCL_CONNS:
            raise AssertionError(f"vcl rps: {len(conns)} of {VCL_CONNS} "
                                 f"connections admitted")
        for c in conns:
            c.settimeout(30)
        reqs = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < VCL_WINDOW_S:
            c = conns[reqs % VCL_CONNS]
            c.send(b"GET / HTTP/1.1\r\n\r\n")
            if not c.recv(64):
                raise AssertionError("vcl rps: the server closed")
            reqs += 1
        out["rps"] = reqs / (time.perf_counter() - t0)
        for c in conns:
            c.close()
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < VCL_WINDOW_S:
            wave = [c for c in client.connect_batch(
                [("127.0.0.1", port)] * VCL_CPS_WAVE) if c is not None]
            if len(wave) != VCL_CPS_WAVE:
                raise AssertionError("vcl cps: a connect was denied")
            for c in wave:
                c.settimeout(30)
                c.send(b"GET / HTTP/1.1\r\nConnection: close\r\n\r\n")
            for c in wave:
                if not c.recv(64):
                    raise AssertionError("vcl cps: no reply")
                c.close()
                done += 1
        out["cps"] = done / (time.perf_counter() - t0)
    finally:
        stop.set()
        srv.close()
        acc.join(timeout=10)
    return out


def hoststack_phase(seed: int, device=None) -> dict:
    """Phase 4l (i) (module doc). ``device`` "cpu" rehearses it on the
    CPU. Returns the summary."""
    import socket

    from vpp_tpu_torch.hoststack.admission import OP_CONNECT, _REQ
    from vpp_tpu_torch.hoststack.preload import shim_path, vcl_env
    from vpp_tpu_torch.hoststack.scenarios import (
        gen_policy_filler, proxy_chain_rules)
    from vpp_tpu_torch.hoststack.session_rules import SessionRuleEngine
    from vpp_tpu_torch.kvstore import KVStore

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_vcl_")
    sock = str(Path(tmp.name) / "vcl.sock")
    t0 = time.perf_counter()
    shim = shim_path()
    build_s = time.perf_counter() - t0
    agent = ContivAgent(AgentConfig.from_dict({
        "node_name": "vcl-node", "serve_http": False, "vcl_socket": sock}),
        store=KVStore(), device=device)
    summary = {"shim": shim, "shim_build_s": build_s}
    try:
        agent.start()
        engine = agent.session_engine
        if agent.vcl_admission is None or \
                agent.vcl_admission.engine is not engine:
            raise AssertionError("vcl: the agent serves no admission "
                                 "socket over its engine")
        engine.capacity = VCL_CAPACITY
        twin = SessionRuleEngine(capacity=VCL_CAPACITY, device="cpu")
        loop = ip4("127.0.0.1")
        # the proxy chain's two hops: the client may reach only the
        # proxy's port, the proxy only the backend's; both are listeners
        # the kernel numbers
        listeners = []
        for _ in range(2):
            ls = socket.socket()
            ls.bind(("127.0.0.1", 0))
            ls.listen(8)
            listeners.append(ls)
        pport, bport = (ls.getsockname()[1] for ls in listeners)
        rules = gen_policy_filler(VCL_FILLER) + proxy_chain_rules(
            loop, VCL_NS["client"], VCL_NS["proxy"], pport, bport)
        for e in (engine, twin):
            e.apply(add=rules)
        summary["rules"] = engine.num_rules
        # the shim in real children: an allowed connect and a denied one
        env = vcl_env(sock, appns_index=VCL_NS["client"], fail_closed=True)
        got = (vcl_child(VCL_CONNECT_CODE, env, pport),
               vcl_child(VCL_CONNECT_CODE, env, bport))
        if got != ("CONNECTED", "REFUSED"):
            raise AssertionError(f"vcl shim: client to proxy, client to "
                                 f"backend gave {got}")
        for ls in listeners:
            ls.close()
        say(f"vcl shim: a child under LD_PRELOAD={Path(shim).name} in "
            f"namespace {VCL_NS['client']} connects to the proxy's port "
            f"and is refused the backend's (fail-closed)")
        # the differential: batched decisions against the CPU twin's
        conns = vcl_connects(np.random.default_rng(seed + 41), VCL_CHECKS)
        card = engine.check_connect(conns)
        want = twin.check_connect(conns)
        if not np.array_equal(card, want):
            bad = int(np.count_nonzero(card != want))
            raise AssertionError(f"vcl: {bad} of {VCL_CHECKS} connect "
                                 f"decisions differ from the CPU twin's")
        denied = int(np.count_nonzero(~card))
        if not 0 < denied < VCL_CHECKS:
            raise AssertionError(f"vcl: {denied} of {VCL_CHECKS} denied")
        summary["differential"] = {"checks": VCL_CHECKS, "denied": denied}
        say(f"vcl twin: {VCL_CHECKS} batched connect decisions on "
            f"{engine.device} equal the CPU twin engine's ({denied} "
            f"denied, {engine.num_rules} rules)")
        # admission rates: the engine's batch, and the socket's round trip
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.check_connect(conns)
            times.append(time.perf_counter() - t0)
        batch_s = float(np.median(times))
        summary["admission_batch_ksps"] = VCL_CHECKS / batch_s / 1e3
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(30)
        s.connect(sock)
        reqs = [_REQ.pack(OP_CONNECT, 6, 0, c[0], c[2], c[4], c[3], c[5])
                for c in conns[:1024]]
        t0 = time.perf_counter()
        answers = b""
        for r in reqs:
            s.sendall(r)
            answers += s.recv(1)
        rt_s = time.perf_counter() - t0
        s.close()
        if answers != bytes(int(x) for x in want[:1024]):
            raise AssertionError("vcl: the admission socket's verdicts "
                                 "differ from the engine's")
        summary["admission_socket_ksps"] = len(reqs) / rt_s / 1e3
        say(f"vcl admission: {summary['admission_batch_ksps']:.1f} k "
            f"decisions/s in batches of {VCL_CHECKS} "
            f"({batch_s * 1e3:.3f} ms a batch), "
            f"{summary['admission_socket_ksps']:.2f} k/s one at a time "
            f"over the admission socket (1,024 round trips)")
        summary.update(vcl_rps_cps(engine))
        say(f"vcl rps/cps: {summary['rps']:.1f} requests/s over "
            f"{VCL_CONNS} admitted connections, {summary['cps']:.1f} "
            f"connections/s in {VCL_CPS_WAVE}-wide admission waves")
        # bulk TCP, bare and under the shim (a sink in the backend's
        # namespace, a source in the client's, each port admitted)
        bare = vcl_bulk(None, None)
        sink_env = vcl_env(sock, appns_index=VCL_NS["backend"],
                           fail_closed=True)
        src_env = vcl_env(sock, appns_index=VCL_NS["client"],
                          fail_closed=True)
        shimmed = vcl_bulk(sink_env, src_env, lambda port: engine.apply(
            add=vcl_admit(port, VCL_NS["client"])))
        summary["bulk_gbps"] = {"bare": bare, "shim": shimmed}
        adm = dict(agent.vcl_admission.stats)
        summary["admission_stats"] = adm
        agent.stats.publish()
        g = agent.stats.vcl_gauges
        if g["vpp_tpu_vcl_connect_checks"].get() != adm["connect_checks"] \
                or adm["connect_denies"] < 1 or adm["accept_checks"] < 1:
            raise AssertionError(f"vcl counters {adm}")
        say(f"vcl bulk: {VCL_BULK_MB} MB over loopback {bare:.2f} Gbps "
            f"bare, {shimmed:.2f} Gbps under the shim; admission "
            f"counters {adm}")
    finally:
        agent.close()
        tmp.cleanup()
    summary["seconds"] = time.perf_counter() - t_phase
    say(f"phase 4l (i): {summary['seconds']:.1f} s")
    return summary


def fleet_config(slots: int = FLEET_SLOTS) -> DataplaneConfig:
    """bench.py fleet_bench's ``mk_dp`` instance (sym session hash, no
    sweep), its ladders on the fused-kernel rungs."""
    return DataplaneConfig(
        max_tables=2, max_rules=16, max_global_rules=16, max_ifaces=8,
        fib_slots=16, sess_slots=slots, sess_ways=4, nat_mappings=2,
        nat_backends=2, sess_sweep_stride=0, sess_hash="sym",
        classifier="pallas", fib_impl="pallas", session_impl="pallas")


def fleet_instance(cfg: DataplaneConfig, clock: list, device=None):
    dp = Dataplane(cfg, device=device)
    dp.clock_ticks = lambda: clock[0]
    dp.add_uplink()
    dp.add_pod_interface(("default", "web"))
    dp.builder.add_route("10.1.1.0/24", 2, Disposition.LOCAL)
    dp.builder.set_global_table([
        ContivRule(action=Action.PERMIT, protocol=Protocol.TCP),
        ContivRule(action=Action.DENY)])
    dp.swap()
    return dp


def fleet_frames(n_frames: int, width: int, reply: bool = False):
    """bench.py fleet_bench's ``mk_frames``: packed ``[5, width]``
    frames of distinct TCP flows to the pod (``reply``: the pod's
    answers, the same canonical buckets under the sym hash)."""
    pod_ip = ip4("10.1.1.2")
    out = []
    for f in range(n_frames):
        flow = f * width + np.arange(width)
        src = (np.uint32((10 << 24) | (9 << 16))
               + (flow % 65536).astype(np.uint32))
        sport = (1024 + flow % 40000).astype(np.int32)
        n = width
        cols = {
            "src_ip": np.full(n, pod_ip, np.uint32) if reply else src,
            "dst_ip": src if reply else np.full(n, pod_ip, np.uint32),
            "proto": np.full(n, 6, np.int32),
            "sport": np.full(n, 80, np.int32) if reply else sport,
            "dport": sport if reply else np.full(n, 80, np.int32),
            "ttl": np.full(n, 64, np.int32),
            "pkt_len": np.full(n, 64, np.int32),
            "rx_if": np.full(n, 2 if reply else 1, np.int32),
            "flags": np.ones(n, np.int32),
        }
        flat = np.zeros((5, n), np.int32)
        pack_packet_columns(flat.view(np.uint32), cols, n)
        out.append(flat)
    return out


def fleet_shares(steering, frames, width: int) -> dict:
    """{instance: its packets of ``frames`` in steering order, re-framed
    at ``width``, the tail padded with invalid slots}."""
    parts = [steering.partition(f)[0] for f in frames]
    out = {}
    for name in steering._names:
        share = [f[:, g[name]] for f, g in zip(frames, parts) if name in g]
        cols = np.concatenate(share, axis=1) if share else \
            np.zeros((5, 0), np.int32)
        n = cols.shape[1]
        pad = (-n) % width
        cols = np.concatenate([cols, np.zeros((5, pad), np.int32)], axis=1)
        out[name] = (n, [np.ascontiguousarray(cols[:, i:i + width])
                         for i in range(0, cols.shape[1], width)])
    return out


def fleet_state(dp) -> dict:
    with dp._lock:
        return {f: getattr(dp.tables, f).cpu().numpy().copy()
                for f in SESSION_FIELDS}


def fleet_scaleout(seed: int, device=None, twin_device="cpu",
                   slots: int = FLEET_SLOTS, n_frames: int = FLEET_FRAMES,
                   width: int = FLEET_FRAME) -> dict:
    """Phase 4l (ii) rungs: each rung's card fleet against a CPU twin
    fleet on the same partitions, then timed through a FleetPump."""
    from vpp_tpu_torch.fleet import FleetSteering
    from vpp_tpu_torch.io.fleet import FleetPump

    clock = [FLEET_NOW]
    frames = fleet_frames(n_frames, width)
    offered = n_frames * width
    out = {"offered": offered, "rungs": {}}
    fleets = {}
    try:
        for n_inst in FLEET_RUNGS:
            names = [f"gw{i}" for i in range(n_inst)]
            card = {n: fleet_instance(fleet_config(slots), clock, device)
                    for n in names}
            twin = {n: fleet_instance(fleet_config(slots), clock,
                                      twin_device) for n in names}
            st = FleetSteering(card, n_ranges=FLEET_RANGES)
            st_twin = FleetSteering(twin, n_ranges=FLEET_RANGES)
            if st.owners() != st_twin.owners():
                raise AssertionError("fleet: the twin's ranges differ")
            shares = fleet_shares(st, frames, width)
            if {n: s[0] for n, s in shares.items()} != \
                    {n: s[0] for n, s in fleet_shares(
                        st_twin, frames, width).items()}:
                raise AssertionError("fleet: the twin steers otherwise")
            if sum(s[0] for s in shares.values()) != offered:
                raise AssertionError("fleet: steering lost packets")
            for name in names:
                for k, flat in enumerate(shares[name][1]):
                    got = card[name].process_packed(
                        flat, now=FLEET_NOW, with_aux=True)
                    want = twin[name].process_packed(
                        flat, now=FLEET_NOW, with_aux=True)
                    for a, b, what in zip(got, want, ("out", "aux")):
                        if not np.array_equal(a.cpu().numpy(),
                                              b.cpu().numpy()):
                            raise AssertionError(
                                f"fleet rung {n_inst} {name} frame {k}: "
                                f"{what} differs from the CPU twin's")
                c, t = fleet_state(card[name]), fleet_state(twin[name])
                for f in c:
                    if not np.array_equal(c[f], t[f]):
                        raise AssertionError(
                            f"fleet rung {n_inst} {name}: {f} differs "
                            f"from the CPU twin's")
                card[name].prime("packed", (5, width))
            say(f"fleet rung {n_inst}: every instance's packed outputs, "
                f"aux rows and session state equal its CPU twin's "
                f"(shares {[shares[n][0] for n in names]})")
            del twin, st_twin
            fleets[n_inst] = (card, st)
        steer_best = {n: float("inf") for n in FLEET_RUNGS}
        pump_best = {n: float("inf") for n in FLEET_RUNGS}
        for _ in range(FLEET_TURNS):
            for n_inst in FLEET_RUNGS:
                card, st = fleets[n_inst]
                t0 = time.perf_counter()
                for f in frames:
                    st.partition(f)
                steer_best[n_inst] = min(steer_best[n_inst],
                                         time.perf_counter() - t0)
                pump = FleetPump(st, frame_width=width,
                                 queue_slots=2 * n_frames)
                pump.start()
                t0 = time.perf_counter()
                for f in frames:
                    pump.submit(f)
                pump.stop()
                _sync(next(iter(card.values())).device)
                pump_best[n_inst] = min(pump_best[n_inst],
                                        time.perf_counter() - t0)
                cons = pump.conservation()
                if cons["delivered"] != offered or cons["pending"]:
                    raise AssertionError(f"fleet rung {n_inst}: {cons}")
        for n_inst in FLEET_RUNGS:
            row = {"mpps": offered / pump_best[n_inst] / 1e6,
                   "pump_s": pump_best[n_inst],
                   "steer_ns_pkt": steer_best[n_inst] / offered * 1e9}
            out["rungs"][n_inst] = row
            say(f"fleet rung {n_inst}: {row['mpps']:.4f} Mpps through the "
                f"FleetPump ({offered} packets in frames of {width}, best "
                f"of {FLEET_TURNS} passes, {pump_best[n_inst] * 1e3:.2f} "
                f"ms), steering {row['steer_ns_pkt']:.1f} ns a packet")
    finally:
        for _card, st in fleets.values():
            st.close()
    return out


def fleet_rebalance(seed: int, device=None, slots: int = FLEET_SLOTS,
                    n_flows: int = FLEET_FLOWS,
                    width: int = FLEET_WIDTH) -> dict:
    """Phase 4l (ii) live rebalance: two instances take a third under
    FleetPump load (bench.py fleet_bench's)."""
    import threading

    from vpp_tpu_torch.fleet import FleetMembership, FleetSteering
    from vpp_tpu_torch.fleet.hashring import assign_ranges
    from vpp_tpu_torch.io.fleet import FleetPump
    from vpp_tpu_torch.kvstore import KVStore

    clock = [FLEET_NOW]
    fwd = fleet_frames(n_flows // width, width)
    rev = fleet_frames(n_flows // width, width, reply=True)
    names = ["gw0", "gw1", "gw2"]
    dps = {n: fleet_instance(fleet_config(slots), clock, device)
           for n in names}
    for dp in dps.values():
        dp.prime("packed", (5, width))
    st = FleetSteering(dps, membership=FleetMembership(
        KVStore(), name="smoke"), n_ranges=FLEET_RANGES)
    pump = FleetPump(st, frame_width=width, queue_slots=256)
    seen = {"hits": 0, "deliv": 0}

    def drain():
        pump.flush()
        t0 = time.perf_counter()
        while pump.pending():
            if time.perf_counter() - t0 > PUMP_DEADLINE:
                raise AssertionError("fleet: the pump did not drain")
            time.sleep(0.001)

    def window(frames):
        lats = []
        for f in frames:
            t0 = time.perf_counter()
            pump.submit(f)
            lats.append(time.perf_counter() - t0)
        drain()
        snap = pump.stats_snapshot()
        hits = sum(a.get("sess_hits", 0) for a in snap["aux"].values())
        deliv = sum(snap["delivered"].values())
        dh, dd = hits - seen["hits"], deliv - seen["deliv"]
        seen["hits"], seen["deliv"] = hits, deliv
        return lats, (dh / dd if dd else 0.0)

    out = {}
    try:
        st.rebalance(target=assign_ranges(["gw0", "gw1"], FLEET_RANGES))
        pump.start()
        for f in fwd:
            pump.submit(f)
        drain()
        snap0 = pump.stats_snapshot()
        seen["hits"] = sum(a.get("sess_hits", 0)
                           for a in snap0["aux"].values())
        seen["deliv"] = sum(snap0["delivered"].values())
        base_lats, out["hit_rate_base"] = window(rev)
        ss0 = st.stats_snapshot()
        moved = []
        t_move = [0.0]

        def mover():
            t0 = time.perf_counter()
            moved.append(st.rebalance())
            t_move[0] = time.perf_counter() - t0

        th = threading.Thread(target=mover, daemon=True)
        th.start()
        move_lats, move_windows = [], 0
        while th.is_alive():
            lats, _ = window(rev)
            move_lats.extend(lats)
            move_windows += 1
        th.join()
        out["migration_ms"] = t_move[0] * 1e3
        out["move_windows"] = move_windows
        recovery, hit = -1, 0.0
        for w in range(1, 11):
            _, hit = window(rev)
            if hit >= 0.9:
                recovery = w
                break
        out["hit_rate_final"] = hit
        out["recovery_windows"] = recovery
        pump.stop()
        cons = pump.conservation()
        attributed = (cons["delivered"] + cons["fenced_drops"]
                      + cons["no_owner_drops"] + cons["queue_drops"]
                      + cons["pending"])
        out["conservation"] = cons
        if cons["offered"] != attributed or cons["pending"]:
            raise AssertionError(f"fleet rebalance: conservation {cons}")
        ss = st.stats_snapshot()
        out["ranges_moved"] = ss["migrated_ranges"] - ss0["migrated_ranges"]
        out["sessions_moved"] = (ss["migrated_sessions"]
                                 - ss0["migrated_sessions"])
        if not moved or moved[0] != out["ranges_moved"] or \
                not out["ranges_moved"] or recovery < 0:
            raise AssertionError(f"fleet rebalance: {out}")
        out["p99_ms_base"] = float(np.percentile(
            np.array(base_lats) * 1e3, 99))
        if move_lats:
            out["p99_ms_move"] = float(np.percentile(
                np.array(move_lats) * 1e3, 99))
        say(f"fleet rebalance 2 -> 3: {out['ranges_moved']} ranges, "
            f"{out['sessions_moved']} sessions migrated in "
            f"{out['migration_ms']:.1f} ms under load ({move_windows} "
            f"windows meanwhile); fast-path hit rate of the migrated "
            f"flows {out['hit_rate_base']:.4f} before, "
            f"{out['hit_rate_final']:.4f} after, recovered in "
            f"{recovery} window(s); conservation exact: offered "
            f"{cons['offered']} = delivered {cons['delivered']} + fenced "
            f"{cons['fenced_drops']} + no owner {cons['no_owner_drops']} "
            f"+ queue {cons['queue_drops']}; submit p99 "
            f"{out['p99_ms_base']:.3f} ms before, "
            f"{out.get('p99_ms_move', float('nan')):.3f} ms during")
    finally:
        try:
            pump.stop()
        finally:
            st.close()
    return out


def fleet_phase(seed: int, device=None, twin_device="cpu", **sizes):
    """Phase 4l (ii) (module doc). Returns (summary, launches)."""
    t_phase = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    scale = fleet_scaleout(seed, device, twin_device, **{
        k: v for k, v in sizes.items() if k in ("slots", "n_frames",
                                                 "width")})
    rebal = fleet_rebalance(seed, device, **{
        k: v for k, v in sizes.items() if k in ("slots", "n_flows")})
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    say("fleet: every instance shares the one card in one process, so "
        "a rung's rate is instances sharing one H100, not the "
        "reference's one-host-per-instance scale-out ratio")
    summary = {"scaleout": scale, "rebalance": rebal,
               "seconds": time.perf_counter() - t_phase}
    say(f"phase 4l (ii): {summary['seconds']:.1f} s; launches {launches}")
    return summary, launches


# --- phase 4m: the single-host mesh ----------------------------------------

MESH_NODES, MESH_SHARDS = 4, 2    # the cluster: 4 nodes x 2 rule shards
MESH_BUDGET = 32                  # the fabric budget that overflows
MESH_ROUNDS = 2                   # (forward, 2 replies) rounds a rung
MESH_TIMED = 10                   # timed cluster steps a cell
MESH_NOW = 900_000                # the pinned step clock (past 4l's)
MESH_AGENT = (2, 2)               # the mesh agent's runtime
MESH_AGENT_FRAMES = 64            # frames through the ClusterPump
MESH_AGENT_NOW = 950_000


def mesh_pod_net(k: int) -> str:
    """Node ``k``'s pod /24 (the slice's 10.1.1.0/24 is node 0's)."""
    return f"10.1.{1 + k}.0/24"


def mesh_stage(dp: Dataplane, k: int, n_nodes: int, n_rules: int):
    """Stage node ``k`` of a mesh as ``stage`` stages the slice, with its
    own pod /24 (the 250 pod /32s and the ClusterIP's backends in it, the
    global table's port-80 permit on it), fabric routes to its peers'
    pod /24s (``node_id`` = the peer's mesh row, no next hop), edge
    routes (VXLAN next hops) filling the slice's 3,996 routes, and the
    SNAT default route. The cluster swap publishes it. Returns (uplink,
    pods)."""
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
    b.set_global_table(global_rules(n_rules, pod_net=mesh_pod_net(k)))
    net = ip4(mesh_pod_net(k).split("/")[0])
    b.add_route(mesh_pod_net(k), pods[0], Disposition.LOCAL)
    for h in range(1, 251):
        b.add_route(f"{ip4_str(net + h)}/32", pods[int(pod_of(np.int64(h)))],
                    Disposition.LOCAL)
    for j in range(n_nodes):
        if j != k:
            b.add_route(mesh_pod_net(j), up, Disposition.REMOTE, node_id=j)
    # the slice's 3,996 routes (fewer when a rehearsal's FIB is small)
    for n in range(min(3745, dp.config.fib_slots - 260) - n_nodes):
        b.add_route(f"10.{2 + n // 256}.{n % 256}.0/24", up,
                    Disposition.REMOTE, next_hop=ip4("192.168.0.0") + n)
    b.add_route("0.0.0.0/0", up, Disposition.REMOTE,
                next_hop=ip4("192.168.255.254"), snat=True)
    b.set_nat_mapping(
        0, ip4(VIP), 80, 6,
        [(net + 2 + i, 80, 1 + i % 2) for i in range(N_BACKENDS)], boff=0)
    b.set_snat_ip(ip4("192.168.16.1") + k)
    return up, pods


def mesh_cluster(cfg: DataplaneConfig, device, n_rules: int,
                 n_nodes: int = MESH_NODES, shards: int = MESH_SHARDS):
    """A ClusterDataplane of ``n_nodes`` x ``shards`` on ``device``, every
    node staged by ``mesh_stage``, published by one swap."""
    clus = ClusterDataplane(
        cluster_mesh(n_nodes, shards, [device] * (n_nodes * shards)), cfg)
    staged = [mesh_stage(clus.node(k), k, n_nodes, n_rules)
              for k in range(n_nodes)]
    clus.swap()
    if len({(u, tuple(p)) for u, p in staged}) != 1:
        raise AssertionError("the mesh nodes staged different interfaces")
    return clus, staged[0][0], staged[0][1]


def mesh_forward(n: int, up: int, seed: int, n_nodes: int,
                 spread: bool = True):
    """Each node's forward vector: ``forward_traffic`` toward its own
    pods, a quarter of it re-addressed to the pods of other nodes
    (``spread``: any other node; else all of it to the next one)."""
    out = []
    for k in range(n_nodes):
        cols = forward_traffic(n, up, seed + 104729 * k)
        rng = np.random.default_rng(seed + 7 * k)
        host = cols["dst_ip"].astype(np.int64) & 0xFF
        peer = ((k + (rng.integers(1, n_nodes, n) if spread else 1))
                % n_nodes)
        node = np.where(rng.random(n) < (0.25 if spread else 1.0), peer, k)
        net = np.array([ip4(mesh_pod_net(j).split("/")[0])
                        for j in range(n_nodes)], np.int64)
        vip = cols["dst_ip"] == np.uint32(ip4(VIP))
        cols["dst_ip"] = np.where(vip, cols["dst_ip"],
                                  (net[node] + host).astype(np.uint32))
        out.append(cols)
    return out


def mesh_vector(cols_list, dev) -> PacketVector:
    """The node-stacked [N, P] vector of per-node column dicts."""
    pvs = [packet_vector_from_numpy(c, dev) for c in cols_list]
    return PacketVector(*(torch.stack(f) for f in zip(*pvs)))


def mesh_snapshot(res) -> dict:
    """Every ClusterStepResult field as numpy (interop's names)."""
    return cluster_result_to_numpy(res)


def mesh_replies(snap: dict, pods, to: str, n: int) -> list:
    """Each node's replies, as ``reply_traffic`` builds them, to the
    packets it delivered to its pods (pass 1's LOCAL rows and the
    fabric's pass-2 rows) or, ``to`` dropped, to those it dropped;
    ``n`` slots a node."""
    out = []
    for k in range(snap["local.disp"].shape[0]):
        rows = {}
        for side in ("local", "delivered"):
            disp = snap[f"{side}.disp"][k]
            valid = (snap[f"{side}.pkts.flags"][k] & FLAG_VALID) != 0
            if to == "forwarded":
                sel = valid & (disp == int(Disposition.LOCAL))
            else:
                sel = valid & (disp == int(Disposition.DROP))
            if side == "delivered" and to == "dropped":
                sel &= snap["delivered.drop_cause"][k] != 0
            for f in ("pkts.src_ip", "pkts.dst_ip", "pkts.sport",
                      "pkts.dport"):
                rows.setdefault(f, []).append(snap[f"{side}.{f}"][k][sel])
        sel_snap = {f: np.concatenate(v)[:n] for f, v in rows.items()}
        m = sel_snap["pkts.src_ip"].shape[0]
        pad = {f: np.concatenate([v, np.zeros(n - m, v.dtype)])
               for f, v in sel_snap.items()}
        pad["disp"] = np.where(np.arange(n) < m, int(Disposition.LOCAL),
                               int(Disposition.DROP)).astype(np.int32)
        out.append(reply_traffic(pad, pods, "forwarded"))
    return out


def mesh_state(clus) -> dict:
    return cluster_tables_to_numpy(
        clus.tables, tuple(SESSION_FIELDS) + ("fib_ecmp_c",))


def mesh_drive(clus, up: int, pods, seed: int, n: int, budget: int,
               rounds: int, spread: bool = True, now0: int = MESH_NOW):
    """``rounds`` x (forward, the replies to the forwarded packets, to
    the dropped ones) through ``clus.step``. Returns the inputs and the
    result snapshots."""
    inputs, snaps = [], []
    now = now0
    dev = clus.device

    def step(cols):
        nonlocal now
        res = clus.step(mesh_vector(cols, dev), now=now, budget=budget)
        inputs.append((cols, now))
        snaps.append(mesh_snapshot(res))
        now += 1
        return snaps[-1]

    for r in range(rounds):
        first = step(mesh_forward(n, up, seed + 7919 * r, clus.n_nodes,
                                  spread))
        for to in ("forwarded", "dropped"):
            step(mesh_replies(first, pods, to, n))
    return inputs, snaps


def mesh_twin(cfg, n_rules, inputs, budget: int):
    """The CPU twin of a card cluster: the same staging and inputs."""
    twin, _, _ = mesh_cluster(cfg, torch.device("cpu"), n_rules)
    snaps = [mesh_snapshot(twin.step(mesh_vector(cols, twin.device),
                                     now=now, budget=budget))
             for cols, now in inputs]
    return twin, snaps


def mesh_time(clus, vec, steps: int, now: int, budget: int = 0) -> float:
    """Median ms of one ``clus.step`` (CUDA events around each call; the
    auto path's host reads included)."""
    for _ in range(2):
        clus.step(vec, now=now, budget=budget)
    torch.cuda.synchronize()
    ms = []
    for i in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        clus.step(vec, now=now + i, budget=budget)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return float(np.median(ms))


def mesh_graph_launches(clus, vec, now: int) -> int:
    """CUDA-graph replays one captured cluster step makes."""
    before = sum(p.replays for prog in clus.programs() for p in prog.parts)
    clus.step(vec, now=now)
    return sum(p.replays for prog in clus.programs()
               for p in prog.parts) - before


def mesh_eager_vs_captured(cfg: DataplaneConfig, n_rules: int, seed: int,
                           dev) -> dict:
    """Two fresh clusters on the forced full chain (fast path off), one
    replaying its captured step, one stepping eagerly, take one round:
    every result and the final planes equal; the captured step is one
    graph launch."""
    snaps, states = {}, {}
    launches = None
    for mode in ("captured", "eager"):
        clus, up, pods = mesh_cluster(cfg._replace(fastpath=False), dev,
                                      n_rules)
        clus.graphs = mode == "captured"
        inputs, snaps[mode] = mesh_drive(clus, up, pods, seed, VEC, 0, 1)
        states[mode] = mesh_state(clus)
        if mode == "captured" and dev.type == "cuda":
            launches = mesh_graph_launches(
                clus, mesh_vector(inputs[0][0], dev), MESH_NOW + 50)
        del clus
    for k, (a, b) in enumerate(zip(snaps["captured"], snaps["eager"])):
        assert_equal(a, b, f"mesh eager vs captured step {k}")
    assert_equal(states["captured"], states["eager"],
                 "mesh eager vs captured state")
    if launches not in (None, 1):
        raise AssertionError(f"a captured full-chain cluster step made "
                             f"{launches} graph launches, not 1")
    say(f"mesh eager vs captured (fast path off): "
        f"{len(snaps['eager'])} steps, every result field and the final "
        f"planes equal; {launches} graph launch per captured step")
    return {"steps": len(snaps["eager"]), "graph_launches": launches}


def mesh_mxu_shards(dev, errors: Errors, seed: int) -> dict:
    """``mxu_first_match`` on a rule shard's operand (R'/S columns of the
    slice's 10,240: 5,120 at S = 2, 2,560 at S = 4) against its plain
    version, at P = 256 and 4,096; its graph time, the bound and the
    bf16 ``matmul`` / ``torch._int_mm`` yardsticks at that shape."""
    rng = np.random.default_rng(seed)
    out = {}
    for cols in (5120, 2560):
        for p in (VEC, BIG_VEC):
            for kind in ("random", "multi"):
                a = mxu_case(rng, p, cols, dev, kind)
                got = acl_mxu.mxu_first_match(*a)
                want = acl_mxu.mxu_first_match_plain(*a)
                torch.cuda.synchronize()
                errors.hold("mxu_first_match", (got,), (want,),
                            f"shard operand R'={cols} P={p} {kind}")
            b_ms, b_by = mxu_bound(*a)
            bits = acl_mxu.header_bit_planes(*a[:5])
            coeff_t = acl_mxu.mxu_operand_rows(a[5])[0]
            row = dict(
                ms=time_graph(lambda a=a: acl_mxu.mxu_first_match(*a)),
                plain_ms=time_eager(
                    lambda a=a: acl_mxu.mxu_first_match_plain(*a), 10),
                bound_ms=b_ms, bound_by=b_by,
                bound_bf16_ms=mxu_bound(*a, tc_rate=TC_BF16_FLOPS)[0],
                matmul_ms=time_graph(
                    lambda x=bits, w=coeff_t.to(torch.bfloat16):
                    torch.matmul(x, w.t())),
                int8_matmul_ms=time_graph(
                    lambda x=bits.to(torch.int8), w=coeff_t:
                    torch._int_mm(x, w.t())))
            out[f"R'={cols} P={p}"] = row
            say(f"kernel mxu_first_match shard operand R'={cols} P={p}: "
                f"{row['ms']:.5f} ms (graph replay), plain "
                f"{row['plain_ms']:.5f} ms, bound {b_ms:.6f} ms ({b_by}); "
                f"matmul bf16 {row['matmul_ms']:.5f} ms, _int_mm int8 "
                f"{row['int8_matmul_ms']:.5f} ms; bit-exact")
    return out


def mesh_cluster_phase(cfg: DataplaneConfig, n_rules: int, seed: int,
                       errors: Errors, device="cuda"):
    """Phase 4m (i) (module doc). Returns (summary, launches)."""
    dev = torch.device(device)
    mcfg = cfg._replace(classifier="auto", fastpath=True, fib_impl="auto",
                        session_impl="auto")
    summary = {"shards": mesh_mxu_shards(dev, errors, seed),
               "eager_vs_captured": mesh_eager_vs_captured(
                   mcfg, n_rules, seed + 3, dev)}
    launches = {k: 0 for k in WRAPPERS}
    rungs = {}
    for rung, knob in (("auto", "auto"), ("mxu", "mxu")):
        t0 = time.perf_counter()
        clus, up, pods = mesh_cluster(mcfg._replace(classifier=knob), dev,
                                      n_rules)
        stage_s = time.perf_counter() - t0
        want = {"auto": "bv", "mxu": "mxu"}[rung]
        if (clus.classifier_impl, clus.fastpath_selected) != (want, True):
            raise AssertionError(f"mesh rung {rung}: classifier "
                                 f"{clus.classifier_impl}, fast path "
                                 f"{clus.fastpath_selected}")
        for w in WRAPPERS.values():
            w.launches = 0
        inputs, snaps = mesh_drive(clus, up, pods, seed, VEC, 0,
                                   MESH_ROUNDS)
        got = {k: w.launches for k, w in WRAPPERS.items()}
        if rung == "mxu" and dev.type == "cuda" \
                and not got["mxu_first_match"]:
            raise AssertionError("the mesh's mxu rung never launched "
                                 "mxu_first_match")
        for k, v in got.items():
            launches[k] += v
        state = mesh_state(clus)
        twin, tsnaps = mesh_twin(mcfg._replace(classifier=knob), n_rules,
                                 inputs, 0)
        for k, (a, b) in enumerate(zip(snaps, tsnaps)):
            assert_equal(a, b, f"mesh {rung} step {k} against the CPU twin")
        assert_equal(state, mesh_state(twin),
                     f"mesh {rung} state against the CPU twin")
        del twin
        sent = [int(s["fabric_sent"].sum()) for s in snaps]
        fast = [int(s["fastpath_pass1"].sum()) for s in snaps]
        if not all(sent[::3]) or fast[1::3] != [MESH_NODES] * MESH_ROUNDS:
            raise AssertionError(f"mesh {rung}: fabric sent {sent}, pass-1 "
                                 f"fast tiers {fast}")
        totals = {f: int(sum(int(s[f"stats.{f}"].sum()) for s in snaps))
                  for f in ("rx", "tx", "drop_acl", "sess_hits", "dnat",
                            "nat_reversed", "snat")}
        for f in ("tx", "drop_acl", "sess_hits", "dnat", "snat"):
            if not totals[f]:
                raise AssertionError(f"mesh {rung}: {f} never fired")
        say(f"mesh {rung} (classifier {clus.classifier_impl}): staged in "
            f"{stage_s:.1f} s; {len(snaps)} steps of {MESH_NODES} x {VEC} "
            f"equal the CPU twin (every ClusterStepResult field, the "
            f"delivered rows, the stats and the session planes); fabric "
            f"sent {sent}; pass-1 fast tiers {fast}; totals {totals}; "
            f"launches {got}")
        cell = dict(stage_s=stage_s, sent=sent, fast=fast, totals=totals,
                    launches=got)
        if rung == "auto":
            # the fabric budget that overflows: every node's cross-node
            # quarter toward one peer
            for w in WRAPPERS.values():
                w.launches = 0
            b_in, b_snaps = mesh_drive(clus, up, pods, seed + 1,
                                       VEC, MESH_BUDGET, 1, spread=False,
                                       now0=MESH_NOW + 100)
            twin, _, _ = mesh_cluster(mcfg, torch.device("cpu"), n_rules)
            for cols, now in inputs:
                twin.step(mesh_vector(cols, twin.device), now=now)
            for k, ((cols, now), a) in enumerate(zip(b_in, b_snaps)):
                b = mesh_snapshot(twin.step(mesh_vector(cols, twin.device),
                                            now=now, budget=MESH_BUDGET))
                assert_equal(a, b, f"mesh budget {MESH_BUDGET} step {k}")
            assert_equal(mesh_state(clus), mesh_state(twin),
                         f"mesh budget {MESH_BUDGET} state")
            del twin
            over = int(b_snaps[0]["fabric_overflow"].sum())
            sent_b = int(b_snaps[0]["fabric_sent"].sum())
            if not over or sent_b != MESH_NODES * MESH_BUDGET:
                raise AssertionError(f"budget {MESH_BUDGET}: sent {sent_b},"
                                     f" overflow {over}")
            cell["budget"] = dict(budget=MESH_BUDGET, sent=sent_b,
                                  overflow=over)
            say(f"mesh budget {MESH_BUDGET}: sent {sent_b}, overflow "
                f"{over} (counted), every field equal to the CPU twin")
        # timing, captured against eager, at both sizes
        now = MESH_NOW + 1000
        times = {}
        for n in (VEC, BIG_VEC):
            fwd = mesh_forward(n, up, seed + 31 * n, MESH_NODES)
            first = mesh_snapshot(clus.step(mesh_vector(fwd, dev), now=now))
            rep = mesh_replies(first, pods, "forwarded", n)
            now += 1
            for tier, cols in (("full", fwd), ("fast", rep)):
                vec = mesh_vector(cols, dev)
                valid = int(sum(np.count_nonzero(c["flags"]) for c in cols))
                for mode in ("captured", "eager"):
                    clus.graphs = mode == "captured"
                    ms = mesh_time(clus, vec, MESH_TIMED, now)
                    now += MESH_TIMED + 5
                    key = f"{tier} {mode} P={n}"
                    times[key] = dict(ms=ms, valid=valid,
                                      mpps=valid / (ms * 1e3))
                    say(f"mesh {rung} step {key} ({valid} valid over "
                        f"{MESH_NODES} nodes): {ms:.4f} ms, "
                        f"{valid / (ms * 1e3):.4f} Mpps")
                clus.graphs = True
                g = mesh_graph_launches(clus, vec, now)
                now += 1
                times[f"{tier} graph launches P={n}"] = g
                say(f"mesh {rung} {tier} P={n}: {g} graph launches per "
                    f"cluster step")
        cell["times"] = times
        # a swap per churn: one node's global table, one node's route
        churn = {}
        for name, fn in (
                ("global table", lambda b: b.set_global_table(
                    global_rules(n_rules, pod_net=mesh_pod_net(1))[::-1]
                    [1:] + [global_rules(n_rules)[-1]])),
                ("route", lambda b: b.add_route(
                    "10.250.0.0/24", up, Disposition.REMOTE,
                    next_hop=ip4("192.168.1.1")))):
            with clus.node(1).commit_lock:
                fn(clus.node(1).builder)
                _sync(dev)
                t0 = time.perf_counter()
                clus.swap()
                host = (time.perf_counter() - t0) * 1e3
                _sync(dev)
                wall = (time.perf_counter() - t0) * 1e3
            churn[name] = dict(host_ms=host, synced_ms=wall,
                               **clus.upload_stats)
            say(f"mesh {rung} swap ({name}): {host:.3f} ms host, "
                f"{wall:.3f} ms synchronised; upload {clus.upload_stats}")
        cell["swap"] = churn
        rungs[rung] = cell
        del clus
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary["rungs"] = rungs
    return summary, launches


def mesh_agent_config(root: Path, io: bool) -> AgentConfig:
    return AgentConfig.from_dict({
        "node_name": "mesh", "serve_http": False,
        "dataplane": dict(max_tables=8, max_rules=32,
                          max_global_rules=1024, max_ifaces=32,
                          fib_slots=256, sess_slots=1 << 16, nat_mappings=16,
                          nat_backends=64),
        "io": {"enabled": io, "n_slots": 64, "snap": PUMP_SNAP}})


def mesh_agent_runtime(root: Path, device):
    """A MeshRuntime of MESH_AGENT on ``device``, its own store, pods
    through the CNI on both nodes, the policy and service objects
    through KSR. Returns (runtime, ksr, pod ips)."""
    from vpp_tpu_torch.kvstore import KVStore
    from vpp_tpu_torch.parallel.runtime import MeshRuntime

    store = KVStore()
    ksr = KsrAgent(store=store, serve_http=False)
    ksr.start()
    n, s = MESH_AGENT
    rt = MeshRuntime(n, mesh_agent_config(root, True), rule_shards=s,
                     store=store, devices=[device] * (n * s))
    rt.cluster.clock_ticks = lambda: MESH_AGENT_NOW
    rt.start()
    ips = {}
    for k, a in enumerate(rt.agents):
        for i in range(2):
            name = f"m{k}-{i}"
            reply = a.cni_server.add(CNIRequest(
                container_id=f"c{k}{i}" * 4,
                extra_args={"K8S_POD_NAME": name,
                            "K8S_POD_NAMESPACE": "default"}))
            if reply.result != 0:
                raise AssertionError(f"CNI add {name}: {reply.error}")
            ips[name] = reply.interfaces[0].ip_addresses[0].address \
                .split("/")[0]
            ksr.sources[km.Pod.TYPE].add(f"default/{name}", km.Pod(
                name=name, namespace="default",
                labels={"app": f"a{k}{i}"}, ip_address=ips[name]))
    ksr.sources[km.Namespace.TYPE].add("default", km.Namespace(
        name="default", labels={}))
    return rt, ksr, ips


def mesh_agent_traffic(rt, ips, n: int, sport0: int):
    """node 0's pod m0-0 toward m1-0 on node 1 (port 5432) and toward
    the ClusterIP (port 80), ``n`` packets a node."""
    a0 = rt.agents[0]
    if0 = a0.dataplane.pod_if[("default", "m0-0")]
    frames = [[] for _ in range(rt.n_nodes)]
    for i in range(n):
        dst, dport = ((ips["m1-0"], 5432) if i % 2 else ("10.96.0.50", 80))
        frames[0].append(dict(src=ips["m0-0"], dst=dst, proto=6,
                              sport=sport0 + i, dport=dport, rx_if=if0))
    return frames


def mesh_agent_phase(seed: int, root: Path, device="cuda"):
    """Phase 4m (ii) (module doc). Returns (summary, launches)."""
    from vpp_tpu_torch.pipeline.snapshot import SessionSnapshotter

    t_phase = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    out = {}
    runs = {}
    for side, dev in (("card", device), ("twin", "cpu")):
        rt, ksr, ips = mesh_agent_runtime(root / side, dev)
        try:
            steps = []
            # through the fabric, then a NetworkPolicy cuts m0 -> m1
            res = rt.step(rt.make_frames(mesh_agent_traffic(rt, ips, 8,
                                                            41000), n=16),
                          now=MESH_AGENT_NOW)
            steps.append(cluster_result_to_numpy(res))
            ksr.sources[km.Service.TYPE].add("default/web", km.Service(
                name="web", namespace="default", cluster_ip="10.96.0.50",
                ports=[km.ServicePort(name="http", protocol="TCP", port=80,
                                      target_port="http")]))
            ksr.sources[km.Endpoints.TYPE].add("default/web", km.Endpoints(
                name="web", namespace="default",
                subsets=[km.EndpointSubset(
                    addresses=[km.EndpointAddress(
                        ip=ips["m1-1"], node_name=rt.agents[1]
                        .config.node_name)],
                    ports=[km.EndpointPort(name="http", port=8080,
                                           protocol="TCP")])]))
            res = rt.step(rt.make_frames(mesh_agent_traffic(rt, ips, 8,
                                                            42000), n=16),
                          now=MESH_AGENT_NOW + 1)
            steps.append(cluster_result_to_numpy(res))
            ksr.sources[km.Policy.TYPE].add("default/cut", km.Policy(
                name="cut", namespace="default",
                pods=km.LabelSelector(match_labels={"app": "a10"}),
                policy_type=km.POLICY_INGRESS, ingress_rules=[]))
            res = rt.step(rt.make_frames(mesh_agent_traffic(rt, ips, 8,
                                                            43000), n=16),
                          now=MESH_AGENT_NOW + 2)
            steps.append(cluster_result_to_numpy(res))
            state = mesh_state(rt.cluster)
            s = steps
            if not (int(s[0]["fabric_sent"].sum())
                    and int(s[1]["stats.dnat"][0]) == 4
                    and int(s[2]["stats.drop_acl"].sum()) == 4):
                raise AssertionError(f"mesh agent {side}: fabric, service "
                                     f"or policy cut did not happen")
            # frames into node 0's rings, out of node 1's
            pump = rt.cluster_pump
            codec = PacketCodec(snap=PUMP_SNAP)
            if0 = rt.agents[0].dataplane.pod_if[("default", "m0-0")]
            scratch = np.zeros((VEC, PUMP_SNAP), np.uint8)
            lens = np.zeros(VEC, np.uint32)
            sent = 0
            t0 = time.perf_counter()
            for j in range(MESH_AGENT_FRAMES):
                for i in range(VEC):
                    f = wire_frame(ip4(ips["m0-0"]), ip4(ips["m1-1"]),
                                   30000 + (j * VEC + i) % 30000, 5433,
                                   j * VEC + i)
                    scratch[i, :len(f)] = np.frombuffer(f, np.uint8)
                    lens[i] = len(f)
                cols, k = codec.parse_inplace(scratch, lens, VEC, if0)
                while not rt.ring_pairs[0].rx.push(cols, k,
                                                   payload=scratch):
                    time.sleep(0.0005)
                sent += k
            got, keys = 0, []
            deadline = time.monotonic() + PUMP_DEADLINE
            while got < sent and time.monotonic() < deadline:
                fr = rt.ring_pairs[1].tx.peek()
                if fr is None:
                    time.sleep(0.001)
                    continue
                live = np.nonzero(fr.cols["disp"][:fr.n]
                                  == int(Disposition.LOCAL))[0]
                got += len(live)
                keys += [frame_key(bytes(fr.payload[i]))[:5] for i in live]
                rt.ring_pairs[1].tx.release()
            secs = time.perf_counter() - t0
            if got != sent:
                raise AssertionError(f"mesh agent {side}: {got} of {sent} "
                                     f"frames left node 1's ring")
            lat = pump.latency_us()
            pages = {cmd: DebugCLI(rt.agents[0].dataplane,
                                   mesh_runtime=rt).run(cmd)
                     for cmd in ("show mesh", "show partitions")}
            # a snapshot, its restore on the same geometry and its
            # refusal on another
            snap = SessionSnapshotter(rt.cluster, str(root / side / "snap"),
                                      chunk_buckets=1 << 12)
            if snap.snapshot() != 1:
                raise AssertionError("the mesh snapshot failed")
            same = ClusterDataplane(rt.mesh, rt.cluster.config)
            for k in range(rt.n_nodes):
                same.node(k).add_uplink()
            same.swap()
            if not SessionSnapshotter(same, str(root / side / "snap"))\
                    .restore_into():
                raise AssertionError("same-geometry restore refused")
            for f in SESSION_FIELDS:
                if f.endswith("_time"):
                    continue
                if not torch.equal(getattr(same.tables, f).cpu(),
                                   getattr(rt.cluster.tables, f).cpu()):
                    raise AssertionError(f"restored {f} differs")
            other = ClusterDataplane(cluster_mesh(
                MESH_AGENT[0], 1, [dev] * MESH_AGENT[0]),
                rt.cluster.config)
            for k in range(other.n_nodes):
                other.node(k).add_uplink()
            other.swap()
            _, outcome = SessionSnapshotter(
                other, str(root / side / "snap")).restore()
            if outcome != "geometry":
                raise AssertionError(f"another geometry restored: "
                                     f"{outcome}")
            runs[side] = dict(steps=steps, keys=sorted(keys), state=state)
            out[side] = dict(frames=MESH_AGENT_FRAMES, pkts=sent,
                             seconds=secs, mpps=sent / secs / 1e6,
                             step_p50_us=lat["p50"], step_p99_us=lat["p99"],
                             pump_steps=pump.stats["steps"],
                             fabric_pkts=pump.stats["fabric_pkts"],
                             pages={k: v.splitlines()[0]
                                    for k, v in pages.items()})
            say(f"mesh agent {side}: {sent} packets in "
                f"{MESH_AGENT_FRAMES} frames through the ClusterPump in "
                f"{secs:.3f} s ({sent / secs / 1e6:.5f} Mpps), "
                f"{pump.stats['steps']} fabric steps, step p50 / p99 "
                f"{lat['p50']:.1f} / {lat['p99']:.1f} us; "
                f"{pages['show partitions'].splitlines()[0]!r}; snapshot "
                f"restored, another geometry refused")
        finally:
            rt.close()
            ksr.close()
    for k, (a, b) in enumerate(zip(runs["card"]["steps"],
                                   runs["twin"]["steps"])):
        assert_equal(a, b, f"mesh agent step {k} against the CPU twin")
    if runs["card"]["keys"] != runs["twin"]["keys"]:
        raise AssertionError("the frames out of node 1 differ from the "
                             "CPU twin's")
    assert_equal(runs["card"]["state"], runs["twin"]["state"],
                 "mesh agent state against the CPU twin")
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 4m (ii): {out['seconds']:.1f} s; every step, the session "
        f"planes after them and the frames out of node 1 equal the CPU "
        f"twin's; launches {launches}")
    return out, launches


def mesh_phase(cfg: DataplaneConfig, n_rules: int, seed: int,
               errors: Errors):
    """Phase 4m: the cluster on the card, then the mesh agent."""
    t0 = time.perf_counter()
    dump, capture.debug_dump_dir = capture.debug_dump_dir, None
    try:
        clus_sum, launches = mesh_cluster_phase(cfg, n_rules, seed, errors)
        say(f"phase 4m (i): {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory(prefix="vpp_tpu_torch_mesh_") as d:
            agent_sum, agent_launches = mesh_agent_phase(seed, Path(d))
    finally:
        capture.debug_dump_dir = dump
    say(f"phase 4m: {time.perf_counter() - t0:.1f} s")
    return {"cluster": clus_sum, "agent": agent_sum,
            "seconds": time.perf_counter() - t0}, launches


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

    # 4i. the node agent on the card: CNI, KSR, the exposition, a warm
    # restart through the rings, against a CPU twin agent
    agent_sum, agent_launches = agent_phase(cfg, args.seed)

    # 4j. the agent's remote surfaces: a fenced store pair with a
    # failover, KSR from a fake API server, the ML loader, the CLI over
    # its socket; show run on phase 4's dataplane
    remote_sum, remote_launches = remote_phase(cfg, gpu, up, args.seed)

    # 4k. the node's wire: the IO daemon as its own process on the card
    # agent's shared-memory rings, frames from sockets through the card
    # and back out, against a CPU twin; then kernel interfaces where ip(8)
    # may create them
    wire_sum, wire_launches = wire_phase(cfg, args.seed)
    wire_sum["kernel"] = wire_kernel_phase(cfg, args.seed)

    # 4l. the VCL host stack on a card agent (the LD_PRELOAD shim in real
    # children, the admission engine against a CPU twin, RPS, CPS, bulk
    # TCP); the gateway fleet (scale-out rungs against a CPU twin fleet,
    # a live rebalance under FleetPump load)
    vcl_sum = hoststack_phase(args.seed)
    fleet_sum, fleet_launches = fleet_phase(args.seed)
    for k in FLEET_KERNELS:
        if not fleet_launches[k]:
            raise AssertionError(f"the fleet path never launched {k}")

    # 4m. the single-host mesh: a 4 x 2 cluster at the slice's widths on
    # the card (the auto and mxu rungs, budget 0 and an overflowing one)
    # against its CPU twin, timed captured and eager; a 2 x 2 mesh agent
    # runtime with its ClusterPump against a CPU twin runtime
    mesh_sum, mesh_launches = mesh_phase(cfg, n_rules, args.seed, errors)
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
        row["launches_agent"] = agent_launches[name]
        row["launches_remote"] = remote_launches[name]
        row["launches_wire"] = wire_launches[name]
        row["launches_fleet"] = fleet_launches[name]
        row["launches_mesh"] = mesh_launches[name]
        if name == "mxu_first_match":
            row["mesh_shard_operand"] = mesh_sum["cluster"]["shards"]
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
                    "agent": agent_sum,
                    "remote": remote_sum,
                    "wire": wire_sum,
                    "hoststack": vcl_sum,
                    "fleet": fleet_sum,
                    "mesh": mesh_sum,
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
