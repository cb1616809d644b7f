"""DataplanePump: the agent-side bridge between frame rings and the device.

The port's counterpart of ``vpp_tpu/io/pump.py``: its host logic is the
reference's, copied; only the lines that touch the device differ.
Staged pipeline with explicit depth:

  * the **dispatch** stage drains every pending rx frame, coalesces
    them by PACKET COUNT into device batches (VPP's own behavior:
    vector size grows under load), pads to a geometric bucket so the
    program cache stays small, and issues the packed single-transfer
    step WITHOUT waiting — a captured step's replay is asynchronous on
    the full chain (the auto path reads its dispatch flag once a step),
    and batches chain through the session tables device-side. Up to
    ``max_inflight`` dispatched batches ride concurrently before the
    stage backpressures; each batch carries a CUDA event recorded after
    its step;
  * the **adaptive chainer** engages when depth alone can't hide the
    round trip: backlog beyond one full ``max_batch`` bucket folds
    into a ``process_packed_chain`` K-stack — K packed batches in ONE
    dispatch and one fetch. Light load never pays the chain's latency
    (a single frame still dispatches alone at the VEC bucket);
  * **fetch workers** (``fetch_workers``) pull finished batches
    concurrently: each waits on its batch's event (``t_fetch_wait``,
    time hidden behind the other in-flight batches) and then copies the
    result on a stream of its own (``t_fetch``, the only serial cost);
  * the **tx writer** thread re-sequences completed batches back into
    dispatch order, splits them into ring frames, writes the tx ring
    (rewritten headers + disposition + egress interface + peer
    next-hop) and releases the rx slots — in order, as the SPSC ring
    requires. Session-state commit order is already serialized by the
    single dispatch thread, so only delivery needs the reorder buffer.

Frames stay ring-owned while in flight (fr_consume_peek_nth) — their
slot views and payload bytes are stable until the in-order release, so
no payload copy happens on the rx side at all.

Non-IPv4 frames bypass classification and are punted to the host
disposition (the STN punt analog for un-parseable traffic, reference
plugins/contiv/pod.go:375-381).

``mode="persistent"`` serves the latency-floor regime through device
descriptor rings (pipeline/persistent.PersistentPump + io/rings.py
DeviceDescRing): the dispatch loop COMPACTS pending frames into
VEC-packet descriptor slots (several small frames share one slot at
sequential offsets — the 20 B/pkt budget end to end), the ring stager
ships whole windows of slots with ONE copy each, the window program
steps the window's slots through the captured step programs, and the
tx descriptors ride back in the window's ONE result copy — zero
io_callbacks in steady state. Double-buffered windows overlap window
N's writeback with window N+1's refill; the refill stage keeps up to
``max_inflight`` slots queued at the stager. Shutdown is race-free:
the collector only exits once the dispatcher has signalled done AND
the hand-off queue is drained, so a frame submitted during stop() still
reaches the tx writer; frames abandoned mid-flight by stop() are
counted as ``drops_shutdown``, tx-ring-full discards as
``drops_tx_stall``, batches whose device result never came back (loop
death, fetch failure, timeout) as ``drops_error`` (daemon rx overflow
is ``drops_rx_full`` on its side) — the
``vpp_tpu_pump_drops_total{reason=}`` attribution. The ring steps a
private clone of the tables; ``sync_sessions`` and the stop merge graft
its state back into the dataplane's live tensors in place, without an
epoch bump. Trades:

  * frames process one window at a time in submission order — the
    latency-floor regime with window-amortized overhead; peak batch
    throughput still belongs to the dispatch ladder's deep coalesce;
  * side programs serialize behind the ring windows, so the ICMP
    error path stays disabled in this mode, and config swaps RESTART
    the ring (sessions carried over, the window program and the clone
    re-used from the dataplane's ring cache) — detected per-frame via
    ``dp.epoch``.

``warm()`` captures every program the pump will run (each bucket rung,
both tiers on the auto path, the chain shapes, or the ring's window
program) before ``start()`` launches a thread, and the captures run in
``thread_local`` mode (pipeline/capture.py), so a capture a later swap
forces cannot trip over the other threads' event waits.

While the dataplane's packet tracer (``dp.tracer``, trace/tracer.py) is
armed, the dispatch ladder runs unchained and through the unpacked
``process`` step, so the tracer sees one whole ``StepResult`` per
dispatch; the fetch then copies its columns back and the writer pushes
them as columns (slower, and only while debugging).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from vpp_tpu_torch.io.rings import VEC, IORingPair
from vpp_tpu_torch.pipeline.dataplane import (
    _MUTABLE_FIELDS,
    PACKED_IN_ROWS,
    pack_packet_columns,
    unpack_packet_input,
)
from vpp_tpu_torch.pipeline.tables import SESSION_FIELDS
from vpp_tpu_torch.pipeline.transfer import count_device_transfer
from vpp_tpu_torch.pipeline.vector import (
    Disposition,
    packet_vector_from_numpy,
)
from vpp_tpu_torch.testing import faults

log = logging.getLogger("pump")

_SENTINEL = object()

# Drop-cause stats keys — one per attributed loss reason. The
# collector's vpp_tpu_pump_drops_total reason map
# (stats/collector.py PUMP_DROP_REASONS) must stay in lockstep; the
# tools/lint.py --counters pass enforces it, so a
# new drop cause added on either side without its twin fails tier-1.
PUMP_DROP_KEYS = ("drops_rx_full", "drops_tx_stall", "drops_shutdown",
                  "drops_error", "drops_overload",
                  # tenant token-bucket overage dropped ON DEVICE
                  # (DROP_TENANT verdicts, counted off the aux rider);
                  # the reason label is "tenant_quota"
                  "drops_tenant_quota")

# governor ticks a quiet priority lane holds its last p99 observation
# for before reading as no-signal (io/pump.py _gov_observe lane
# discipline — the governor then drifts back to the resting shape)
GOV_PRI_STALE_TICKS = 20

# duck-typed stand-in for rings.Frame: push_packed only reads .cols
# (contiguous column block views), .n and .payload
_IcmpFrame = collections.namedtuple("_IcmpFrame",
                                    ("cols", "n", "epoch", "payload"))

# rings.Frame plus its stable ring-order id (rid = frames ever
# released before it + its pending index — stable for a frame's whole
# lifetime). The express priority lane dispatches OUT of
# ring order, but the SPSC rx ring can only release its oldest slot —
# so the writer marks frames done by rid and releases the contiguous
# done-prefix (_release_done), never a slot whose predecessors are
# still in flight.
_RidFrame = collections.namedtuple(
    "_RidFrame", ("cols", "n", "epoch", "payload", "rid"))

def _fetch_packed(out, aux):
    """Host copies of a dispatched batch's packed rows and aux rows,
    once the batch's event has completed. On the card the copy runs on
    a stream of its own into pinned memory and waits for that stream
    alone: on the default stream it would queue behind every step the
    dispatch thread issued after this batch."""
    if out.device.type != "cuda":
        return out.numpy().copy(), aux.numpy().copy()
    side = torch.cuda.Stream(device=out.device)
    with torch.cuda.stream(side):
        out_h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        aux_h = torch.empty(aux.shape, dtype=aux.dtype, pin_memory=True)
        out_h.copy_(out, non_blocking=True)
        aux_h.copy_(aux, non_blocking=True)
    side.synchronize()
    return out_h.numpy(), aux_h.numpy()


def _fetch_columns(result) -> dict:
    """Host copies of an unpacked step's columns (the tracing path), as
    the ring's tx columns: the rewritten header, the disposition, the
    egress interface, the next hop and the drop cause."""
    pk = result.pkts
    cols = {f: getattr(pk, f) for f in ("src_ip", "dst_ip", "proto",
                                        "sport", "dport", "ttl",
                                        "pkt_len")}
    cols.update(disp=result.disp, tx_if=result.tx_if,
                next_hop=result.next_hop, drop_cause=result.drop_cause)
    out = {k: v.cpu().numpy().copy() for k, v in cols.items()}
    for k in ("src_ip", "dst_ip", "next_hop"):
        out[k] = out[k].view(np.uint32)
    return out


def _done_event(dp):
    """A CUDA event recorded after the work just issued on ``dp``'s
    card (None on the CPU, where a step has finished when it returns)."""
    if dp.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


class DataplanePump:
    def __init__(self, dataplane, rings: IORingPair,
                 poll_s: float = 0.0002,
                 max_batch: int = 2048,
                 depth: int = 8,
                 workers: Optional[int] = None,
                 lat_window: int = 4096,
                 icmp_src_ip: int = 0,
                 mode: str = "dispatch",
                 max_inflight: Optional[int] = None,
                 fetch_workers: Optional[int] = None,
                 chain_k: int = 0,
                 fetch_delay: Union[None, float, Callable] = None,
                 ring_slots: int = 8,
                 ring_windows: int = 2,
                 ring_fault_limit: int = 3,
                 governor=None,
                 priority=None,
                 tenants=None,
                 tenant_quantum: int = 0):
        """``max_batch``: largest coalesced device batch (packets);
        ``max_inflight``: in-flight batches before the dispatch stage
        backpressures (``depth`` is the legacy alias — ``max_inflight``
        wins when both are given);
        ``fetch_workers``: concurrent result fetchers (legacy alias
        ``workers``) — None auto-picks by ``dataplane``'s device, the
        reference's rule: 8 on the card (W workers overlap W waits for
        results), 1 on the CPU (a fetch is a local copy and extra
        blocked threads only churn the GIL against the dispatch and
        writer threads).
        ``chain_k``: >= 2 arms the adaptive chainer — backlog past one
        full ``max_batch`` bucket folds into ONE
        ``process_packed_chain`` dispatch of K stacked buckets, K a
        power of two up to ``chain_k`` (rounded down to a power of
        two): the rung ladder bounds the program cache to log2(chain_k)
        chain shapes while a partial fold never pads more than 2× its
        real depth. 0/1 disables chaining.
        ``fetch_delay``: fault injection for tests/bench — seconds (or
        ``callable(seq) -> seconds``) slept by the fetch worker before
        touching the device result, simulating a slow result transport.
        ``icmp_src_ip``: with a non-zero address (the node's pod gateway
        IP), TTL-expired and no-route drops generate ICMP
        time-exceeded/net-unreachable back to the sender (io/icmp.py;
        VPP's ip4-icmp-error node).
        ``mode``: "dispatch" (default, the pipelined ladder) or
        "persistent" (device-resident descriptor rings — module docs).
        ``ring_slots``/``ring_windows``: persistent-mode device-ring
        geometry (frames per window / staging double-buffers —
        io/rings.py DeviceDescRing; config-static shape like
        ``sess_ways``, knobs ``io.io_ring_slots``/``io.io_ring_windows``
        in cmd/config.py).
        ``ring_fault_limit``: degraded-mode escape hatch (knob ``io.io_ring_fault_limit``): after this many resident-ring
        deaths over the pump's lifetime, persistent mode FALLS BACK to
        the dispatch ladder instead of relaunching the ring forever —
        a wedged device-ring path (driver fault, transfer errors) then
        degrades to the slower-but-working mode and the
        ``vpp_tpu_degraded{component="ring"}`` gauge says so. 0
        disables the fallback entirely: the ring relaunches forever,
        paced by a jittered backoff.
        ``governor``: optional io/governor.py LatencyGovernor — the closed-loop SLO controller; the pump binds it to its
        geometry, ticks it on the dispatch thread, applies its window
        fill / in-flight / coalesce limits host-side, and sheds bulk
        admission in brownout as attributed ``drops_overload``.
        ``priority``: optional PriorityFilter designating reflex
        flows: they form their own coalesce groups, preempt bulk
        windows in the ring staging path, and are never shed.
        ``tenants``: optional tenancy/sched.py TenantClassifier
        — bulk frames are lane-classified per tenant at
        the scan frontier and dequeued WEIGHTED-FAIR (virtual-time
        WFQ over per-tenant queues), so one tenant's backlog cannot
        starve the rest; in governor brownout the pump sheds from the
        tenant with the most backlog per unit weight (the hog)
        instead of FIFO order, attributed ``drops_overload`` with
        per-tenant accounting. The priority lane still outranks every
        tenant queue (reflexes first), and tenant groups are
        single-tenant so shedding/attribution stay clean (the chain
        folder stays disengaged under tenant scheduling).
        ``tenant_quantum``: cap (packets) on one tenant's WFQ service
        take (0 = a full slot/batch, the throughput shape). A WFQ
        delay bound scales with the service quantum x active lanes,
        so a smaller quantum bounds how long a light tenant's frame
        sits behind another tenant's bulk inside the shared window
        pipeline — at the cost of more window exchanges per delivered
        packet (the same latency/throughput dial as the ring fill;
        ``io.io_tenant_quantum``)."""
        if mode not in ("dispatch", "persistent"):
            raise ValueError(f"unknown pump mode {mode!r}")
        self.mode = mode
        self.dp = dataplane
        self.rings = rings
        self.poll_s = poll_s
        if fetch_workers is not None:
            workers = fetch_workers
        if workers is None:
            workers = 1 if dataplane.device.type == "cpu" else 8
        self.max_inflight = int(max_inflight if max_inflight is not None
                                else depth)
        chain_k = int(chain_k)
        # round down to a power of two: the chain rung ladder is
        # K ∈ {2, 4, …, chain_k} and a non-pow2 cap would add a rung
        # no fold ever uses
        self.chain_k = (1 << (chain_k.bit_length() - 1)) \
            if chain_k >= 2 else 0
        self._fetch_delay = fetch_delay
        self.icmp = None
        self._icmp_scratch = None
        if icmp_src_ip and mode == "persistent":
            log.warning("persistent pump mode: ICMP error generation "
                        "disabled (side programs park behind the "
                        "resident loop)")
            icmp_src_ip = 0
        if icmp_src_ip:
            from vpp_tpu_torch.io.icmp import IcmpErrorGen

            self.icmp = IcmpErrorGen(icmp_src_ip, VEC, rings.tx.snap)
            self._icmp_scratch = np.zeros((VEC, rings.tx.snap), np.uint8)
            # built error batches queued to the error-path thread (its
            # device round trips must not block the tx writer); bounded
            # — overflow counts as rate-limit suppression
            self._icmp_q: "queue.Queue" = queue.Queue(maxsize=8)
        # native fast-path scratch (single dispatch / single tx-writer
        # thread each, so plain reuse is safe): per-batch frame base
        # pointers + counts for pio_pack_batch, per-frame drop causes
        # out of pio_unpack_to_slot
        self._pack_bases = np.zeros(rings.rx.ring.n_slots, np.uint64)
        self._pack_ns = np.zeros(rings.rx.ring.n_slots, np.uint32)
        self._cause = np.zeros(VEC, np.int32)
        self._icmp_cause = np.zeros(VEC, np.int32)
        self.max_batch = max(VEC, int(max_batch))
        # geometric bucket ladder VEC, 4·VEC, 16·VEC, … up to max_batch:
        # a partial backlog pads to the next bucket, not straight to
        # max_batch — padding is wasted boundary bytes (a 10-frame
        # backlog padded to 16384 uploads 6× the useful data), and on a
        # transfer-limited transport that waste IS lost throughput.
        # Cost: one extra capture per rung (capture ahead via
        # ``bucket_sizes()``).
        self.buckets = []
        b = VEC
        while b < self.max_batch:
            self.buckets.append(b)
            b *= 4
        self.buckets.append(self.max_batch)
        self.workers = max(1, int(workers))
        self.stats = {
            "frames": 0, "pkts": 0, "batches": 0, "tx_ring_full": 0,
            "max_coalesce": 0, "batch_errors": 0,
            # cumulative seconds per stage (profiling; `show io` /
            # bench read these to attribute wire-path time). t_fetch
            # is the serial result COPY; t_fetch_wait is the wait for
            # the device result to become ready — time overlapped with
            # the other in-flight batches, not a serial path cost.
            "t_pack": 0.0, "t_dispatch": 0.0, "t_fetch": 0.0,
            "t_fetch_wait": 0.0, "t_write": 0.0,
            # overlap occupancy: batches dispatched but not yet written
            # (the ladder's live depth) + high-water mark, and how often
            # the adaptive chainer folded backlog into one K-stack
            "inflight": 0, "inflight_peak": 0,
            "chain_batches": 0, "chain_k_peak": 0,
            # two-tier dispatch (pipeline/graph.py pipeline_step_auto):
            # dispatches fully served by the classify-free fast kernel
            # (a chain fold counts ONCE, and only when every sub-batch
            # went fast — comparable to "batches"), plus the raw
            # session-hit/alive packet accumulators behind the
            # fastpath_hit_pct gauge (hits/alive is the regime signal —
            # WHY batches do or don't dispatch fast)
            "fastpath_batches": 0, "fastpath_hits": 0, "fastpath_alive": 0,
            # session-table pressure riders (aux rows 3/4): inserts that
            # lost the intra-batch way election (retried next packet)
            # and ways reclaimed by eviction (expired + victim, both
            # tables) — the set-associative table's congestion signals,
            # delivered in the SAME fetch as the packed results
            "sess_insert_fails": 0, "sess_evictions": 0,
            # per-packet ML stage riders (aux rows 5..7):
            # packets scored / flagged / dropped by the model across
            # every dispatch form (packed, chained, device-ring) — the
            # packed paths never fetch StepStats, so the marking
            # signal rides the same aux fetch as the fastpath rows
            "ml_scored": 0, "ml_flagged": 0, "ml_drops": 0,
            # device-telemetry riders (aux rows 8/9):
            # packets whose wire latency the device histogrammed, and
            # packets folded into the heavy-hitter flow sketch — both
            # 0 with dataplane.telemetry off
            "tel_observed": 0, "tel_sketched": 0,
            # drops by CAUSE (packets; where persistent-mode loss
            # happened):
            # tx_stall = tx-ring-full discards by the writer,
            # shutdown = frames abandoned mid-flight by stop(),
            # error = a dispatched batch whose result never came back
            # (loop death, fetch failure, result timeout — counted
            # where the writer releases the frames unwritten),
            # rx_full = rx-ring overflow — counted by the IO daemon
            # (io/daemon.py drops_rx_full; the pump's own key stays 0
            # and exists so the vpp_tpu_pump_drops_total{reason=}
            # family always exports every reason),
            # overload = bulk frames the latency governor refused at
            # admission in brownout (shedding is explicit
            # and attributed, never silent queue growth)
            "drops_tx_stall": 0, "drops_shutdown": 0, "drops_rx_full": 0,
            "drops_error": 0, "drops_overload": 0,
            # tenancy: device token-bucket drops + slice
            # insert failures off aux rows 10/11, and tenant
            # classifications the pump.tenant_starve fault seam
            # demoted to the default tenant (chaos testing)
            "drops_tenant_quota": 0, "tenant_sess_quota_fails": 0,
            "tenant_starved": 0,
            # priority lane: frames/packets classified into
            # the reflex lane by the PriorityFilter, windows the ring
            # stager shipped early for one (synced from the
            # PersistentPump), and priority marks the
            # "pump.priority_starve" fault seam demoted to bulk
            "priority_frames": 0, "priority_pkts": 0,
            "priority_preempts": 0, "priority_starved": 0,
            # express-vs-bulk service order under tenant lanes
            #: WFQ bulk-frame admissions at the most recent
            # express take — diagnostics, not exported
            "priority_admit_bulk_seq": 0,
            # device-ring telemetry (persistent mode; synced from the
            # PersistentPump by the collect loop + at stop-merge):
            # windows exchanged, frames staged, live in-flight windows,
            # dispatched-minus-written-back windows (tx writeback lag),
            # and host callbacks made by the device program — the ring
            # steady state makes NONE (io_callbacks stays 0); the
            # stager's host seconds and the dispatch flags it read
            "ring_windows": 0, "ring_frames": 0, "ring_inflight": 0,
            "ring_lag": 0, "io_callbacks": 0, "t_stage": 0.0,
            "host_reads": 0,
        }
        # dispatch→tx latency of recent batches, seconds (experienced
        # added latency of the device leg; ring-wait not included — the
        # bench measures full ring-to-ring with its own timestamps).
        # _lat_lock guards append vs snapshot: iterating a deque while
        # the tx writer appends raises RuntimeError (reachable from the
        # CLI's `show io` → latency_us()). It also guards the
        # concurrent-writer stats (t_fetch*, inflight*): += is a
        # load/add/store that interleaves across fetch workers.
        self.batch_lat = collections.deque(maxlen=lat_window)
        # the reflex lane's own dispatch→tx latency window:
        # the governor steers on THIS distribution when a priority
        # filter is attached — the SLO protects reflex traffic, so
        # bulk batching latency must not drive the control loop into
        # brownout while the lane itself meets the SLO. _pri_total
        # counts appends so the observer can tell fresh samples from
        # a quiet lane.
        self.pri_lat = collections.deque(maxlen=1024)
        self._pri_total = 0
        self._lat_lock = threading.Lock()
        # optional Prometheus Histogram (stats/collector.py set_pump):
        # every batch latency is observed as a real distribution —
        # histogram_quantile() aggregates across nodes where the
        # p50/p99 window gauges cannot
        self.latency_hist = None
        # optional Histogram (vpp_tpu_fastpath_batch_seconds): the
        # dispatch→tx latency of batches the classify-free kernel
        # served — the measured fast-tier distribution next to the
        # all-batches one above
        self.fastpath_hist = None
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=self.max_inflight)
        # express fast path through the fetch stage: the
        # fetch workers drain this queue FIRST, so a priority batch
        # waits for at most the fetch already in progress — never for
        # the whole FIFO of queued bulk fetches
        self._inflight_pri: "queue.Queue" = queue.Queue(
            maxsize=self.max_inflight)
        # live fetch workers (under _lat_lock): the tx writer's
        # shutdown rescue engages only once every fetcher has exited
        self._fetchers_live = 0
        self._done: dict = {}               # seq -> completed batch
        self._done_cv = threading.Condition()
        self._seq = 0
        # guards the rid bookkeeping shared by dispatch (takes) and
        # the tx writer (completions + in-order releases). A release
        # shifts every pending index down, but rids are stable:
        # rid = _consumed_base + pending index.
        #   _taken      rids routed into a group (incl. queued express)
        #   _done_rids  rids completed by the writer, awaiting their
        #               turn in the ring-order release prefix
        #   _express    priority rids awaiting express dispatch (also
        #               in _taken so bulk takes skip them)
        #   _scan_rid   classification frontier: every pending frame
        #               below it has been lane-classified exactly once
        self._held_lock = threading.Lock()
        self._taken: set = set()
        self._done_rids: set = set()
        self._express: "collections.deque" = collections.deque()
        self._consumed_base = 0
        self._scan_rid = 0
        # the tx frame ring is SPSC: its reserve/commit protocol
        # permits ONE producer. The in-order writer and the ICMP
        # error-path thread both push, so their pushes serialize here.
        self._tx_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []
        # persistent mode (module docs): the resident-loop handle, the
        # table epoch it was started against, the FIFO tying each
        # submitted frame to the loop's (ordered) result stream, and
        # the dispatch-done event the collector's exit is gated on
        #
        self._ppump = None
        self._persist_epoch = -1
        self._persist_q: "queue.Queue" = queue.Queue(
            maxsize=self.max_inflight)
        self._persist_dispatch_done = threading.Event()
        # device-ring geometry (persistent mode) + the accumulator the
        # live PersistentPump counters fold into across epoch restarts
        self.ring_slots = int(ring_slots)
        self.ring_windows = int(ring_windows)
        self._ring_accum = {"ring_windows": 0, "ring_frames": 0,
                            "io_callbacks": 0, "priority_preempts": 0,
                            # the stager's host seconds and the dispatch
                            # flags it read to the host (auto path)
                            "t_stage": 0.0, "host_reads": 0}
        # reflex-plane latency governor + priority lane
        # (io/governor.py). The governor is HOST-SIDE ONLY: it shapes
        # window fill / in-flight depth / coalesce caps and admission
        # — all values the device programs already take dynamically —
        # so a governed pump traces ZERO new step variants
        # (no new capture). Ticked on the
        # dispatch thread; a crashed governor wedges itself and the
        # pump keeps the last-known window shape.
        self.governor = governor
        self.priority = priority
        # tenancy lanes (vpp_tpu_torch/tenancy/sched.py): the
        # classifier routes bulk frames into per-tenant WFQ queues at
        # the scan frontier; per-tenant host counters live under
        # _lat_lock, the scheduler itself under _held_lock (it extends
        # the rid bookkeeping).
        self.tenants = tenants
        self._tnt_sched = None
        if tenants is not None:
            from vpp_tpu_torch.tenancy.sched import TenantScheduler

            self._tnt_sched = TenantScheduler(tenants.weights)
        self.tenant_quantum = int(tenant_quantum) if tenant_quantum \
            else 0
        self.tenant_io: dict = {}
        self._tnt_admit_frames = 0  # global WFQ admission seq (_lat_lock)
        if governor is not None:
            slots = (self.ring_slots if mode == "persistent"
                     else max(1, self.max_batch // VEC))
            # with a priority lane attached the governor runs in
            # EXPRESS mode: brownout keys off the physical rx queue
            # bound, not the reflex envelope (io/governor.py bind doc)
            governor.bind(slots, self.max_inflight,
                          queue_cap=(rings.rx.ring.n_slots // 2
                                     if priority is not None else None))
        # governor observation state (dispatch-thread only): last
        # device-histogram bins (delta quantiles per tick) and the
        # ring's last cumulative fill snapshot (recent avg occupancy)
        self._gov_bins = None
        self._gov_fill_last = (0, 0)
        self._gov_pri_seen = 0
        # last reflex-lane p99 + how many ticks it has been stale: a
        # quiet lane holds its observation this many ticks, then
        # reads as no-signal (never bulk fallback — lane discipline)
        self._gov_pri_p99: Optional[float] = None
        self._gov_pri_stale = 0
        # ring→dispatch degraded fallback: resident-ring
        # deaths counted over the pump lifetime (dispatch-thread-only,
        # so unlocked); degraded_ring is the one-way flag the
        # collector/CLI read (a plain bool flip — torn reads are
        # impossible and the writer is the single dispatch thread)
        self.ring_fault_limit = int(ring_fault_limit)
        self._ring_faults = 0
        self.degraded_ring = False
        # pacing between ring relaunches (dispatch-thread-only): a
        # ring dying instantly on every relaunch must not hot-spin
        # fault→relaunch→fault — especially with ring_fault_limit=0
        # (retry forever)
        from vpp_tpu_torch.net.backoff import Backoff

        self._ring_backoff = Backoff(base=0.1, cap=5.0)

    def bucket_sizes(self) -> list:
        """The dispatch bucket ladder — capture ``process_packed``
        at each of these batch sizes before offering traffic."""
        return list(self.buckets)

    def warm(self) -> list:
        """Capture every dispatch bucket rung (both tiers on the auto
        path, without stepping the tables: ``Dataplane.prime``), plus
        the chain shapes when the adaptive chainer is armed, then step
        each once on an all-invalid batch, as the reference's warm-up
        does (blocking). Call before ``start()``: a capture taken
        lazily inside the dispatch thread stalls the rx rings, and
        here every capture happens before any pump thread exists.

        Persistent mode: launches the device-ring pump (its start
        captures the window program) and round-trips an all-invalid
        frame through a 1-slot window, so the program is captured and
        hot before traffic is offered."""
        from vpp_tpu_torch.pipeline.dataplane import packed_input_zeros

        if self.mode == "persistent":
            self._persist_start()
            self._ppump.submit(packed_input_zeros(VEC),
                               now=self.dp.clock_ticks())
            self._ppump.result(timeout=300.0)
            return [VEC]
        for bucket in self.buckets:
            self.dp.prime("packed", (PACKED_IN_ROWS, bucket))
            self.dp.process_packed(packed_input_zeros(bucket)).cpu()
        k = 2
        while k <= self.chain_k:
            shape = (k, PACKED_IN_ROWS, self.max_batch)
            self.dp.prime("chain", shape)
            self.dp.process_packed_chain(np.zeros(shape, np.int32)).cpu()
            k *= 2
        return list(self.buckets)

    # --- lifecycle ---
    def start(self) -> "DataplanePump":
        if self.mode == "persistent":
            names = [(self._persist_dispatch_loop, "dp-pump-dispatch"),
                     (self._persist_collect_loop, "dp-pump-collect"),
                     (self._write_loop, "dp-pump-tx")]
        else:
            names = [(self._dispatch_loop, "dp-pump-dispatch"),
                     (self._write_loop, "dp-pump-tx")]
            names += [(self._fetch_loop, f"dp-pump-fetch{i}")
                      for i in range(self.workers)]
            if self.icmp is not None:
                names.append((self._icmp_loop, "dp-pump-icmp"))
        for fn, name in names:
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, join_timeout: Optional[float] = None) -> bool:
        """Stop the pump; returns True when every thread has exited.

        Default join is unbounded: the caller tears the rings down right
        after, and a thread still inside dp.process (a first-batch
        capture takes a while) must not race ring memory being
        freed — that's a use-after-free into shared memory."""
        self._stop.set()
        try:
            self._inflight.put_nowait(_SENTINEL)
        except queue.Full:
            pass  # fetchers are draining; they check _stop per item
        with self._done_cv:
            self._done_cv.notify_all()
        ok = True
        for t in self._threads:
            t.join(timeout=join_timeout)
            ok = ok and not t.is_alive()
        return ok

    # --- overlap occupancy accounting (dispatch + writer + collector) --
    def _inflight_inc(self) -> None:
        with self._lat_lock:
            d = self.stats["inflight"] + 1
            self.stats["inflight"] = d
            if d > self.stats["inflight_peak"]:
                self.stats["inflight_peak"] = d

    def _inflight_dec(self) -> None:
        with self._lat_lock:
            self.stats["inflight"] -= 1

    # --- dispatch: rx ring -> device (async) ---
    def _frame_priority(self, f) -> bool:
        """Classify one rx frame into the reflex lane
        (io/governor.py PriorityFilter). The "pump.priority_starve"
        fault seam demotes a matched frame to bulk — the chaos suite
        proves starved priority traffic is still CONSERVED (delivered
        or attributed), just unprioritized."""
        if self.priority is None:
            return False
        if not self.priority.frame_match(f):
            return False
        try:
            faults.fire("pump.priority_starve")
        except faults.FaultInjected:
            # dispatch-thread-only counter (like stats["batches"]);
            # re-peeked frames may re-classify, so this counts starve
            # EVENTS, not distinct frames
            self.stats["priority_starved"] += 1
            return False
        return True

    def _frame_tenant(self, f) -> int:
        """Classify one bulk frame into its tenant lane.
        The "pump.tenant_starve" fault seam demotes a frame to the
        DEFAULT tenant — it loses its weighted lane (schedulable and
        sheddable as tenant 0) but is still CONSERVED, which the chaos
        schedule proves."""
        try:
            faults.fire("pump.tenant_starve")
        except faults.FaultInjected:
            # dispatch-thread-only counter (like priority_starved)
            self.stats["tenant_starved"] += 1
            return 0
        return self.tenants.frame_tenant(f)

    def _scan_express(self, rx, hold_cap: int) -> None:
        """Advance the lane-classification frontier over newly arrived
        frames: priority ones to the express queue, and —
        with a TenantClassifier attached — every other
        frame into its tenant's WFQ queue. Each frame is classified
        exactly ONCE (the frontier is monotone in rid); lane-routed
        rids are marked taken immediately so bulk takes skip them.
        The frontier STALLS (resumes next round) while the lanes hold
        ``hold_cap`` rids, so a burst backpressures the producer
        instead of marking every ring slot taken at once.
        Classification runs OUTSIDE _held_lock — the frame cannot be
        released before it is taken and completed, so its views are
        stable, and the tx writer's release path must not wait out
        numpy matching. No-op without a priority filter or tenant
        classifier."""
        if self.priority is None and self.tenants is None:
            return
        while True:
            with self._held_lock:
                # the taken+done bound matters only for PURE tenant
                # lanes, where the scan marks EVERY frame taken as it
                # routes it: without it a burst would claim the whole
                # ring at once. It must NOT gate any config with a
                # priority filter — the express lane's contract is to
                # classify and jump the bulk queue precisely while
                # bulk holds the ring at its cap, and the
                # frontier is monotone, so stalling it on bulk
                # occupancy would make reflex CLASSIFICATION
                # bulk-service-bound. With both lanes attached the
                # WFQ queues stay bounded by the rx ring itself.
                if (len(self._express) >= hold_cap
                        or (self.tenants is not None
                            and self.priority is None
                            and len(self._taken) + len(self._done_rids)
                            >= hold_cap)):
                    return
                base = self._consumed_base
                rid = max(self._scan_rid, base)
                if rid >= base + rx.pending():
                    return
                f = rx.peek_nth(rid - base)
                if f is None:
                    return
                self._scan_rid = rid + 1
            if self.priority is not None and self._frame_priority(f):
                with self._held_lock:
                    self._taken.add(rid)
                    self._express.append(rid)
                self.stats["priority_frames"] += 1
                self.stats["priority_pkts"] += f.n
                continue
            if self.tenants is not None:
                tid = self._frame_tenant(f)
                with self._held_lock:
                    self._taken.add(rid)
                    self._tnt_sched.push(tid, rid, f.n)
                with self._lat_lock:
                    io = self.tenant_io.setdefault(
                        tid, {"frames": 0, "pkts": 0, "shed_pkts": 0,
                              "admitted_pkts": 0})
                    io["frames"] += 1
                    io["pkts"] += f.n

    def _take_express(self, rx):
        """Pop the oldest express rid into a one-frame group, or None.
        The express lane is what actually bounds reflex queueing: a
        priority frame deep behind a bulk backlog is dispatched NOW,
        out of ring order, while its rx slot is released later in
        ring order by the writer's done-prefix. Never refuses a
        queued rid: express rids are already held, so popping frees
        ring slots (dispatch → complete → release) — refusing under
        pressure would wedge exactly the all-priority burst the lane
        exists for."""
        with self._held_lock:
            if not self._express:
                return None
            rid = self._express.popleft()
            f = rx.peek_nth(rid - self._consumed_base)
            if f is None:  # unreachable: taken rids stay pending
                self._taken.discard(rid)
                return None
        if self._tnt_sched is not None:
            with self._lat_lock:
                # express-vs-bulk service ORDER signal (the tenant
                # last_admit_seq analog): how many bulk frames the WFQ
                # lanes had admitted when this reflex frame took
                # service — bounded regardless of bulk backlog depth
                # is the lane's contract, observable poll-free
                self.stats["priority_admit_bulk_seq"] = \
                    self._tnt_admit_frames
        return [_RidFrame(f.cols, f.n, f.epoch, f.payload, rid)]

    def _take_tenant_group(self, rx, max_pkts: Optional[int] = None):
        """Weighted-fair bulk take: serve the tenant with
        the least virtual time one single-tenant coalesce group (its
        queued frames in arrival order, up to ``max_pkts`` packets).
        Returns ``(tid, [group])`` or None. Single-tenant groups keep
        shedding and accounting attributable — the chain folder stays
        disengaged under tenant scheduling. ``tenant_quantum`` caps
        the take (the WFQ delay-bound dial — ctor doc)."""
        if max_pkts is None:
            max_pkts = self.max_batch
        if self.tenant_quantum:
            max_pkts = min(max_pkts, self.tenant_quantum)
        with self._held_lock:
            tid = self._tnt_sched.pick()
            if tid is None:
                return None
            group = self._pop_tenant_group_locked(rx, tid, max_pkts)
        if not group:
            return None
        with self._lat_lock:
            io = self.tenant_io.setdefault(
                tid, {"frames": 0, "pkts": 0, "shed_pkts": 0,
                      "admitted_pkts": 0})
            io["admitted_pkts"] += sum(f.n for f in group)
            # monotone frame-admission sequence across ALL tenants,
            # stamped per tenant at its most recent WFQ take: a
            # poll-free service-ORDER signal (tenant A's last_admit_seq
            # minus its own admitted frames = frames other tenants got
            # before A finished — how the fairness test proves WFQ vs
            # FIFO without racing a snapshot against the drain).
            # Untakes (ring-fault requeue) do not rewind it: it orders
            # admissions, it does not conserve them.
            self._tnt_admit_frames += len(group)
            io["last_admit_seq"] = self._tnt_admit_frames
        return tid, [group]

    def _pop_tenant_group_locked(self, rx, tid: int,
                                 max_pkts: int) -> list:
        """Dequeue up to ``max_pkts`` packets of ``tid`` from its WFQ
        queue into a ``_RidFrame`` group (the shared body of the take
        and shed paths — caller holds ``_held_lock``)."""
        frames = self._tnt_sched.pop(tid, max_pkts)
        base = self._consumed_base
        group = []
        for rid, _n in frames:
            f = rx.peek_nth(rid - base)
            if f is None:  # unreachable: taken rids stay pending
                self._taken.discard(rid)
                continue
            group.append(_RidFrame(f.cols, f.n, f.epoch, f.payload,
                                   rid))
        return group

    def _untake_tenant(self, tid: int, frames: list) -> None:
        """Return un-dispatched tenant frames to the HEAD of their WFQ
        queue (the ring-fault fallback path): the scan frontier is
        monotone, so a plain untake would orphan them below it."""
        with self._held_lock:
            self._tnt_sched.requeue_front(
                tid, [(f.rid, f.n) for f in frames])
        with self._lat_lock:
            io = self.tenant_io.get(tid)
            if io is not None:
                io["admitted_pkts"] -= sum(f.n for f in frames)

    def _shed_tenant(self, rx) -> bool:
        """Brownout shedding under tenant lanes: refuse one
        group from the tenant with the MOST backlog per unit weight —
        per-tenant-weighted shedding, never FIFO — attributed
        ``drops_overload`` plus the per-tenant ledger. Returns False
        with nothing queued (the caller falls through to take/idle)."""
        with self._held_lock:
            tid = self._tnt_sched.shed_pick()
            if tid is None:
                return False
            group = self._pop_tenant_group_locked(rx, tid, self.max_batch)
        if not group:
            return False
        with self._lat_lock:
            io = self.tenant_io.setdefault(
                tid, {"frames": 0, "pkts": 0, "shed_pkts": 0,
                      "admitted_pkts": 0})
            io["shed_pkts"] += sum(f.n for f in group)
        self._post_batchless([group], "drops_overload")
        return True

    def tenant_io_snapshot(self) -> dict:
        """Per-tenant IO-side counters + live queue state + weights
        (host scalars; the collector/CLI read)."""
        with self._lat_lock:
            io = {t: dict(v) for t, v in self.tenant_io.items()}
        queued = {}
        if self._tnt_sched is not None:
            with self._held_lock:
                queued = self._tnt_sched.snapshot()
        weights = dict(self.tenants.weights) if self.tenants else {}
        names = dict(self.tenants.names) if self.tenants else {}
        return {"io": io, "queued": queued, "weights": weights,
                "names": names}

    def _take_groups(self, rx, hold_cap: int, chain_cap: int,
                     max_pkts: Optional[int] = None) -> list:
        """Peek pending BULK frames (in ring order, skipping rids the
        express lane took) into coalesce groups by PACKET count: a
        group closes when the next frame would overflow ``max_pkts``
        packets (default ``max_batch``; persistent mode compacts at
        the VEC descriptor-slot width). One group = one packed batch;
        2+ groups = the chainer has a K-stack to fold. With a
        priority filter attached, only frames below the
        classification frontier are takeable (scan runs first each
        loop). Holds _held_lock across the whole peek block (a
        concurrent writer release shifts pending indices)."""
        if max_pkts is None:
            max_pkts = self.max_batch
        with self._held_lock:
            base = self._consumed_base
            pending = rx.pending()
            end_rid = (min(self._scan_rid, base + pending)
                       if self.priority is not None else base + pending)
            budget = hold_cap - len(self._taken) - len(self._done_rids)
            groups, cur, cur_n = [], [], 0
            rid = base
            while rid < end_rid and budget > 0 \
                    and len(groups) < chain_cap:
                if rid in self._taken or rid in self._done_rids:
                    rid += 1
                    continue
                f = rx.peek_nth(rid - base)
                if f is None:
                    break
                if cur and cur_n + f.n > max_pkts:
                    groups.append(cur)
                    cur, cur_n = [], 0
                    continue
                cur.append(_RidFrame(f.cols, f.n, f.epoch, f.payload,
                                     rid))
                cur_n += f.n
                budget -= 1
                rid += 1
            if cur and len(groups) < chain_cap:
                groups.append(cur)
            if len(groups) > 1:
                # trim to the largest chain rung ≤ the fold (a power
                # of two — the captured ladder); untrimmed groups
                # stay pending for the next dispatch
                groups = groups[:1 << (len(groups).bit_length() - 1)]
            for g in groups:
                for f in g:
                    self._taken.add(f.rid)
        return groups

    def _untake_any(self, frames: list, priority: bool,
                    tenant) -> None:
        """Route an un-dispatch to the right lane's untake: express
        rids back to the express head, tenant rids back to their WFQ
        queue head (a plain untake would orphan them below the
        monotone scan frontier), plain bulk rids simply untaken."""
        if tenant is not None:
            self._untake_tenant(tenant, frames)
        else:
            self._untake(frames, priority)

    def _untake(self, frames: list, priority: bool = False) -> None:
        """Return un-dispatched frames to the takeable pool (the
        ring-fault fallback path): bulk rids simply become untaken
        (the front scan re-takes them in order); express rids go back
        to the HEAD of the express queue, still marked taken."""
        with self._held_lock:
            if priority:
                self._express.extendleft(f.rid for f in reversed(frames))
            else:
                for f in frames:
                    self._taken.discard(f.rid)

    def _release_done(self, groups: list) -> None:
        """Writer-side completion: mark every frame done by rid, then
        release the CONTIGUOUS done-prefix to the rx ring — the SPSC
        ring only frees its oldest slot, and the express lane may
        complete rids out of order, so a done frame waits for its
        predecessors (its slot views stay valid exactly because the
        release is deferred)."""
        with self._held_lock:
            for g in groups:
                for f in g:
                    self._done_rids.add(f.rid)
                    self._taken.discard(f.rid)
            while self._consumed_base in self._done_rids:
                self._done_rids.discard(self._consumed_base)
                self.rings.rx.release()
                self._consumed_base += 1

    def _backlog(self) -> int:
        """Frames pending in the rx ring that no lane has DISPATCHED
        yet — the governor's queue-depth observation. Tenant-queued
        frames are marked taken at the scan frontier but still wait
        for service, so they count back in."""
        with self._held_lock:
            queued = (self._tnt_sched.total_frames
                      if self._tnt_sched is not None else 0)
            return (self.rings.rx.pending() - len(self._taken)
                    - len(self._done_rids) + queued)

    def _post_batchless(self, groups: list, drop_key: str) -> None:
        """Hand frames to the writer as a BATCHLESS done-item (no tx
        write — the slots still complete and release in ring order)
        with the loss attributed to ``drop_key`` at the decision
        site. The ONE place the 6-field loss-path done-item is built:
        the writer unpacks all six fields and the express jump
        indexes the pri flag, so the tuple shape is load-bearing."""
        with self._lat_lock:
            self.stats[drop_key] += sum(f.n for g in groups for f in g)
        self._inflight_inc()
        with self._done_cv:
            self._done[self._seq] = (None, groups, None,
                                     time.perf_counter(), False, False)
            self._seq += 1
            self._done_cv.notify_all()

    def _shed_group(self, groups: list) -> None:
        """Overload shedding: refuse a bulk coalesce group
        at admission while the governor is in brownout — explicit,
        attributed shedding, never silent queue growth."""
        self._post_batchless(groups, "drops_overload")

    # --- latency governor (dispatch-thread only) ---
    def _governor_tick(self) -> None:
        """Run one governor control tick when due and push the window
        fill limit to the live ring. The governor itself never raises
        (it wedges one-way after repeated failures — module doc of
        io/governor.py); everything here is host-side shaping, so no
        step variant is ever retraced."""
        gov = self.governor
        if gov is None or not gov.tick_due():
            return
        p99, backlog, delivered, fill_avg = self._gov_observe()
        gov.maybe_tick(p99, backlog, delivered, fill_avg=fill_avg)
        pp = self._ppump
        if pp is not None:
            pp.set_fill_limit(gov.fill)

    def _gov_observe(self) -> tuple:
        """Observation vector for one governor tick: p99 latency (µs)
        — the REFLEX lane's own host window when a priority filter is
        attached and the lane has fresh samples (the SLO protects
        reflex traffic; bulk batching latency must not drive the
        loop), else the device wire-latency histogram's per-tick
        DELTA quantile in persistent mode with telemetry on (the ring
        rider, host scalars only — substrate, no device
        transfer at tick time), else the host batch-latency window —
        plus the un-taken rx backlog (frames), delivered-frame count
        (the service-rate estimator's input) and the ring's recent
        average window fill (the lone-window guard)."""
        p99 = None
        pp = self._ppump
        if self.priority is not None:
            # lane discipline: with a priority filter attached the
            # governor NEVER steers on bulk latency — a quiet lane
            # holds its last observation for a bounded staleness
            # window, then reads as no-signal (the governor drifts
            # back to the resting shape; express-mode brownout still
            # keys off queue pressure). Falling back to the
            # bulk-dominated histogram here would pin the ladder at
            # the floor under pure bulk load with nothing to protect.
            with self._lat_lock:
                total = self._pri_total
                snap = (list(self.pri_lat)
                        if total > self._gov_pri_seen else None)
            if snap:
                self._gov_pri_seen = total
                p99 = float(np.percentile(
                    np.asarray(snap) * 1e6, 99))
                self._gov_pri_p99 = p99
                self._gov_pri_stale = 0
            else:
                self._gov_pri_stale += 1
                if self._gov_pri_stale <= GOV_PRI_STALE_TICKS:
                    p99 = self._gov_pri_p99
        elif (pp is not None
                and getattr(self.dp, "_tel_mode", "off") != "off"):
            try:
                tel = self.tel_snapshot()
            except Exception:  # noqa: BLE001 — observation must never
                # kill the dispatch thread; the host window serves
                tel = None
            if tel is not None:
                from vpp_tpu_torch.ops.telemetry import quantiles_from_bins

                bins = np.asarray(tel["bins"], np.int64)
                prev = self._gov_bins
                delta = (bins - prev if prev is not None
                         and prev.shape == bins.shape else bins)
                self._gov_bins = bins
                if int(delta.sum()) > 0:
                    _p50, p99v, _p999 = quantiles_from_bins(delta)
                    p99 = float(p99v)
        if p99 is None and self.priority is None:
            lat = self.latency_us()
            if lat["n"]:
                p99 = float(lat["p99"])
        backlog = self._backlog()
        delivered = int(self.stats["frames"])
        fill_avg = None
        if pp is not None:
            try:
                self._gov_fill_last, fill_avg = pp.fill_avg(
                    self._gov_fill_last)
            except Exception:  # noqa: BLE001 — a dying ring's stats
                # are not worth a dispatch-thread crash
                fill_avg = None
        return p99, backlog, delivered, fill_avg

    def _dispatch_loop(self) -> None:
        rx = self.rings.rx
        # never hold every slot: the producer needs headroom to keep
        # writing while K batches are in flight
        hold_cap = max(2, rx.ring.n_slots - 4)
        while not self._stop.is_set():
            self._governor_tick()
            tracer = self.dp.tracer
            slow = tracer is not None and getattr(tracer, "_armed", 0) > 0
            # the chainer only engages past one full bucket of backlog
            # (depth alone can't absorb it); tracing runs unchained so
            # the tracer sees one full StepResult per dispatch
            chain_cap = 1 if (slow or not self.chain_k) else self.chain_k
            max_pkts = None
            gov = self.governor
            g_infl = self.max_inflight
            if gov is not None:
                # governed coalesce cap: window fill f maps to f·VEC
                # packets per batch — the dispatch-mode analog of the
                # ring's window fill limit. While shedding, groups are
                # taken one at a time so admission decides per group.
                g_fill, g_infl, shedding = gov.limits()
                max_pkts = max(VEC, min(self.max_batch, g_fill * VEC))
                if shedding:
                    chain_cap = 1
            # express lane first: a priority frame jumps
            # the whole bulk queue — dispatched NOW in its own group,
            # released later in ring order by the done-prefix
            self._scan_express(rx, hold_cap)
            eg = self._take_express(rx)
            if eg is not None:
                self._dispatch_or_fail([eg], slow, pri=True)
                continue
            if self._inflight.full():
                # don't take a bulk group whose hand-off would BLOCK
                # this thread — a blocked put can't scan for express
                # arrivals, and the lane's bound is the scan cadence
                time.sleep(self.poll_s)
                continue
            if self.tenants is not None:
                # tenant lanes: brownout sheds from the
                # hog (backlog/weight max) BEFORE taking, so the
                # weighted-fair take below only ever serves admitted
                # load; the take itself is WFQ — least virtual time
                if gov is not None:
                    if not gov.admit(False, self._backlog()):
                        if self._shed_tenant(rx):
                            continue
                    if self.stats["inflight"] >= g_infl:
                        time.sleep(self.poll_s)
                        continue
                taken = self._take_tenant_group(rx, max_pkts)
                if taken is None:
                    time.sleep(self.poll_s)
                    continue
                self._dispatch_or_fail(taken[1], slow)
                continue
            groups = self._take_groups(rx, hold_cap, chain_cap,
                                       max_pkts)
            if not groups:
                time.sleep(self.poll_s)
                continue
            if gov is not None:
                if not gov.admit(False, self._backlog()):
                    # shedding forces chain_cap=1, so refusal covers
                    # the whole take (exactly one group); the shed
                    # state only flips on THIS thread's ticks, so it
                    # cannot change between limits() and here
                    self._shed_group(groups)
                    continue
                if self.stats["inflight"] >= g_infl:
                    # governed in-flight depth (tighter than the
                    # construction-time queue bound): UNTAKE and
                    # retry instead of sleeping with frames held — a
                    # blocked wait here couldn't scan for express
                    # arrivals, exactly like the full-queue gate above
                    self._untake([f for g in groups for f in g])
                    time.sleep(self.poll_s)
                    continue
            self._dispatch_or_fail(groups, slow)

    def _dispatch_or_fail(self, groups: list, slow: bool = False,
                          pri: bool = False) -> None:
        """Dispatch with the failed-batch contract: on any dispatch
        error the frames go to the writer as a batchless item so rx
        slots still complete (and release in ring order), with the
        loss attributed to drops_error."""
        try:
            self._dispatch(groups, slow, pri=pri)
        except Exception:
            log.exception("pump dispatch failed (%d frames)",
                          sum(len(g) for g in groups))
            self._post_batchless(groups, "drops_error")

    def _pack_group(self, frames: list, flat: np.ndarray,
                    non_ip: np.ndarray) -> None:
        """ONE native call packs every frame's ring slot into a [5, B]
        int32 bit-packed block (dataplane.pack_packet_columns layout,
        20 B/packet) — the pack/mask loop releases the GIL so the
        daemon's rx thread keeps draining its sockets. Bad (non-IPv4/truncated) slots are masked invalid for the
        pipeline; non-IP is punted after the step via ``non_ip``."""
        from vpp_tpu_torch.native.pktio import pack_batch

        for j, f in enumerate(frames):
            self._pack_bases[j] = f.cols["src_ip"].ctypes.data
            self._pack_ns[j] = f.n
        pack_batch(self._pack_bases, self._pack_ns, len(frames), flat,
                   non_ip)

    def _dispatch(self, groups: list, slow: bool = False,
                  pri: bool = False) -> None:
        K = len(groups)
        tp0 = time.perf_counter()
        # rx-enqueue stamp for the device wire-latency histogram
        #: pack start ≈ the frames' peek time in dispatch
        # mode, so the histogram covers pack + the dispatch queue
        stamp_us = 0
        if getattr(self.dp, "_tel_mode", "off") != "off":
            from vpp_tpu_torch.ops.telemetry import tel_clock_us

            stamp_us = tel_clock_us()
        if K == 1:
            total = sum(f.n for f in groups[0])
            # pad to the smallest ladder bucket that fits (each rung is
            # a capture of its own, so the ladder is geometric, not
            # per-size): a single frame dispatches at VEC for latency;
            # larger backlogs climb the rungs
            bucket = next(b for b in self.buckets if b >= total)
            flat = np.zeros((PACKED_IN_ROWS, bucket), np.int32)
            non_ip = np.zeros(bucket, np.uint8)
            self._pack_group(groups[0], flat, non_ip)
        else:
            # chain fold: K stacked max_batch buckets, ONE device
            # program. K is a power of two from the captured rung
            # ladder (``_take_groups`` trimmed to it), so the program
            # cache stays at log2(chain_k) chain shapes.
            flat = np.zeros((K, PACKED_IN_ROWS,
                             self.max_batch), np.int32)
            non_ip = np.zeros((K, self.max_batch), np.uint8)
            for k, g in enumerate(groups):
                self._pack_group(g, flat[k], non_ip[k])
        non_ip = non_ip.view(bool)
        self.stats["t_pack"] += time.perf_counter() - tp0
        t0 = time.perf_counter()
        if slow:
            # tracing: the unpacked step, so the tracer captures a full
            # StepResult (several transfers: fine while debugging)
            out, aux = self.dp.process(packet_vector_from_numpy(
                unpack_packet_input(flat), self.dp.device)), None
        elif K == 1:
            # issued without waiting; (out, aux) with the fast-path
            # summary riding the same program (measured on both tiers)
            out, aux = self.dp.process_packed(flat, with_aux=True,
                                              stamp_us=stamp_us)
        else:
            # ([K,5,B], [K,PACKED_AUX_ROWS])
            out, aux = self.dp.process_packed_chain(
                flat, with_aux=True,
                stamps_us=np.full(K, stamp_us, np.int32))
            self.stats["chain_batches"] += 1
            self.stats["chain_k_peak"] = max(self.stats["chain_k_peak"],
                                             K)
        # the fetch worker waits on this event, not on the device
        payload = (out, aux, _done_event(self.dp))
        self.stats["t_dispatch"] += time.perf_counter() - t0
        # unlocked: the dispatch thread is _seq's only writer, so its
        # own read needs no lock; increments publish under _done_cv
        item = (self._seq, payload, groups, non_ip, t0, slow, pri)
        # count the batch in flight BEFORE the hand-off: a fetch worker
        # can complete it (and the writer decrement it) the instant the
        # put lands, so inc-after-put would transiently read -1
        self._inflight_inc()
        target_q = self._inflight_pri if pri else self._inflight
        while True:
            # bounded put that stays responsive to stop(): the fetchers
            # may already have exited, and a blocking put would deadlock
            # the join
            try:
                target_q.put(item, timeout=0.05)
                break
            except queue.Full:
                if self._stop.is_set():
                    self._inflight_dec()
                    with self._lat_lock:
                        self.stats["drops_shutdown"] += sum(
                            f.n for g in groups for f in g)
                    return
        # under _done_cv like the failed-batch path: the tx writer's
        # shutdown gate compares next_seq against _seq under the cv, so
        # an unlocked increment could be observed stale there
        with self._done_cv:
            self._seq += 1
        self.stats["batches"] += 1
        self.stats["max_coalesce"] = max(self.stats["max_coalesce"],
                                         sum(len(g) for g in groups))

    # --- persistent mode: resident device loop (module docs) ---
    def _persist_start(self) -> None:
        from vpp_tpu_torch.pipeline.persistent import PersistentPump

        with self.dp._lock:
            epoch = self.dp.epoch
            # the ring program of the epoch's selection over the
            # dataplane's private clone (written from the live tables
            # under the lock; pipeline/persistent.py)
            pp = PersistentPump(self.dp, batch=VEC,
                                ring_slots=self.ring_slots,
                                ring_windows=self.ring_windows)
        self._ppump = pp.start()
        if self.governor is not None:
            # a relaunched/restarted ring must resume at the
            # governor's CURRENT window shape, not the full-fill
            # default (the wedged-governor freeze contract included)
            self._ppump.set_fill_limit(self.governor.fill)
        self._persist_epoch = epoch

    def _persist_stop_merge(self) -> None:
        """Exit the ring and graft its final state back into the
        dataplane's live tensors — the ring steps a private clone, so
        by stop time its sessions, telemetry planes, tenancy state and
        ECMP accounting are NEWER than whatever dp.tables holds. The
        graft writes in place (the dataplane's captured programs hold
        its tensors) and does not move the epoch."""
        if self._ppump is None:
            return
        pp = self._ppump
        try:
            final = pp.stop()
        finally:
            # fold the retiring ring's counters into the accumulator
            # EVEN when stop() raises (a dead ring's exchanges still
            # happened), so stats survive epoch restarts and failures
            # without the exported totals jumping backwards
            self._ring_fold(pp)
            self._ppump = None
            self._ring_stats_sync()
        if final is None:
            return
        # every plane a step writes: sessions, telemetry, tenancy
        # state and the ECMP accounting
        self.dp.graft(final, _MUTABLE_FIELDS)

    def _persist_restart(self) -> None:
        """Config epoch moved (dp.swap): the resident loop still holds
        the OLD tables. Drain it (ordered results keep flowing to the
        collector), merge sessions, relaunch against the new epoch —
        the persistent-mode equivalent of the per-dispatch path simply
        reading dp.tables on its next batch."""
        log.info("persistent loop restart: table epoch %d -> %d",
                 self._persist_epoch, self.dp.epoch)
        self._persist_stop_merge()
        self._persist_start()

    def _persist_submit_group(self, frames: list,
                              priority: bool = False,
                              tenant=None) -> str:
        """Pack + submit ONE compacted coalesce group (several small
        frames at sequential offsets of a single VEC descriptor slot —
        the header-compaction half of the 20 B/pkt budget) to the ring
        pump and hand its FIFO ticket to the collector. ``priority``
        marks a reflex-lane group: the ring stager ships its window
        immediately instead of draining backlog into it.
        Returns "ok",
        "stop" when stop() interrupted the hand-off (the frames stay
        held and are counted as shutdown drops; the runtime frees the
        rings next), or "fallback" when repeated ring deaths hit
        ``ring_fault_limit`` (the frames are UN-held — they were never
        ticketed, so the dispatch-mode loop that takes over re-peeks
        and serves them; nothing is dropped by the mode switch
        itself)."""
        tp0 = time.perf_counter()
        # rx-enqueue stamp: taken at pack start so the
        # device-side wire-latency histogram covers pack + submit
        # queueing + window fill + ring backpressure — the whole host
        # leg up to the dispatch the governor (ROADMAP item 3) can
        # actually influence. 0 (unstamped) with telemetry off.
        stamp_us = 0
        if getattr(self.dp, "_tel_mode", "off") != "off":
            from vpp_tpu_torch.ops.telemetry import tel_clock_us

            stamp_us = tel_clock_us()
        flat = np.zeros((PACKED_IN_ROWS, VEC), np.int32)
        non_ip = np.zeros(VEC, np.uint8)
        self._pack_group(frames, flat, non_ip)
        self.stats["t_pack"] += time.perf_counter() - tp0
        t0 = time.perf_counter()
        while True:
            try:
                self._ppump.submit(flat, now=self.dp.clock_ticks(),
                                   stamp_us=stamp_us,
                                   priority=priority)
                if self._ring_backoff.attempt:
                    self._ring_backoff.reset()
                break
            except RuntimeError:
                self._ring_faults += 1
                log.exception("resident loop died (ring fault %d%s)",
                              self._ring_faults,
                              f"/{self.ring_fault_limit}"
                              if self.ring_fault_limit else "")
                self.stats["batch_errors"] += 1
                # fold the dead ring's counters before replacing it, or
                # the exported ring_windows/ring_frames totals would
                # jump backwards (a spurious counter reset for scrapers)
                self._ring_fold(self._ppump)
                self._ppump = None
                if self.ring_fault_limit and \
                        self._ring_faults >= self.ring_fault_limit:
                    self._untake_any(frames, priority, tenant)
                    return "fallback"
                time.sleep(self._ring_backoff.next())
                try:
                    self._persist_start()
                except Exception:  # noqa: BLE001 — a relaunch that
                    # cannot even start IS the wedged-ring case the
                    # fallback exists for, whatever the limit says
                    log.exception("resident loop relaunch failed")
                    self._untake_any(frames, priority, tenant)
                    return "fallback"
        self.stats["t_dispatch"] += time.perf_counter() - t0
        # unlocked: the dispatch thread is _seq's only writer, so its
        # own read needs no lock; increments publish under _done_cv
        item = (self._seq, self._ppump, [frames], non_ip.view(bool), t0,
                priority)
        self._inflight_inc()
        while True:
            try:
                self._persist_q.put(item, timeout=0.05)
                break
            except queue.Full:
                if self._stop.is_set():
                    self._inflight_dec()
                    with self._lat_lock:
                        self.stats["drops_shutdown"] += sum(
                            f.n for f in frames)
                    return "stop"
        # under _done_cv for the same reason as the dispatch-mode bump:
        # the writer's shutdown gate reads _seq under the cv
        with self._done_cv:
            self._seq += 1
        self.stats["batches"] += 1
        self.stats["max_coalesce"] = max(self.stats["max_coalesce"],
                                         len(frames))
        return "ok"

    def _persist_dispatch_loop(self) -> None:
        rx = self.rings.rx
        hold_cap = max(2, rx.ring.n_slots - 4)
        try:
            # INSIDE the try: a failed resident-loop launch (device
            # unavailable, build error) must still set the
            # dispatch-done gate in the finally, or the collector —
            # whose exit requires it — would spin forever and stop()'s
            # unbounded join would hang
            if self._ppump is None:  # warm() may have launched it
                self._persist_start()
            while not self._stop.is_set():
                if self.dp.epoch != self._persist_epoch:
                    self._persist_restart()
                self._governor_tick()
                # refill burst: compact pending frames into VEC-packet
                # descriptor slots and keep up to max_inflight slots
                # (or the governor's tighter in-flight depth) queued
                # at the ring stager before sleeping — whole windows
                # then ship with one transfer each, and the device
                # never idles between windows (the overlap discipline
                # of the r6 ladder, now at window granularity)
                gov = self.governor
                g_infl = self.max_inflight
                if gov is not None:
                    _f, g_infl, _shed = gov.limits()
                    g_infl = min(self.max_inflight, g_infl)
                burst = 0
                while not self._stop.is_set():
                    # express lane first: priority frames
                    # jump the bulk queue entirely — a lone-slot
                    # submit whose window the stager ships at once
                    self._scan_express(rx, hold_cap)
                    eg = self._take_express(rx)
                    if eg is not None:
                        st = self._persist_submit_group(eg,
                                                        priority=True)
                        if st == "stop":
                            return
                        if st == "fallback":
                            self._persist_fallback()
                            return
                        burst += 1
                        continue
                    with self._lat_lock:
                        infl = self.stats["inflight"]
                    if infl >= g_infl:
                        break  # governed depth: outer loop re-ticks
                    tenant = None
                    if self.tenants is not None:
                        # tenant lanes: shed from the hog
                        # before serving, then WFQ-take one
                        # single-tenant VEC-compacted group
                        if gov is not None and \
                                not gov.admit(False, self._backlog()):
                            if self._shed_tenant(rx):
                                continue
                        taken = self._take_tenant_group(rx,
                                                        max_pkts=VEC)
                        if taken is None:
                            break
                        tenant, tg = taken
                        groups = tg
                    else:
                        groups = self._take_groups(rx, hold_cap, 1,
                                                   max_pkts=VEC)
                        if not groups:
                            break
                        if gov is not None and \
                                not gov.admit(False, self._backlog()):
                            # brownout: bulk beyond the SLO's queue
                            # budget is dropped at admission,
                            # attributed — a shed costs no device trip
                            self._shed_group(groups)
                            continue
                    st = self._persist_submit_group(groups[0],
                                                    tenant=tenant)
                    if st == "stop":
                        return
                    if st == "fallback":
                        self._persist_fallback()
                        return
                    burst += 1
                    if burst >= g_infl:
                        break
                if burst == 0:
                    # idle: a ring death with nothing left to submit
                    # would otherwise never be counted (frames compact
                    # into few submits, and the death lands AFTER the
                    # last successful one) — poll the ring's health so
                    # the fault ladder advances regardless
                    if self._ring_check() == "fallback":
                        self._persist_fallback()
                        return
                    time.sleep(self.poll_s)
        finally:
            # signal the collector FIRST: every _persist_q.put this
            # thread will ever issue has happened, so Empty+done is a
            # race-free exit condition —
            # then exit the device program (a resident loop left
            # behind would block the device for every later user)
            self._persist_dispatch_done.set()
            try:
                self._persist_stop_merge()
            except Exception:  # noqa: BLE001 — shutdown path
                log.exception("persistent loop shutdown failed")

    def _ring_check(self) -> str:
        """Advance the ring-fault ladder off a DEAD-but-idle resident
        ring (dispatch-thread only). Returns "fallback" once the limit
        is hit (or a relaunch cannot even start), else "ok" with a
        healthy — possibly freshly relaunched — ring in place."""
        pp = self._ppump
        if pp is None or not pp.failed:
            return "ok"
        self._ring_faults += 1
        log.error("resident loop dead at idle (ring fault %d%s)",
                  self._ring_faults,
                  f"/{self.ring_fault_limit}"
                  if self.ring_fault_limit else "")
        self.stats["batch_errors"] += 1
        self._ring_fold(pp)
        self._ppump = None
        if self.ring_fault_limit and \
                self._ring_faults >= self.ring_fault_limit:
            return "fallback"
        time.sleep(self._ring_backoff.next())
        try:
            self._persist_start()
        except Exception:  # noqa: BLE001 — same rule as the submit
            # path: a relaunch that cannot start IS the wedged ring
            log.exception("resident loop relaunch failed")
            return "fallback"
        return "ok"

    def _persist_fallback(self) -> None:
        """Degraded-mode escape hatch: the resident device
        ring died ``ring_fault_limit`` times, so stop relaunching it
        and serve traffic through the dispatch ladder instead — slower
        (per-batch host round trips come back) but alive. Runs ON the
        persist dispatch thread, which simply becomes the dispatch-mode
        dispatch thread; the missing piece of the dispatch topology
        (the concurrent fetch workers) is started here. Frames the
        failed submit un-held are re-peeked by the ladder, and tickets
        already in the collector's FIFO resolve as attributed
        ``drops_error`` — the mode switch itself loses nothing.

        One-way: the ring path stays off until the process restarts.
        ``degraded_ring`` drives ``vpp_tpu_degraded{component="ring"}``
        and `show resilience`; the first ladder dispatch of each rung
        pays its capture inline (logged) — the degraded mode trades a
        one-time stall for not being wedged."""
        log.error("device ring failed %d times — falling back to "
                  "dispatch mode (degraded; first ladder dispatch "
                  "captures inline)", self._ring_faults)
        self.degraded_ring = True
        self.mode = "dispatch"
        # NOTE: ICMP error generation stays off — persistent mode
        # zeroed icmp_src_ip at construction (self.icmp is None), so
        # the dispatch topology taken over here has no error path to
        # start; re-enabling it would need the agent to rebuild the
        # pump
        # no further ring tickets will ever be issued: let the
        # collector drain what is queued and idle until stop()
        self._persist_dispatch_done.set()
        for i in range(self.workers):
            t = threading.Thread(target=self._fetch_loop, daemon=True,
                                 name=f"dp-pump-fetch{i}")
            t.start()
            self._threads.append(t)
        self._dispatch_loop()

    def sync_sessions(self, timeout: float = 30.0) -> bool:
        """Persistent mode: graft a consistent device COPY of the
        in-ring session state into the dataplane's live tensors. The
        ring steps its tables privately and only merges them back at
        stop/epoch-restart — without this hook a long-lived ring
        leaves dp.tables frozen at launch state, so the maintenance
        consumers (the snapshotter above all, but also occupancy
        gauges and bulk expiry) would serve stale sessions against an
        advancing clock. Returns True when fresh state landed; False
        (no ring, dead ring, timeout) means the caller proceeds with
        whatever dp.tables already holds. Any thread may call it; the
        copy happens on the ring's stager at a window boundary
        (PersistentPump.checkpoint_sessions), the graft in place under
        the dataplane's lock, with no epoch bump."""
        pp = self._ppump
        if self.mode != "persistent" or pp is None:
            return False
        try:
            sess = pp.checkpoint_sessions(timeout=timeout)
        except RuntimeError:
            return False
        if sess is None:
            return False
        with self.dp._lock:
            self.dp.graft(sess, SESSION_FIELDS)
            # the grafted state carries stamps up to the ring's latest
            # submit clock — advance the dataplane's session clock to
            # match so a snapshot's rebase origin is consistent
            self.dp._now = max(self.dp._now, self.dp.clock_ticks())
        return True

    def tel_snapshot(self) -> Optional[dict]:
        """Collect-facing device-telemetry snapshot. In persistent mode
        this unpacks the latest ring rider — the telemetry planes that
        rode the last window's ONE result copy — so collect never
        touches the ring's private tables (and makes no device
        transfer at all). Other modes (and a ring that hasn't written
        back yet) fall through to the dataplane's own small-plane
        fetch. None when telemetry is off."""
        tel_mode = getattr(self.dp, "_tel_mode", "off")
        if tel_mode == "off":
            return None
        pp = self._ppump
        if self.mode == "persistent" and pp is not None:
            raw = pp.tel_raw()
            if raw is not None:
                from vpp_tpu_torch.ops.telemetry import unpack_tel_rider
                from vpp_tpu_torch.pipeline.tables import tel_capacity

                nb, _d, _w, k = tel_capacity(self.dp.config)
                snap = unpack_tel_rider(raw, nb, k)
                snap["mode"] = tel_mode
                snap["bins"] = np.asarray(snap["bins"], np.int64)
                snap["top_cnt"] = np.asarray(snap["top_cnt"], np.int64)
                return snap
        return self.dp.telemetry_snapshot()

    def _ring_fold(self, pp) -> None:
        """Retire a PersistentPump's monotonic ring counters into the
        accumulator EXACTLY ONCE, so restarts (epoch swaps,
        death-relaunches) never reset the exported totals. The
        retired flag flips under _lat_lock — the same lock
        _ring_stats_sync holds while deciding whether to add the
        ring's live counters — so a sync racing this fold either sees
        the ring un-retired (adds live, accumulator without it) or
        retired (accumulator only): never both."""
        if pp is None:
            return
        snap = pp.stats_snapshot()
        with self._lat_lock:
            if pp.retired:
                return
            pp.retired = True
            for k in self._ring_accum:
                self._ring_accum[k] += snap.get(k, 0)

    def _ring_stats_sync(self) -> None:
        """Refresh the public ring telemetry keys: accumulated counts
        from retired rings (epoch restarts) plus the live ring's
        counters. Host scalars only — nothing crosses the device
        transport."""
        pp = self._ppump
        live = pp.stats_snapshot() if pp is not None else {}
        with self._lat_lock:
            if pp is not None and pp.retired:
                live = {}  # already folded into the accumulator
            for k in self._ring_accum:
                self.stats[k] = self._ring_accum[k] + live.get(k, 0)
            self.stats["ring_inflight"] = int(live.get("ring_inflight", 0))
            self.stats["ring_lag"] = int(live.get("ring_lag", 0))

    def _persist_collect_one(self, item) -> None:
        seq, ppump, groups, non_ip, t0, pri = item
        tf0 = time.perf_counter()
        batch = None
        fast = False
        deadline = time.monotonic() + 300.0
        # NOT gated on _stop: an already-submitted frame's result
        # is coming (PersistentPump.stop drains every queued frame
        # before the loop exits) — discarding it at pump shutdown
        # would silently drop live traffic the dispatch mode
        # delivers. Loop-death/timeout still bounds the wait.
        while True:
            try:
                batch, aux = ppump.result_ex(timeout=0.2)
                fast = self._account_fastpath(aux)
                break
            except queue.Empty:
                if time.monotonic() > deadline:
                    log.error("resident loop result timed out")
                    self.stats["batch_errors"] += 1
                    break
            except RuntimeError:
                log.exception("resident loop result failed")
                self.stats["batch_errors"] += 1
                break
        with self._lat_lock:
            self.stats["t_fetch"] += time.perf_counter() - tf0
            if batch is None:
                # the frames will be released unwritten by the writer:
                # attribute the loss. The ring drains every queued
                # frame at stop(), so a missing result is a loop
                # death / timeout — reason "error", even mid-shutdown
                # (labeling it "shutdown" would hide a real failure)
                self.stats["drops_error"] += sum(
                    f.n for g in groups for f in g)
        self._ring_stats_sync()
        with self._done_cv:
            self._done[seq] = (batch, groups, non_ip, t0, fast, pri)
            self._done_cv.notify_all()

    def _persist_collect_loop(self) -> None:
        """Pull ordered results off the resident loop and hand them to
        the in-order tx writer. The loop preserves submission order, so
        seq mapping is one FIFO deep — no reorder buffer needed, but
        the writer's _done contract is kept so `stop()` semantics and
        stats stay identical across modes. Exit only once the
        dispatcher is DONE and the hand-off queue is drained: an
        Empty+_stop exit races a dispatcher mid-put, orphaning a seq
        the writer would spin on forever ."""
        while True:
            try:
                item = self._persist_q.get(timeout=0.05)
            except queue.Empty:
                if (self._stop.is_set()
                        and self._persist_dispatch_done.is_set()):
                    # final drain: the dispatcher has exited, so
                    # anything it ever queued is already visible here
                    while True:
                        try:
                            item = self._persist_q.get_nowait()
                        except queue.Empty:
                            return
                        self._persist_collect_one(item)
                continue
            self._persist_collect_one(item)

    # --- fetch workers: concurrent device_get (RPC round trips) ---
    def _fetch_loop(self) -> None:
        with self._lat_lock:
            self._fetchers_live += 1
        try:
            while True:
                # express first: a priority batch's fetch
                # waits only for the fetch in progress, never behind
                # the queued bulk FIFO
                try:
                    item = self._inflight_pri.get_nowait()
                except queue.Empty:
                    try:
                        item = self._inflight.get(timeout=0.05)
                    except queue.Empty:
                        if self._stop.is_set():
                            return
                        continue
                if item is _SENTINEL:
                    # wake the next worker too, then exit
                    try:
                        self._inflight.put_nowait(_SENTINEL)
                    except queue.Full:
                        pass
                    return
                self._complete_item(item)
        finally:
            with self._lat_lock:
                self._fetchers_live -= 1

    def _complete_item(self, item) -> None:
        """Fetch one dispatched batch's device result and hand it to
        the in-order writer (the fetch-worker body; the writer's
        shutdown rescue path reuses it for batches stranded behind the
        stop sentinel)."""
        seq, payload, groups, non_ip, t0, slow, pri = item
        delay = self._fetch_delay
        if delay is not None:
            time.sleep(delay(seq) if callable(delay) else delay)
        fast = False
        try:
            # faults: "pump.fetch" = the device result fetch failing —
            # exercises the drops_error attribution + in-order release
            # path
            faults.fire("pump.fetch")
            # ONE packed fetch ([5, B], or [K, 5, B] for a chain fold),
            # kept PACKED: the tx writer decodes it straight into ring
            # slots natively (rings.push_packed), no host-side column
            # arrays. The wait for the batch's event (its steps) is
            # timed apart from the copy: the wait overlaps the other
            # in-flight batches across the fetch pool, so only the
            # copy is a serial throughput cost.
            out, aux, done = payload
            tw0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            tf0 = time.perf_counter()
            if slow:
                # the tracing path: the unpacked step's columns
                batch, aux_h = _fetch_columns(out), None
                count_device_transfer("pump.fetch.columns",
                                      tuple(batch.values()))
            else:
                # one fetch for both: the aux summary rides with the rows
                out_h, aux_h = _fetch_packed(out, aux)
                count_device_transfer("pump.fetch.packed", (out_h, aux_h))
                batch = out_h
            tf1 = time.perf_counter()
            # concurrent fetchers: accumulate under a lock or the +=
            # load/add/store interleaves and undercounts
            with self._lat_lock:
                self.stats["t_fetch_wait"] += tf0 - tw0
                self.stats["t_fetch"] += tf1 - tf0
            fast = self._account_fastpath(aux_h)
        except Exception:
            log.exception("pump fetch failed (batch %d)", seq)
            batch = None
            self.stats["batch_errors"] += 1
            with self._lat_lock:
                # the writer releases these frames unwritten —
                # attribute the loss, don't just count a batch error
                self.stats["drops_error"] += sum(
                    f.n for g in groups for f in g)
        with self._done_cv:
            self._done[seq] = (batch, groups, non_ip, t0, fast, pri)
            self._done_cv.notify_all()

    def _account_fastpath(self, aux) -> bool:
        """Fold one dispatch's ``[PACKED_AUX_ROWS]`` (or chain-fold
        ``[K, PACKED_AUX_ROWS]``) aux summary into the pump counters;
        returns True when EVERY sub-batch ran the classify-free kernel
        (the whole dispatch's latency then belongs to the fast-tier
        histogram). Row meanings come from
        ``pipeline.dataplane.PACKED_AUX_SCHEMA`` — the width
        authority; the ``a.shape[1] >=`` guards keep older/narrower
        riders (mesh pumps, test fakes) accounting their prefix.

        ``fastpath_batches`` counts at DISPATCH granularity — a chain
        fold counts once, and only when all K sub-batches went fast —
        so it stays directly comparable to ``stats["batches"]`` (the
        ratio is a true fraction). Partial folds still show up in the
        packet-level hits/alive accumulators. Rows 3/4 carry the
        session-table pressure counters (insert election losses,
        evictions), rows 5-7 the ML-stage verdict counters (scored /
        flagged / dropped), rows 8/9 the device-telemetry counters
        (wire latencies histogrammed / packets sketched) when the
        program provides them."""
        if aux is None:
            return False
        a = np.asarray(aux)
        if a.ndim == 1:
            a = a[None, :]
        all_fast = bool((a[:, 0] > 0).all())
        with self._lat_lock:
            if all_fast:
                self.stats["fastpath_batches"] += 1
            self.stats["fastpath_alive"] += int(a[:, 1].sum())
            self.stats["fastpath_hits"] += int(a[:, 2].sum())
            if a.shape[1] >= 5:
                self.stats["sess_insert_fails"] += int(a[:, 3].sum())
                self.stats["sess_evictions"] += int(a[:, 4].sum())
            if a.shape[1] >= 8:
                self.stats["ml_scored"] += int(a[:, 5].sum())
                self.stats["ml_flagged"] += int(a[:, 6].sum())
                self.stats["ml_drops"] += int(a[:, 7].sum())
            if a.shape[1] >= 10:
                self.stats["tel_observed"] += int(a[:, 8].sum())
                self.stats["tel_sketched"] += int(a[:, 9].sum())
            if a.shape[1] >= 12:
                # tenancy rows: device token-bucket drops
                # feed the tenant_quota reason of
                # vpp_tpu_pump_drops_total; slice insert failures are
                # the per-tenant congestion counter
                self.stats["drops_tenant_quota"] += int(a[:, 10].sum())
                self.stats["tenant_sess_quota_fails"] += \
                    int(a[:, 11].sum())
        return all_fast

    # --- tx writer: reorder, split, write tx ring, release rx slots ---
    def _write_loop(self) -> None:
        next_seq = 0
        # seqs already written OUT of dispatch order by the express
        # jump below — consumed (skipped) when next_seq reaches them
        skipped: set = set()
        while True:
            rescue = False
            item = None
            with self._done_cv:
                while True:
                    while next_seq in skipped:
                        skipped.discard(next_seq)
                        next_seq += 1
                    if next_seq in self._done:
                        item = self._done.pop(next_seq)
                        next_seq += 1
                        break
                    # express jump: a completed PRIORITY
                    # item is written immediately, ahead of earlier
                    # bulk seqs still fetching — legal because rx
                    # release order is rid-based (_release_done), so
                    # only the tx write order changes, and reflex
                    # frames must not wait out the bulk pipeline
                    ex = min((s for s, it in self._done.items()
                              if it[5]), default=None)
                    if ex is not None:
                        item = self._done.pop(ex)
                        skipped.add(ex)
                        break
                    # exit once stopped and every dispatched batch has
                    # been written (_seq is the dispatch count; the
                    # sentinel may still sit in _inflight, so emptiness
                    # of the queue is NOT a usable signal here)
                    if self._stop.is_set() and next_seq >= self._seq:
                        return
                    if self._stop.is_set() and \
                            not (self._inflight.empty()
                                 and self._inflight_pri.empty()):
                        with self._lat_lock:
                            fetchers = self._fetchers_live
                        if fetchers == 0:
                            # stop() raced _dispatch's put: a batch
                            # landed BEHIND the stop sentinel and every
                            # fetch worker has already exited — without
                            # a rescue its seq never reaches _done and
                            # this unbounded-join loop hangs forever
                            rescue = True
                            break
                    self._done_cv.wait(timeout=0.05)
            if rescue:
                # complete stranded batches on this thread (outside
                # _done_cv — _complete_item takes it to post results)
                for q in (self._inflight_pri, self._inflight):
                    while True:
                        try:
                            stranded = q.get_nowait()
                        except queue.Empty:
                            break
                        if stranded is not _SENTINEL:
                            self._complete_item(stranded)
                continue
            try:
                self._write(*item)
            except Exception:
                log.exception("pump tx write failed")
                self._release_done(item[1])
            self._inflight_dec()

    def _write_packed_group(self, batch: np.ndarray, frames: list,
                            host_if: int, epoch: int,
                            icmp_on: bool) -> None:
        """Fast path for one coalesce group: ONE native call per frame
        decodes the packed [5, B] result straight into a reserved tx
        slot (pass-through columns from the rx slot, non-IP punt
        applied in C)."""
        off = 0
        for f in frames:
            n = f.n
            with self._tx_lock:
                try:
                    # faults: "pump.tx_push" = a stalled tx ring (the
                    # consumer stopped draining) — the frame takes the
                    # drops_tx_stall path exactly like a full ring
                    faults.fire("pump.tx_push")
                    ok = self.rings.tx.push_packed(batch, off, n, f,
                                                   host_if, epoch,
                                                   self._cause)
                except faults.FaultInjected:
                    ok = False
            if ok:
                self.stats["frames"] += 1
                self.stats["pkts"] += n
                if icmp_on and n and self._cause[:n].any():
                    self._emit_icmp_frame(f, self._cause)
            else:
                self.stats["tx_ring_full"] += 1
                self.stats["drops_tx_stall"] += n
            off += n

    def _write(self, batch, groups: list, non_ip, t0: float,
               fast: bool = False, pri: bool = False) -> None:
        if isinstance(batch, np.ndarray):
            tw0 = time.perf_counter()
            host_if = (self.dp.host_if
                       if self.dp.host_if is not None else -1)
            epoch = self.dp.epoch
            icmp_on = self.icmp is not None
            if batch.ndim == 3:
                # chain fold: sub-batch k carries group k's packets
                # (padded stack rows past len(groups) hold no frames)
                for k, frames in enumerate(groups):
                    self._write_packed_group(batch[k], frames, host_if,
                                             epoch, icmp_on)
            else:
                self._write_packed_group(batch, groups[0], host_if,
                                         epoch, icmp_on)
            self.stats["t_write"] += time.perf_counter() - tw0
            lat = time.perf_counter() - t0
            with self._lat_lock:
                self.batch_lat.append(lat)
                if pri:
                    self.pri_lat.append(lat)
                    self._pri_total += 1
            if self.latency_hist is not None:
                self.latency_hist.observe(lat)
            if fast and self.fastpath_hist is not None:
                self.fastpath_hist.observe(lat)
        elif batch is not None:
            self._write_columns(batch, groups[0], non_ip, t0, pri)
        self._release_done(groups)

    def _write_columns(self, batch: dict, frames: list, non_ip, t0: float,
                       pri: bool) -> None:
        """The tracing path's write: the unpacked step's columns of one
        coalesce group (the tracer never chains), frame by frame into tx
        slots, non-IP punted to the host interface."""
        if non_ip is not None and non_ip.any():
            host_if = self.dp.host_if if self.dp.host_if is not None else -1
            batch["disp"][non_ip] = int(Disposition.HOST)
            batch["tx_if"][non_ip] = host_if
        # the drop cause feeds the ICMP errors, not a ring column
        drop_cause = batch.pop("drop_cause")
        batch["rx_if"] = batch.pop("tx_if")  # tx direction: egress if
        epoch = self.dp.epoch
        off = 0
        for f in frames:
            n = f.n
            out_cols = {}
            for name, arr in batch.items():
                col = np.zeros(VEC, arr.dtype)
                col[:n] = arr[off:off + n]
                out_cols[name] = col
            out_cols["flags"] = f.cols["flags"]  # valid + non-ip4
            out_cols["meta"] = f.cols["meta"]
            with self._tx_lock:
                ok = self.rings.tx.push(out_cols, n, payload=f.payload,
                                        epoch=epoch)
            if ok:
                self.stats["frames"] += 1
                self.stats["pkts"] += n
                # ICMP only for frames that made it out, as on the
                # packed path
                if self.icmp is not None:
                    cause = np.zeros(VEC, np.int32)
                    cause[:n] = drop_cause[off:off + n]
                    if cause[:n].any():
                        self._emit_icmp_frame(f, cause)
            else:
                self.stats["tx_ring_full"] += 1
                self.stats["drops_tx_stall"] += n
            off += n
        lat = time.perf_counter() - t0
        with self._lat_lock:
            self.batch_lat.append(lat)
            if pri:
                self.pri_lat.append(lat)
                self._pri_total += 1
        if self.latency_hist is not None:
            self.latency_hist.observe(lat)

    def _emit_icmp_frame(self, f, cause: np.ndarray) -> None:
        """Generate ICMP time-exceeded / net-unreachable frames for one
        rx frame's attributed drops (VPP ip4-icmp-error). The invoking packet is quoted from its rx slot
        payload — still ring-owned here, so the original bytes are
        stable. ``cause`` is the per-packet DROP_* array [VEC].

        The errors are ROUTED THROUGH THE PIPELINE like any ingress
        packet (rx on the node's host interface — they originate from
        the vswitch itself), exactly as VPP's ip4-icmp-error node feeds
        back into ip4-lookup: errors toward local pods deliver on the
        pod interface, errors toward REMOTE senders (the invoking
        packet arrived on the uplink) pick up the route's next_hop and
        leave VXLAN-encapsulated — cross-node traceroute works."""
        from vpp_tpu_torch.io.icmp import classify_drops

        ingress = self.dp.host_if
        if ingress is None:
            ingress = self.dp.uplink_if
        if ingress is None:
            return  # no self-originated ingress point configured
        n = f.n
        idxs, types = classify_drops(cause, f.cols["flags"],
                                     f.cols["ttl"], n)
        if not len(idxs):
            return
        built = self.icmp.build_frame(
            idxs, types, f.cols, f.payload, self._icmp_scratch,
            rx_if=int(ingress),
        )
        if built is None:
            return
        out_cols, k = built
        # hand off to the dedicated error-path thread: the classify is
        # a blocking device round trip (~100 ms on a remote transport)
        # and this is the IN-ORDER tx writer — blocking here would
        # head-of-line-block all forwarded traffic and stall rx slot
        # releases. Payload rows are copied because _icmp_scratch is
        # reused for the next build.
        try:
            self._icmp_q.put_nowait(
                (out_cols, k, self._icmp_scratch[:k].copy())
            )
        except queue.Full:
            self.icmp.suppressed += k

    def _icmp_loop(self) -> None:
        """Error-path worker: routes built ICMP error frames through
        the device pipeline (rx on the host interface — VPP's
        ip4-icmp-error feeding ip4-lookup) and pushes the verdicts to
        the tx ring. Its blocking round trips never touch the
        forwarding threads."""
        from vpp_tpu_torch.native.pktio import flatten_cols
        from vpp_tpu_torch.native.ring import RING_COLUMNS
        from vpp_tpu_torch.pipeline.dataplane import packed_input_zeros

        payload_buf = np.zeros((VEC, self.rings.tx.snap), np.uint8)
        while not self._stop.is_set():
            try:
                out_cols, k, payload = self._icmp_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                flat = packed_input_zeros(VEC)
                pack_packet_columns(flat.view(np.uint32), out_cols, k)
                # the verdict assigns the real egress + next_hop.
                # commit=False: error classification must not install
                # sessions NOR race the dispatch thread's table
                # commits (two committers would drop one side's
                # reflective-session installs)
                res = self.dp.process_packed(
                    flat, commit=False).cpu().numpy().copy()
                block = flatten_cols(out_cols)
                cols_view = {
                    name: block[j]
                    for j, (name, _dt) in enumerate(RING_COLUMNS)
                }
                payload_buf[:k] = payload
                frame = _IcmpFrame(cols=cols_view, n=k,
                                   epoch=self.dp.epoch,
                                   payload=payload_buf)
                host_if = (self.dp.host_if
                           if self.dp.host_if is not None else -1)
                with self._tx_lock:
                    ok = self.rings.tx.push_packed(res, 0, k, frame,
                                                   host_if,
                                                   self.dp.epoch,
                                                   self._icmp_cause)
                if ok:
                    self.stats["icmp_errors"] = (
                        self.stats.get("icmp_errors", 0) + k
                    )
                else:
                    self.stats["tx_ring_full"] += 1
            except Exception:
                log.exception("icmp error path failed")

    # --- observability ---
    def reset_latency(self) -> None:
        """Clear the latency window so the next ``latency_us()``
        covers only batches from here on (the bench scopes each paced
        round this way)."""
        with self._lat_lock:
            self.batch_lat.clear()
            self.pri_lat.clear()

    def latency_us(self) -> dict:
        """p50/p99 dispatch→tx batch latency over the recent window."""
        with self._lat_lock:
            snap = list(self.batch_lat)
        if not snap:
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        arr = np.asarray(snap) * 1e6
        return {
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "n": int(arr.size),
        }
