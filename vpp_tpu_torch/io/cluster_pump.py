"""ClusterPump: real wire traffic through the mesh fabric.

The PyTorch counterpart of ``vpp_tpu/io/cluster_pump.py``, the mesh
form of io/pump.py ``DataplanePump``: one pump drives N per-node ring
pairs against ONE ``ClusterDataplane``. Each step gathers up to
``MAX_FRAMES`` rx frames a node, stacks the headers ([N, P] columns) and
the packet bytes ([N, P, snap] uint8), runs ``cluster.step_wire`` (two
pipeline passes joined by the fabric exchange, which carries headers AND
payload) and writes both result streams out:

* pass-1 ``local`` results to the INGRESS node's tx ring (delivered
  locally, punted to the host, or to a VXLAN edge peer; the payload from
  the node's own rx slot);
* pass-2 ``delivered`` results to the DESTINATION node's tx ring, with
  the bytes that crossed the fabric, so cross-node traffic needs no
  host-side source lookup.

Two stages, as the single-node pump: the dispatch thread stages and
steps without waiting for the writer; the writer copies the results to
the host IN ORDER, writes the tx rings and releases the rx slots. Frames
stay ring-owned while in flight (``peek_nth`` and a deferred release).

ICMP errors (io/icmp.py): attributed drops of either pass build
rate-limited error frames re-injected as that node's self-originated
ingress into a following step: the pipeline returns them to a local pod
or back ACROSS the fabric toward a remote sender.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import List, Optional

import numpy as np

import torch

from vpp_tpu_torch.io.rings import VEC, IORingPair
from vpp_tpu_torch.pipeline.vector import Disposition, PacketVector

log = logging.getLogger("cluster-pump")

_PV_FIELDS = ("src_ip", "dst_ip", "proto", "sport", "dport", "ttl",
              "pkt_len", "rx_if", "flags")

_SENTINEL = object()

# per-node rx frames coalesced into one device step (two jit buckets:
# VEC and VEC*MAX_FRAMES packets per node, like the single-node pump's
# ladder — a backlog quadruples the per-step payload instead of paying
# a step per frame)
MAX_FRAMES = 4

# a synthetic frame re-injected into a following fabric step (ICMP
# error path); shape-compatible with the staging loop's ring Frames
_ErrFrame = collections.namedtuple("_ErrFrame", ("cols", "n", "payload"))


def _host_tx(tx):
    """A NodeTx of device tensors as one of host NumPy arrays."""
    return type(tx)(type(tx.pkts)(*(f.cpu().numpy() for f in tx.pkts)),
                    *(f.cpu().numpy() for f in tx[1:]))


class ClusterPump:
    def __init__(self, cluster, ring_pairs: List[IORingPair],
                 poll_s: float = 0.0005, snap: Optional[int] = None,
                 icmp_src_ips: Optional[List[int]] = None,
                 ingress_ifs: Optional[List[int]] = None,
                 max_inflight: Optional[int] = None):
        """``max_inflight``: fabric steps in flight before dispatch
        backpressures (None: 2).
        ``icmp_src_ips``/``ingress_ifs`` (per mesh node:
        the pod gateway address and the node's host interface) enable
        the ICMP error path (see module doc)."""
        assert len(ring_pairs) == cluster.n_nodes
        self.cluster = cluster
        self.rings = ring_pairs
        self.poll_s = poll_s
        self.snap = snap or min(r.rx.snap for r in ring_pairs)
        self.max_inflight = max(1, int(2 if max_inflight is None
                                       else max_inflight))
        self.icmp = None
        self._err_q: List[list] = [[] for _ in range(cluster.n_nodes)]
        self._err_lock = threading.Lock()
        if icmp_src_ips is not None:
            from vpp_tpu_torch.io.icmp import IcmpErrorGen

            assert ingress_ifs is not None and \
                len(icmp_src_ips) == cluster.n_nodes
            self.icmp = [
                IcmpErrorGen(ip, VEC, self.snap) for ip in icmp_src_ips
            ]
            self.ingress_ifs = list(ingress_ifs)
            self._icmp_scratch = np.zeros((VEC, self.snap), np.uint8)
        # staging pool: dispatch cycles max_inflight+2 buffer pairs per bucket
        # (allocated lazily per bucket) — a buffer is reused only after
        # its step completed in the writer, so a CPU tensor that
        # aliases host memory can never observe a rewrite. Only
        # the flags row needs clearing between reuses — a stale VALID
        # flag would resurrect an old packet, while every other stale
        # column is inert behind flags=0.
        self._pool_n = self.max_inflight + 2
        self._stage_pool: dict = {}
        # superset of DataplanePump's keys so the CLI's `show io`
        # renders either pump unchanged (batches == device steps)
        self.stats = {"steps": 0, "frames": 0, "pkts": 0,
                      "fabric_pkts": 0, "tx_ring_full": 0,
                      "batches": 0, "max_coalesce": 0, "batch_errors": 0,
                      # overlap observability, same contract as the
                      # single-node pump: fabric steps dispatched but
                      # not yet written, the wait for a step's results
                      # to become ready (overlapped with the next
                      # step's staging) vs the serial result copy
                      "inflight": 0, "inflight_peak": 0,
                      "t_fetch_wait": 0.0, "t_fetch": 0.0,
                      # two-tier dispatch telemetry, same contract as
                      # DataplanePump: fastpath_batches counts fabric
                      # steps whose pass 1 dispatched fast on every
                      # node (from the step's own StepStats)
                      "fastpath_batches": 0, "fastpath_hits": 0,
                      "fastpath_alive": 0}
        self._step_lat = collections.deque(maxlen=2048)
        self._lat_lock = threading.Lock()
        # optional Prometheus Histogram (stats/collector.py set_pump):
        # same per-batch observation contract as DataplanePump, so
        # vpp_tpu_pump_batch_seconds carries data on mesh nodes too
        self.latency_hist = None
        # fast-tier histogram slot (set_pump parity): _write observes
        # fabric steps whose pass 1 dispatched classify-free on every
        # node (see the fastpath_batches comment above)
        self.fastpath_hist = None
        # frames peeked by dispatch but not yet released by the writer,
        # per ring (releases shift pending peek indices, so both sides
        # mutate under the lock — the single-node pump's held protocol)
        self._held = [0] * cluster.n_nodes
        self._held_lock = threading.Lock()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=self.max_inflight)
        self._seq = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # --- staging ---
    def _stage_buffers(self, p_cap: int):
        pool = self._stage_pool.get(p_cap)
        if pool is None:
            n = self.cluster.n_nodes
            pool = [
                (np.zeros((n, len(_PV_FIELDS), p_cap), np.int32),
                 np.zeros((n, p_cap, self.snap), np.uint8))
                for _ in range(self._pool_n)
            ]
            self._stage_pool[p_cap] = pool
        cols, payload = pool[self._seq % self._pool_n]
        cols[:, _PV_FIELDS.index("flags"), :] = 0
        return cols, payload

    def _pv_from(self, cols: np.ndarray) -> PacketVector:
        """[N, 9, P] int32 column block -> the node-stacked PacketVector
        on the cluster's device (one copy)."""
        t = torch.from_numpy(cols).to(self.cluster.device)
        return PacketVector(*t.unbind(1))

    def warm(self) -> None:
        """Capture the wire step at every coalesce bucket the pump will
        stage (both, or the VEC one alone at ``max_frames_per_ring``
        1) before serving traffic (the live loop's shapes): a capture
        mid-traffic would stall the rings. A step over all-invalid
        frames moves no state but the sweep cursors."""
        buckets = ((VEC,) if self.max_frames_per_ring <= 1
                   else (VEC, VEC * MAX_FRAMES))
        for p in buckets:
            cols, payload = self._stage_buffers(p)
            self.cluster.step_wire(self._pv_from(cols), payload, now=0)

    # --- lifecycle ---
    # multi-host tick mode (parallel/multihost.py MultiHostRuntime sets
    # the three): the step is a COLLECTIVE, so an idle host must still
    # dispatch (empty staging) to pair with a peer that has traffic —
    # the tick driver, not this class, owns the cadence
    step_when_idle = False
    # a swallowed staging/dispatch error would desync the fleet's
    # collective sequence SILENTLY (this host skips a step its peers
    # issued; their writers block forever): the tick driver must see
    # the exception and halt loudly
    raise_on_error = False
    # the coalesce bucket must be FLEET-AGREED: p_cap derived from the
    # LOCAL backlog would make hosts stage different shapes and issue
    # mismatched collectives. 1 pins every host to the VEC bucket.
    max_frames_per_ring = MAX_FRAMES

    def start(self, dispatch: bool = True) -> "ClusterPump":
        """``dispatch=False``: the writer thread only — an external tick
        driver calls ``_dispatch_once()`` itself (multi-host lockstep,
        where the fabric step must interleave deterministically with
        the driver's other collectives)."""
        loops = [(self._write_loop, "cluster-pump-tx")]
        if dispatch:
            loops.insert(0, (self._dispatch_loop, "cluster-pump-dispatch"))
        for fn, name in loops:
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, join_timeout: Optional[float] = None) -> bool:
        self._stop.set()
        try:
            self._inflight.put_nowait(_SENTINEL)
        except queue.Full:
            pass  # writer drains; it checks _stop per item
        ok = True
        for t in self._threads:
            t.join(timeout=join_timeout)
            ok = ok and not t.is_alive()
        return ok

    def has_pending(self) -> bool:
        """Any un-dispatched rx frame (held ones excluded) or queued
        ICMP error (``show mesh``'s pending flag; the multi-host idle
        skip's local has-work signal).
        Owns the same locking the dispatch peek does."""
        with self._held_lock:
            for i, r in enumerate(self.rings):
                if r.rx.peek_nth(self._held[i]) is not None:
                    return True
        with self._err_lock:
            return any(self._err_q)

    # --- dispatch: rings -> device (async) ---
    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if not self._dispatch_once():
                    time.sleep(self.poll_s)
            except Exception:
                log.exception("cluster pump dispatch failed")
                self.stats["batch_errors"] += 1
                time.sleep(self.poll_s)

    def _dispatch_once(self) -> bool:
        n = self.cluster.n_nodes
        per_node: List[list] = []   # (frame, from_ring) pairs
        cap = self.max_frames_per_ring
        with self._err_lock:
            err_frames = [
                self._err_q[i][:cap] for i in range(n)
            ]
            for i in range(n):
                del self._err_q[i][:len(err_frames[i])]
        # the whole peek block holds _held_lock: a concurrent writer
        # release shifts pending peek indices, so a stale held snapshot
        # would skip one frame and double-take another (silent loss +
        # duplication) — same protocol as the single-node pump
        with self._held_lock:
            for i, r in enumerate(self.rings):
                lst = [(ef, False) for ef in err_frames[i]]
                taken = 0
                for k in range(cap - len(lst)):
                    f = r.rx.peek_nth(self._held[i] + k)
                    if f is None:
                        break
                    lst.append((f, True))
                    taken += 1
                self._held[i] += taken
                per_node.append(lst)
        if all(not lst for lst in per_node) and not self.step_when_idle:
            return False
        t0 = time.perf_counter()
        try:
            depth = max(len(lst) for lst in per_node)
            p_cap = VEC if depth <= 1 else VEC * MAX_FRAMES
            cols, payload = self._stage_buffers(p_cap)
            offs: List[list] = []  # per node: (offset, frame, from_ring)
            for i, lst in enumerate(per_node):
                off = 0
                node_offs = []
                for f, from_ring in lst:
                    for j, name in enumerate(_PV_FIELDS):
                        cols[i, j, off:off + f.n] = \
                            f.cols[name][:f.n].view(np.int32)
                    w = min(self.snap, f.payload.shape[1])
                    payload[i, off:off + f.n, :w] = f.payload[:f.n, :w]
                    if w < self.snap:
                        # a narrower source ring must not leave a
                        # previous step's bytes in the row tail —
                        # VALID rows ride the fabric full-width
                        payload[i, off:off + f.n, w:] = 0
                    node_offs.append((off, f, from_ring))
                    off += f.n
                offs.append(node_offs)
            result, deliv_pay = self.cluster.step_wire(
                self._pv_from(cols), payload)
            item = (result, deliv_pay, offs, t0)
        except Exception:
            # staging/dispatch failed AFTER taking frames: hand the
            # writer a failed item so ring releases stay in order and
            # the error frames are re-queued, not lost
            log.exception("cluster pump staging/dispatch failed")
            self.stats["batch_errors"] += 1
            item = (None, None,
                    [[(0, f, fr) for f, fr in lst]
                     for lst in per_node], t0)
            if self.raise_on_error:
                # ordered cleanup first, then surface: the lockstep
                # driver has no way to resync a fleet whose collective
                # sequences diverged
                with self._lat_lock:
                    self.stats["inflight"] += 1
                while True:
                    try:
                        self._inflight.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            with self._lat_lock:
                                self.stats["inflight"] -= 1
                            break
                raise
        # count the step in flight BEFORE the hand-off (the writer can
        # complete + decrement it the instant the put lands)
        with self._lat_lock:
            d = self.stats["inflight"] + 1
            self.stats["inflight"] = d
            if d > self.stats["inflight_peak"]:
                self.stats["inflight_peak"] = d
        while True:
            try:
                self._inflight.put(item, timeout=0.05)
                break
            except queue.Full:
                if self._stop.is_set():
                    # shutdown with a wedged writer: the runtime tears
                    # the rings down wholesale next — abandoning the
                    # held frames is safe, processing them is not
                    with self._lat_lock:
                        self.stats["inflight"] -= 1
                    return True
        self._seq += 1
        return True

    # --- writer: device -> rings, in order ---
    def _write_loop(self) -> None:
        while True:
            try:
                item = self._inflight.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is _SENTINEL:
                return
            try:
                self._write(*item)
            except Exception:
                log.exception("cluster pump write failed")
                self.stats["batch_errors"] += 1
                self._release_item(item)
            finally:
                with self._lat_lock:
                    self.stats["inflight"] -= 1

    def _release_frames(self, offs) -> None:
        """Ordered ring releases + held decrements for one item (the
        single copy of the held protocol; success and failure paths
        both end here)."""
        for i, node_offs in enumerate(offs):
            with self._held_lock:
                for _, _, from_ring in node_offs:
                    if from_ring:
                        self.rings[i].rx.release()
                        self._held[i] -= 1

    def _release_item(self, item) -> None:
        """Failure path: release ring frames in order; error frames
        (destructively taken at dispatch) are re-queued ONLY when the
        device step never ran — a step that succeeded already injected
        them, and re-running would deliver duplicate ICMP errors."""
        result, _, offs, _ = item
        if result is None:
            for i, node_offs in enumerate(offs):
                requeue = [f for _, f, from_ring in node_offs
                           if not from_ring]
                if requeue:
                    with self._err_lock:
                        self._err_q[i][:0] = requeue
        self._release_frames(offs)

    def _write(self, result, deliv_pay, offs, t0) -> None:
        if result is None:  # failed dispatch: ordered cleanup only
            self._release_item((None, None, offs, t0))
            return
        n = self.cluster.n_nodes
        # the step ran in the dispatch thread; the copies to the host
        # are the writer's serial cost
        tw0 = time.perf_counter()
        if result.local.disp.device.type == "cuda":
            torch.cuda.current_stream(result.local.disp.device).synchronize()
        tf0 = time.perf_counter()
        res_local, res_deliv = _host_tx(result.local), _host_tx(
            result.delivered)
        sess_hits = result.stats.sess_hits.cpu().numpy()
        step_rx = result.stats.rx.cpu().numpy()
        step_fp = result.fastpath_pass1.cpu().numpy()
        deliv_pay = deliv_pay.cpu().numpy()
        tf1 = time.perf_counter()
        with self._lat_lock:
            self.stats["t_fetch_wait"] += tf0 - tw0
            self.stats["t_fetch"] += tf1 - tf0
            self.stats["fastpath_hits"] += int(sess_hits.sum())
            self.stats["fastpath_alive"] += int(step_rx.sum())
            # a fast fabric step: the INGRESS pass took the fast tier on
            # every node (pass 2, an empty fabric, is vacuously fast)
            fast_step = bool(step_fp.min() >= 1)
            if fast_step:
                self.stats["fastpath_batches"] += 1

        # pass-1 results → ingress node's tx ring (payload: own rx slot)
        for i, node_offs in enumerate(offs):
            node_ids = np.asarray(res_local.node_id)[i]
            causes = np.asarray(res_local.drop_cause)[i]
            for off, f, from_ring in node_offs:
                out_cols = self._tx_cols(res_local, i, f.n, off=off)
                # fabric-consumed packets must not ALSO leave via the
                # ingress tx path: their disposition stays REMOTE with
                # a node_id >= 0; the daemon would VXLAN-encap
                # (next_hop) or uplink-send them. Mark them
                # transmitted-by-fabric (drop here, delivered at the
                # peer).
                fabric = (node_ids[off:off + f.n] >= 0) & \
                    (out_cols["disp"][:f.n] == int(Disposition.REMOTE))
                out_cols["disp"][:f.n] = np.where(
                    fabric, int(Disposition.DROP), out_cols["disp"][:f.n]
                )
                out_cols["flags"] = f.cols["flags"].copy()
                out_cols["meta"] = f.cols["meta"].copy()
                out_cols["proto"] = f.cols["proto"].copy()
                out_cols["pkt_len"] = f.cols["pkt_len"].copy()
                if self.rings[i].tx.push(out_cols, f.n,
                                         payload=f.payload,
                                         epoch=self.cluster.epoch):
                    self.stats["frames"] += 1
                    self.stats["pkts"] += f.n
                else:
                    self.stats["tx_ring_full"] += 1
                if self.icmp is not None:
                    self._queue_errors(i, f.cols, f.payload, f.n,
                                       causes[off:off + f.n])

        # pass-2 fabric deliveries → destination node's tx ring
        # (payload: the bytes that crossed the fabric)
        d_disp = np.asarray(res_deliv.disp)
        for i in range(n):
            live = np.nonzero(d_disp[i] != int(Disposition.DROP))[0]
            if not len(live):
                continue
            for start in range(0, len(live), VEC):
                sel = live[start:start + VEC]
                k = len(sel)
                out_cols = self._tx_cols(res_deliv, i, None, sel=sel)
                out_cols["flags"] = np.zeros(VEC, np.int32)
                out_cols["flags"][:k] = 1  # FLAG_VALID
                out_cols["meta"] = np.full(VEC, -1, np.int32)
                pay = np.zeros((VEC, self.snap), np.uint8)
                pay[:k] = deliv_pay[i][sel]
                if self.rings[i].tx.push(out_cols, k, payload=pay,
                                         epoch=self.cluster.epoch):
                    self.stats["frames"] += 1
                    self.stats["pkts"] += k
                    self.stats["fabric_pkts"] += k
                else:
                    self.stats["tx_ring_full"] += 1
        # drop attribution → ICMP errors, re-injected into a following
        # step. Pass-2 drops matter most here: the invoking packet came
        # from ANOTHER node, and the re-injected error's pipeline
        # verdict sends it back ACROSS THE FABRIC to that sender.
        if self.icmp is not None:
            from vpp_tpu_torch.native.ring import RING_COLUMNS

            d_cause = np.asarray(res_deliv.drop_cause)
            d_pk = res_deliv.pkts
            width = d_cause.shape[1]
            for i in range(n):
                if not d_cause[i].any():
                    continue
                cols_like = {
                    name: np.zeros(width, dt) for name, dt in RING_COLUMNS
                }
                cols_like["src_ip"] = np.asarray(d_pk.src_ip)[i].view(
                    np.uint32)
                cols_like["pkt_len"] = np.asarray(d_pk.pkt_len)[i]
                cols_like["ttl"] = np.asarray(d_pk.ttl)[i]
                cols_like["flags"] = np.asarray(d_pk.flags)[i]
                self._queue_errors(i, cols_like, deliv_pay[i], width,
                                   d_cause[i])
        self.stats["steps"] += 1
        self.stats["batches"] += 1
        self.stats["max_coalesce"] = max(
            self.stats["max_coalesce"],
            sum(len(node_offs) for node_offs in offs),
        )
        # ring releases LAST, after every read of the frames' memory:
        # an exception anywhere above leaves all releases to the
        # writer loop's _release_item (no double release possible)
        self._release_frames(offs)
        lat = time.perf_counter() - t0
        with self._lat_lock:
            self._step_lat.append(lat)
        if self.latency_hist is not None:
            self.latency_hist.observe(lat)
        # fast-tier slice of the distribution (DataplanePump parity):
        # only fabric steps whose ingress pass dispatched classify-free
        # on every node observe here
        if fast_step and self.fastpath_hist is not None:
            self.fastpath_hist.observe(lat)

    def _queue_errors(self, node: int, cols, payload, n: int,
                      causes: np.ndarray) -> None:
        """Build rate-limited ICMP errors for one frame's attributed
        drops and queue them for re-injection as the node's
        self-originated ingress in a following fabric step (produced by
        the writer thread, consumed by dispatch — under _err_lock)."""
        from vpp_tpu_torch.io.icmp import classify_drops

        gen = self.icmp[node]
        idxs, types = classify_drops(causes, cols["flags"],
                                     cols["ttl"], n)
        if not len(idxs):
            return
        with self._err_lock:
            if len(self._err_q[node]) >= MAX_FRAMES:
                gen.suppressed += len(idxs)
                return
        built = gen.build_frame(
            idxs, types, cols, payload, self._icmp_scratch,
            rx_if=int(self.ingress_ifs[node]),
        )
        if built is None:
            return
        out_cols, k = built
        with self._err_lock:
            self._err_q[node].append(_ErrFrame(
                cols=out_cols, n=k, payload=self._icmp_scratch[:k].copy()
            ))
        self.stats["icmp_errors"] = self.stats.get("icmp_errors", 0) + k

    def latency_us(self) -> dict:
        """p50/p99 fabric-step latency (staged -> both tx streams
        written) over the recent window — `show io` renders this."""
        with self._lat_lock:
            snap = list(self._step_lat)
        if not snap:
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        arr = np.asarray(snap) * 1e6
        return {
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "n": int(arr.size),
        }

    @staticmethod
    def _tx_cols(res, i: int, n: Optional[int], sel=None,
                 off: int = 0) -> dict:
        """TX ring columns from one node's row of a NodeTx result (tx
        direction: the rx_if column carries the egress interface).
        ``off`` slices a coalesced frame's packets out of the node
        row; ``sel`` gathers arbitrary positions (delivered path)."""
        pk = res.pkts
        out = {}

        def take(arr, dtype):
            a = np.asarray(arr)[i]
            col = np.zeros(VEC, dtype)
            if sel is not None:
                col[:len(sel)] = a[sel].astype(dtype, copy=False)
            else:
                col[:n] = a[off:off + n].astype(dtype, copy=False)
            return col

        out["src_ip"] = take(pk.src_ip, np.uint32)
        out["dst_ip"] = take(pk.dst_ip, np.uint32)
        out["proto"] = take(pk.proto, np.int32)
        out["sport"] = take(pk.sport, np.int32)
        out["dport"] = take(pk.dport, np.int32)
        out["ttl"] = take(pk.ttl, np.int32)
        out["pkt_len"] = take(pk.pkt_len, np.int32)
        out["rx_if"] = take(res.tx_if, np.int32)
        out["disp"] = take(res.disp, np.int32)
        out["next_hop"] = take(res.next_hop, np.uint32)
        return out
