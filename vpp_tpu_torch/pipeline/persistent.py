"""Persistent device pump over device descriptor rings.

The port's counterpart of ``vpp_tpu/pipeline/persistent.py``: the host
half of the persistent wire path. The steady state makes no host
callback:

  * the host (stager thread) writes compacted ~20 B/packet descriptors
    into a staging window (io/rings.py ``DeviceDescRing``; pinned
    memory on the card) and ships the WHOLE window — descriptors,
    per-slot clocks and stamps — to the card in one asynchronous copy;
  * the window program (pipeline/capture.py ``RingProgram``) steps
    exactly the window's ``n`` slots through the captured step
    programs and writes each slot's packed result and aux rows into one
    output buffer (with telemetry on, the packed telemetry rider too);
  * that buffer comes back in the window's ONE copy into pinned memory,
    followed by a recorded CUDA event; the fetcher thread waits on the
    event — the window's only wait — and hands the frames out in
    order. With the double-buffered windows the fetch of window N
    overlaps the staging and the steps of window N+1.

Per frame in steady state: 1/S of an upload and 1/S of a result copy
(S = ``ring_slots``), zero host callbacks. On the forced full chain a
window makes no host read between its upload and its result copy; on
the auto path each slot's tier choice reads its dispatch flag to the
host (the reference branches on the device; ROADMAP Queue 3 lists the
difference). Window fill is adaptive, as the reference's: a lone frame
ships in a 1-slot window (the latency floor), a backlog fills the
window (throughput), a priority frame ships its window at once, and the
governor caps the fill (``set_fill_limit``).

Private tables. The reference copies the dataplane's tables once at a
ring's start, so ``dp.tables`` stays at launch state until ``stop`` (or
the pump's ``sync_sessions``) grafts the ring's state back, and
``dp.process_packed`` meanwhile steps its own copy. Captured graphs bind
tensor addresses, so here the ring steps a private clone held with its
own captured programs by the dataplane (``Dataplane.ring_checkout``):
a restart that changes no shape writes the new epoch's tables into the
held clone and captures nothing, as the reference's restart re-uses its
compiled window program. ``start`` captures every part of the window
program (both tiers on the auto path) on the calling thread before the
ring threads start.

``stats["io_callbacks"]`` counts host callbacks made by the device
program: the design makes none, and the counter stays 0.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from vpp_tpu_torch.io.rings import DESC_ROWS, DeviceDescRing
from vpp_tpu_torch.pipeline.dataplane import _MUTABLE_FIELDS, PACKED_IN_ROWS
from vpp_tpu_torch.pipeline.tables import SESSION_FIELDS
from vpp_tpu_torch.pipeline.transfer import count_device_transfer
from vpp_tpu_torch.testing import faults

if DESC_ROWS != PACKED_IN_ROWS:
    raise ImportError("io/rings.py DESC_ROWS must track "
                      "pipeline.dataplane.PACKED_IN_ROWS")

_SENTINEL = object()


class PersistentPump:
    """Host side of the device-ring persistent path over ``dp``.

    ``submit()`` hands a ``[5, B]`` packed frame in, ``result_ex()``
    yields ``(out, aux)`` per frame in submission order, ``stop()``
    flushes everything in flight and returns the final tables (the
    ring's private clone: valid until the next ring of the same key
    starts). The window program is the dataplane's selection at
    construction (``fastpath``, classifier, ML, telemetry, tenancy, the
    session hash), as the reference pump mirrors it.

    ``ring_slots`` frames per window and ``ring_windows`` staging
    buffers (>= 2: the double buffer that overlaps window N's result
    copy with window N+1's refill) are config-static shape —
    ``io.io_ring_slots`` / ``io.io_ring_windows``.
    """

    def __init__(self, dp, batch: int, ring_slots: int = 8,
                 ring_windows: int = 2):
        self.dp = dp
        self.batch = int(batch)
        self._cuda = dp.device.type == "cuda"
        self.ring = DeviceDescRing(slots=ring_slots, batch=self.batch,
                                   windows=ring_windows, pin=self._cuda)
        # latency-governor actuator (io/governor.py): the stager closes
        # a window once it holds this many slots, even with more
        # backlog queued. Written by the owning pump's dispatch thread,
        # read by the stager: a plain int (GIL-atomic), no lock — and
        # not an input of the window program beyond the fill ``n``
        self._fill_limit = self.ring.slots
        self._in: "queue.Queue" = queue.Queue()
        # dispatched windows awaiting their result fetch, in dispatch
        # order: (widx, n_frames)
        self._fetch_q: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        # the window program over the private clone (raises the
        # reference's ValueError under the overlay)
        self._prog = dp.ring_checkout(self.ring.slots, self.batch)
        self._tel = dp._tel_mode
        words = self._prog.out.numel()
        # one result buffer per staging window, reused only after the
        # window is released
        self._host_out = [torch.empty(words, dtype=torch.int32,
                                      pin_memory=self._cuda)
                          for _ in range(self.ring.windows)]
        self._events: list = [None] * self.ring.windows
        self._last_event = None
        self._tables_final = None
        self._checked_in = False
        self._checkin_lock = threading.Lock()
        # set by the owning DataplanePump (under ITS stats lock) once
        # this ring's counters have been folded into its accumulator —
        # a concurrent stats sync then must not count them again
        self.retired = False
        self._error: Optional[BaseException] = None
        self._threads: list = []
        # stager writes windows_dispatched and t_stage, fetcher writes
        # the rest — one lock serializes the counters and the snapshot
        self._stats_lock = threading.Lock()
        self.stats = {
            # windows fully exchanged (dispatched AND written back)
            "ring_windows": 0,
            # frames staged through the ring (frames vs windows*slots
            # is the window-fill ratio)
            "ring_frames": 0,
            "windows_dispatched": 0,
            # windows the stager shipped EARLY because a priority slot
            # landed (the lane's bounded-queueing mechanism)
            "priority_preempts": 0,
            # host callback invocations by the device program: the ring
            # steady state makes none (module doc)
            "io_callbacks": 0,
            # host seconds the stager spent issuing windows (upload,
            # steps, result copy: with graphs, launches and copies)
            "t_stage": 0.0,
            # dispatch flags read to the host inside windows, counted
            # where the read happens (capture.Program.replay: the auto
            # path's tier choice, one per slot; 0 on the full chain)
            "host_reads": 0,
        }
        # latest telemetry rider (fetcher-written under _stats_lock):
        # the raw int32 vector of pack_tel_rider, cumulative — the
        # owning pump unpacks it with the config geometry
        self._tel_last: Optional[np.ndarray] = None

    # --- lifecycle ---
    def start(self) -> "PersistentPump":
        """Capture every part of the window program (without stepping
        its tables), then start the stager and the fetcher."""
        self._prog.prime(_MUTABLE_FIELDS)
        for fn, name in ((self._stage_loop, "persistent-stage"),
                         (self._fetch_loop, "persistent-fetch")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("persistent loop died") from self._error

    @property
    def failed(self) -> bool:
        """True once either ring thread has died. The owning pump's
        dispatch loop polls this between bursts so a death with no
        pending submit still counts toward the ring-fault fallback."""
        return self._error is not None

    def submit(self, flat: np.ndarray, now: int,
               stamp_us: int = 0, priority: bool = False) -> None:
        """Queue one packed [5, B] frame; ``now`` is its per-slot
        timestamp (must be >= 0) and ``stamp_us`` its rx-enqueue
        microsecond stamp for the wire-latency histogram (0 =
        unstamped; ignored with telemetry off). ``priority`` marks a
        reflex-lane frame: the stager ships its window the moment the
        slot lands instead of draining the backlog into it. The frame
        is COPIED — callers may reuse their staging buffer at once."""
        if now < 0:
            raise ValueError(f"frame clock {now} < 0")
        self._check_error()
        self._in.put((int(now), int(stamp_us),
                      np.array(flat, np.int32, copy=True),
                      bool(priority)))

    def set_fill_limit(self, n_slots: int) -> None:
        """Governor actuator: cap the stager's window fill at
        ``n_slots`` (clamped to [1, ring slots]). Host-side only — the
        window program's fill is already a runtime input."""
        self._fill_limit = max(1, min(int(n_slots), self.ring.slots))

    def fill_avg(self, last: Optional[tuple] = None):
        """``(snapshot, avg_fill)`` where ``snapshot`` is the ring's
        cumulative ``(windows, slots)`` pair and ``avg_fill`` the
        average slots per window SINCE ``last`` (None until a window
        shipped in the delta) — the governor's occupancy input."""
        snap = self.ring.fill_snapshot()
        w0, s0 = last if last is not None else (0, 0)
        dw, ds = snap[0] - w0, snap[1] - s0
        return snap, (ds / dw if dw > 0 else None)

    def checkpoint_sessions(self, timeout: float = 30.0):
        """Consistent DEVICE COPY of the in-ring session state, taken
        by the stager BETWEEN windows (the only coherent read of a
        carry the ring steps in place). The snapshotter's freshness
        hook (io/pump.py ``sync_sessions``). Returns a {field: tensor}
        dict of SESSION_FIELDS, or None when the ring is stopping or
        dead or the wait times out."""
        if self._error is not None:
            return None
        ev = threading.Event()
        box: dict = {}
        self._in.put(("ckpt", ev, box))
        if not ev.wait(timeout):
            return None
        return box.get("sessions")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self.result_ex(timeout=timeout)[0]

    def result_ex(self, timeout: Optional[float] = None):
        """Like result(), but returns ``(out, aux)`` where ``aux`` is
        the frame's ``[PACKED_AUX_ROWS]`` int32 summary."""
        try:
            return self._out.get(timeout=timeout)
        except queue.Empty:
            self._check_error()  # surface the REAL cause if the loop died
            raise

    def stats_snapshot(self) -> dict:
        """Consistent copy of the ring counters plus the live overlap
        occupancy (in-flight windows, writeback lag). Host scalars
        only."""
        with self._stats_lock:
            s = dict(self.stats)
        s["ring_inflight"] = self.ring.in_flight()
        s["ring_lag"] = s.pop("windows_dispatched") - s["ring_windows"]
        return s

    def tel_raw(self) -> Optional[np.ndarray]:
        """Latest telemetry rider (raw ``pack_tel_rider`` int32
        vector; cumulative) — None until the first telemetry-on window
        wrote back."""
        with self._stats_lock:
            tel = self._tel_last
        return None if tel is None else tel.copy()

    def stop(self, join_timeout: float = 60.0):
        """Flush every queued frame through the device and return the
        final tables; the ring program goes back to the dataplane."""
        self._in.put(None)
        for t in self._threads:
            t.join(timeout=join_timeout)
            if t.is_alive():
                raise RuntimeError("persistent loop did not exit")
        try:
            # a dead fetcher may leave windows in flight: their steps
            # end before the last window's event
            if self._last_event is not None:
                self._last_event.synchronize()
            self._check_error()
            self._tables_final = self._prog.tables
        finally:
            self._checkin()
        return self._tables_final

    def _checkin(self) -> None:
        """Hand the ring program back to the dataplane, once: at stop,
        or when the stager dies (the owning pump relaunches a dead ring
        without stopping it; the dead stager issues no more work)."""
        with self._checkin_lock:
            if not self._checked_in:
                self._checked_in = True
                self.dp.ring_checkin(self._prog)

    @staticmethod
    def _is_ckpt(item) -> bool:
        return (isinstance(item, tuple) and len(item) == 3
                and item[0] == "ckpt")

    def _serve_ckpt(self, item) -> None:
        """Fulfil one checkpoint_sessions request against the carry
        between windows: device copies, ordered after the last
        window's steps on the stream."""
        _, ev, box = item
        tables = self._prog.tables
        box["sessions"] = {f: getattr(tables, f).clone()
                           for f in SESSION_FIELDS}
        ev.set()

    # --- stager: refill queue -> staged windows -> device dispatch ---
    def _dispatch(self, widx: int, n: int) -> None:
        """One window: upload it, step its ``n`` slots, start its result
        copy and record the event the fetcher waits on."""
        prog = self._prog
        t0 = time.perf_counter()
        window = self.ring.window(widx)
        if self._cuda:
            prog.rx.copy_(window, non_blocking=True)
        else:
            prog.rx.copy_(torch.from_numpy(window))
        count_device_transfer("ring.window", window, "h2d")
        now_us = 0
        if self._tel != "off":
            from vpp_tpu_torch.ops.telemetry import tel_clock_us

            now_us = tel_clock_us()
        reads = prog.prog.host_reads
        out = prog.run(n, now_us)
        reads = prog.prog.host_reads - reads
        self._host_out[widx].copy_(out, non_blocking=self._cuda)
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._events[widx] = self._last_event = ev
        with self._stats_lock:
            self.stats["t_stage"] += time.perf_counter() - t0
            self.stats["host_reads"] += reads

    def _stage_loop(self) -> None:
        try:
            stopping = False
            while not stopping:
                item = self._in.get()
                # session checkpoints at the window boundary
                while self._is_ckpt(item):
                    self._serve_ckpt(item)
                    item = self._in.get()
                if item is None:
                    break
                # a free window, or None while the fetch side is wedged
                # — poll so a fetcher death can't deadlock the stager
                while True:
                    got = self.ring.acquire(timeout=0.2)
                    if got is not None:
                        break
                    if self._error is not None:
                        return
                widx, desc, nows, stamps = got
                n = 0
                pending_ckpt = None
                preempted = False
                # adaptive fill: drain whatever is already queued up to
                # the window size (capped by the governor's fill
                # limit), never wait for more. A PRIORITY slot ships
                # the window immediately.
                limit = min(self.ring.slots, self._fill_limit)
                while True:
                    now, stamp_us, flat, pri = item
                    desc[n] = flat
                    nows[n] = now
                    stamps[n] = stamp_us
                    n += 1
                    if pri:
                        # a preempt is a window shipped early ONLY
                        # when backlog was actually waiting to fill it
                        preempted = self._in.qsize() > 0
                        break
                    if n >= limit:
                        break
                    try:
                        item = self._in.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:
                        stopping = True
                        break
                    if self._is_ckpt(item):
                        # close the window here; the request is served
                        # below against the POST-window carry
                        pending_ckpt = item
                        break
                # faults: "ring.dispatch" stands in for a device
                # transfer error here — it kills this stager exactly
                # like a real dispatch failure, which is what arms the
                # pump's ring->dispatch degraded fallback
                faults.fire("ring.dispatch")
                self._dispatch(widx, n)
                self.ring.note_fill(n)
                with self._stats_lock:
                    self.stats["windows_dispatched"] += 1
                    if preempted:
                        self.stats["priority_preempts"] += 1
                self._fetch_q.put((widx, n))
                if pending_ckpt is not None:
                    self._serve_ckpt(pending_ckpt)
        except BaseException as e:  # noqa: BLE001 — re-raised to the
            # caller from result()/stop(); a silently dead pump would
            # leave result() blocking to timeout
            self._error = e
        finally:
            self._fetch_q.put(_SENTINEL)
            if self._error is not None:
                self._checkin()
            # unblock checkpoint requesters stranded behind the stop
            # sentinel (or a stager death)
            while True:
                try:
                    item = self._in.get_nowait()
                except queue.Empty:
                    break
                if self._is_ckpt(item):
                    item[1].set()  # no "sessions" key = declined

    # --- fetcher: one result copy per window, per-frame hand-off ---
    def _fetch_loop(self) -> None:
        try:
            while True:
                item = self._fetch_q.get()
                if item is _SENTINEL:
                    return
                widx, n = item
                # faults: "ring.fetch" = the result copy failing
                faults.fire("ring.fetch")
                ev = self._events[widx]
                if ev is not None:
                    ev.synchronize()
                host = self._host_out[widx].numpy()
                count_device_transfer("ring.window", host)
                tx, aux, tel = self._prog.views(host)
                frames = [(np.array(tx[i]), np.array(aux[i]))
                          for i in range(n)]
                if tel is not None:
                    with self._stats_lock:
                        self._tel_last = np.array(tel, np.int32)
                # the staging window and its result buffer are reusable
                # once the exchange completed and the rows are copied
                self.ring.release(widx)
                for fr in frames:
                    self._out.put(fr)
                with self._stats_lock:
                    self.stats["ring_windows"] += 1
                    self.stats["ring_frames"] += n
        except BaseException as e:  # noqa: BLE001 — surfaced via
            # _check_error exactly like a stager death
            if self._error is None:
                self._error = e
