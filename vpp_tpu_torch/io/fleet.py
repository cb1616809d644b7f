"""Fleet pump: the IO tier fronting N dataplane instances (ISSUE 18).

One dispatch side (the caller's thread — ``submit()``) partitions
packed frames through :class:`vpp_tpu_torch.fleet.steering.FleetSteering`
and re-frames each instance's packets at the instance's native width;
one worker thread per instance drains a bounded queue into
``Dataplane.process_packed`` (the single-writer-per-instance law: the
worker is its instance's ONLY traffic source, so ``commit=True`` is
safe exactly like the DataplanePump it parallels).

Partial frames ride the ``flags`` valid bit (pipeline/vector.py:
frames may be partially filled) — a flushed tail frame pads with
all-zero INVALID slots the pipeline ignores, so padding never touches
session state or per-packet counters.

Conservation extends the steering identity downward::

    offered == sum(steered) + fenced + no_owner          (steering)
    steered[i] == delivered[i] + queue_drops[i] + pending[i]  (here)

``pending`` (buffered + queued) drains to zero on ``stop()``, so after
a quiesce the end-to-end identity
``offered == sum(delivered) + attributed drops`` holds EXACTLY —
the live-rebalance bench asserts it packet-for-packet.

The port's copy of ``vpp_tpu/io/fleet.py``. Each worker steps its
instance's captured packed program on the card; the aux rider comes
back to the host once a frame (the worker's only sync).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Dict, List, Optional

import numpy as np

log = logging.getLogger("vpp_tpu_torch.fleet")

# drop causes THIS layer attributes on top of the steering tier's
# STEER_DROP_CAUSES (queue overflow / failed frame — both counted
# against offered). The --counters parity pass checks the collector's
# cause axis is exactly the union.
QUEUE_DROP_CAUSES = ("queue",)


class FleetPump:
    """Queue-fronted fan-out of packed frames to fleet instances."""

    def __init__(self, steering, frame_width: int = 256,
                 queue_slots: int = 64, with_aux: bool = True):
        self.steering = steering
        self.frame_width = int(frame_width)
        self.with_aux = bool(with_aux)
        self._names: List[str] = sorted(steering.instances)
        self._queues: Dict[str, queue.Queue] = {
            n: queue.Queue(maxsize=int(queue_slots))
            for n in self._names}
        self._lock = threading.Lock()
        # dispatch-side per-instance packet buffers (columns pending
        # re-framing at frame_width)
        self._buf: Dict[str, List[np.ndarray]] = {
            n: [] for n in self._names}
        self._buffered: Dict[str, int] = {n: 0 for n in self._names}
        self._submitted: Dict[str, int] = {n: 0 for n in self._names}
        # pump-local conservation terms: the steering tier's stats are
        # cumulative across ITS lifetime (it may front many pumps), so
        # the per-pump identity accounts its own offered/drops
        self._offered = 0
        self._steer_drops: Dict[str, int] = {"fenced": 0,
                                             "no_owner": 0}
        self._delivered: Dict[str, int] = {n: 0 for n in self._names}
        self._queue_drops: Dict[str, int] = {n: 0 for n in self._names}
        self._aux: Dict[str, Optional[np.ndarray]] = {
            n: None for n in self._names}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # --- lifecycle ---------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        for name in self._names:
            t = threading.Thread(target=self._worker, args=(name,),
                                 name=f"fleet-pump-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, drain: bool = True) -> None:
        """Quiesce: flush partial buffers, drain queues (unless
        ``drain=False``), join workers."""
        if drain:
            self.flush()
            for q in self._queues.values():
                q.join()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []

    # --- dispatch side ----------------------------------------------

    def submit(self, flat: np.ndarray, **steer_kw: Any) -> None:
        """Steer one packed ``[5, B]`` frame; full native-width frames
        are enqueued immediately, the remainder buffers until the next
        submit or :meth:`flush`."""
        flat = np.asarray(flat, np.int32)
        groups, drops = self.steering.partition(flat, **steer_kw)
        with self._lock:
            self._offered += int(flat.shape[1])
            self._steer_drops["fenced"] += drops["fenced"]
            self._steer_drops["no_owner"] += drops["no_owner"]
            for name, idx in groups.items():
                self._buf[name].append(flat[:, idx])
                self._buffered[name] += int(idx.size)
                self._drain_buffer_locked(name, pad_tail=False)

    def flush(self) -> None:
        """Emit every buffered partial frame, padded with invalid
        slots to the native width."""
        with self._lock:
            for name in self._names:
                self._drain_buffer_locked(name, pad_tail=True)

    def _drain_buffer_locked(self, name: str, pad_tail: bool) -> None:
        w = self.frame_width
        while self._buffered[name] >= w or (pad_tail
                                            and self._buffered[name]):
            cols = np.concatenate(self._buf[name], axis=1)
            frame, rest = cols[:, :w], cols[:, w:]
            n_real = int(frame.shape[1])
            if n_real < w:
                pad = np.zeros((5, w - n_real), np.int32)
                frame = np.concatenate([frame, pad], axis=1)
            self._buf[name] = [rest] if rest.shape[1] else []
            self._buffered[name] -= n_real
            try:
                self._queues[name].put_nowait((frame, n_real))
                self._submitted[name] += n_real
            except queue.Full:
                # attributed, never silent: the conservation identity
                # counts these against offered
                self._queue_drops[name] += n_real

    # --- worker side -------------------------------------------------

    def _worker(self, name: str) -> None:
        dp = self.steering.instances[name]
        q = self._queues[name]
        while True:
            try:
                frame, n_real = q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                res = dp.process_packed(frame, commit=True,
                                        with_aux=self.with_aux)
                aux = (res[1].cpu().numpy().astype(np.int64)
                       if self.with_aux else None)
                with self._lock:
                    self._delivered[name] += n_real
                    if aux is not None:
                        prev = self._aux[name]
                        self._aux[name] = (aux if prev is None
                                           else prev + aux)
            except Exception:
                log.exception("fleet worker %s: frame failed "
                              "(%d packets dropped, attributed)",
                              name, n_real)
                with self._lock:
                    self._queue_drops[name] += n_real
            finally:
                q.task_done()

    # --- observability ----------------------------------------------

    def pending(self) -> int:
        with self._lock:
            buffered = sum(self._buffered.values())
            queued = sum(self._submitted[n] - self._delivered[n]
                         for n in self._names)
        return buffered + queued

    def stats_snapshot(self) -> Dict[str, Any]:
        from vpp_tpu_torch.pipeline.dataplane import PACKED_AUX_SCHEMA

        with self._lock:
            out: Dict[str, Any] = {
                "submitted": dict(self._submitted),
                "delivered": dict(self._delivered),
                "queue_drops": dict(self._queue_drops),
                "buffered": dict(self._buffered),
                "aux": {},
            }
            for name, aux in self._aux.items():
                if aux is not None:
                    out["aux"][name] = {
                        k: int(aux[i])
                        for i, k in enumerate(PACKED_AUX_SCHEMA)}
        return out

    def conservation(self) -> Dict[str, int]:
        """End-to-end identity terms (exact after ``stop()``):
        ``offered == delivered + fenced + no_owner + queue_drops
        + pending``. All terms are THIS pump's own accounting — the
        steering tier's cumulative stats span its whole lifetime."""
        with self._lock:
            return {
                "offered": self._offered,
                "delivered": sum(self._delivered.values()),
                "fenced_drops": self._steer_drops["fenced"],
                "no_owner_drops": self._steer_drops["no_owner"],
                "queue_drops": sum(self._queue_drops.values()),
                "pending": (sum(self._buffered.values())
                            + sum(self._submitted[n]
                                  - self._delivered[n]
                                  for n in self._names)),
            }
