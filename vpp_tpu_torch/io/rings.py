"""Frame rings with payload blocks: header columns + raw packet bytes.

The SPSC frame ring (native/frame_ring.cpp) carries the 12 SoA header
columns; full packet bytes travel in a payload block — a [n_slots, VEC,
snap] uint8 region indexed by the same slot number, synchronized by the
ring's head/tail (the slot's payload is owned by whoever owns the slot).
This mirrors VPP's split between vlib frame vectors and buffer memory.

Both sides can live in one process (bytearray buffers, tests/dev) or in
two (multiprocessing.shared_memory, the production daemon split).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from vpp_tpu_torch.native.ring import FrameRing

VEC = 256
DEFAULT_SNAP = 2048
DEFAULT_SLOTS = 64

# Rows of one packed descriptor slot — MUST equal
# pipeline.dataplane.PACKED_IN_ROWS (20 B/packet bit-packed layout).
# Duplicated here rather than imported: this module is shared with the
# IO daemon process, which must not import torch (pipeline.dataplane
# does). pipeline/persistent.py asserts the two agree.
DESC_ROWS = 5

DEFAULT_RING_SLOTS = 8
DEFAULT_RING_WINDOWS = 2


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def validate_ring_geometry(slots: int, windows: int) -> None:
    """Fail FAST on device-ring misconfiguration — called at YAML load
    (cmd/config.py) and at DeviceDescRing construction, so a bad knob
    is rejected with a clear message when the config is read, not at
    the first persistent-mode pump launch (the
    validate_dataplane_config pattern)."""
    if not _is_pow2(int(slots)):
        raise ValueError(
            f"io_ring_slots must be a power of two, got {slots}")
    if not _is_pow2(int(windows)) or int(windows) < 2:
        raise ValueError(
            f"io_ring_windows must be a power of two >= 2 "
            f"(double buffer), got {windows}")


class DeviceDescRing:
    """Host half of the device-resident descriptor rings.

    The port's copy of ``vpp_tpu/io/rings.py`` ``DeviceDescRing``: on a
    CUDA device (``pin``) each window is one page-locked buffer whose
    descriptors, clocks and stamps ship to the card in one asynchronous
    copy; a window is reused only after ``release(widx)``, which the
    fetcher calls once that window's result copy — issued after its
    upload in stream order — has completed.

    ``windows`` staging buffers of ``slots`` descriptor slots
    each ([slots, DESC_ROWS, batch] int32, ~20 B/packet — the packed
    pipeline boundary), cycled in strict ring order: ``acquire()``
    hands out the next window for staging, ``release()`` returns it
    once its transfer (and the paired tx-ring fetch) completed. With
    the default double buffer, the pump stages + dispatches window
    N+1 while window N's results are still being fetched — the upload
    of the next refill and the writeback of the previous window
    overlap, which is what makes the steady state one exchange per
    window instead of two blocking callbacks per frame.

    Geometry is config-static (``io.io_ring_slots`` /
    ``io.io_ring_windows``): ``slots`` is part of the device program's
    jit-cache key the way ``sess_ways`` is carried in the session
    arrays' shape, so geometry never retraces at runtime.

    Thread contract: ONE stager calls acquire(), one fetcher calls
    release() — the cyclic cursor + per-window state are guarded by a
    condition variable, so a release landing concurrently with the
    stager blocking in acquire() wakes it exactly once (the
    double-buffer swap test races these on purpose).
    """

    def __init__(self, slots: int = DEFAULT_RING_SLOTS, batch: int = VEC,
                 windows: int = DEFAULT_RING_WINDOWS, pin: bool = False):
        validate_ring_geometry(slots, windows)
        self.slots = int(slots)
        self.batch = int(batch)
        self.windows = int(windows)
        # one int32 buffer per window: the descriptor slots, then the
        # per-slot clocks, then the stamps (``window_words`` — the
        # layout the window program's rx buffer takes in ONE copy).
        # ``pin``: page-locked host tensors (torch imported only then),
        # so that copy is truly asynchronous; ``_buf`` keeps them, the
        # numpy views below share their memory.
        words = self.window_words()
        if pin:
            import torch

            self._buf = [torch.zeros(words, dtype=torch.int32,
                                     pin_memory=True)
                         for _ in range(self.windows)]
            flat = [b.numpy() for b in self._buf]
        else:
            self._buf = None
            flat = [np.zeros(words, np.int32) for _ in range(self.windows)]
        n_desc = self.slots * DESC_ROWS * self.batch
        self._desc = [f[:n_desc].reshape(self.slots, DESC_ROWS, self.batch)
                      for f in flat]
        self._now = [f[n_desc:n_desc + self.slots] for f in flat]
        # the spare descriptor lane: per-slot rx-enqueue
        # microsecond stamps the window program turns into wire-latency
        # histogram samples (0 = unstamped; telemetry off leaves the
        # lane zero — 4 B/slot, not worth gating the allocation)
        self._stamp = [f[n_desc + self.slots:] for f in flat]
        self._flat = flat
        self._held = [False] * self.windows
        self._next = 0  # cyclic acquire cursor
        self._cv = threading.Condition(threading.Lock())
        # per-window fill occupancy: how many slots each
        # shipped window actually carried — the latency governor's
        # occupancy input (lone windows mean shrinking the fill cap
        # cannot lower p99 any further) and the `show governor` /
        # `show io` fill telemetry. note_fill() is called by the
        # stager at dispatch; readers take consistent (windows, slots)
        # pairs via fill_snapshot().
        self._fill_windows = 0
        self._fill_slots = 0

    def window_words(self) -> int:
        """int32 words of one staging window: ``slots`` descriptors of
        ``[DESC_ROWS, batch]``, the ``slots`` clocks, the ``slots``
        stamps."""
        return self.slots * (DESC_ROWS * self.batch + 2)

    def window(self, widx: int):
        """The whole staging window ``widx`` as one flat int32 buffer:
        the pinned tensor when the ring was built with ``pin``, else
        the numpy array the views share."""
        return self._flat[widx] if self._buf is None else self._buf[widx]

    def note_fill(self, n_slots: int) -> None:
        """Record one shipped window's slot occupancy."""
        with self._cv:
            self._fill_windows += 1
            self._fill_slots += int(n_slots)

    def fill_snapshot(self) -> Tuple[int, int]:
        """``(windows_shipped, slots_filled)`` cumulative — callers
        delta between reads for a recent-window average fill."""
        with self._cv:
            return self._fill_windows, self._fill_slots

    def window_bytes(self) -> int:
        """Descriptor bytes one window ships each way (the window-math
        numerator of docs/IO_PATH.md)."""
        return self._desc[0].nbytes

    def acquire(self, timeout: Optional[float] = None):
        """The next staging window in cyclic order, or None on timeout
        (every earlier window still in flight — host-side
        backpressure). Returns ``(widx, desc, now, stamp)`` views
        (``stamp`` is the per-slot rx-enqueue µs lane); the caller
        owns them until ``release(widx)``."""
        with self._cv:
            w = self._next
            if not self._cv.wait_for(lambda: not self._held[w],
                                     timeout=timeout):
                return None
            self._held[w] = True
            self._next = (w + 1) % self.windows
            return w, self._desc[w], self._now[w], self._stamp[w]

    def release(self, widx: int) -> None:
        """Window transfer complete — buffer reusable. Any-order safe
        (the fetcher releases in dispatch order, but a shutdown path
        may release a window it never dispatched)."""
        with self._cv:
            if not self._held[widx]:
                raise RuntimeError(
                    f"device-ring window {widx} released while free")
            self._held[widx] = False
            self._cv.notify_all()

    def in_flight(self) -> int:
        """Windows currently held (staged or awaiting writeback)."""
        with self._cv:
            return sum(self._held)


class Frame(NamedTuple):
    cols: Dict[str, np.ndarray]   # 12 ring columns, [VEC]
    n: int                        # valid packet count
    epoch: int
    payload: np.ndarray           # uint8 [VEC, snap] view for this slot


class IORing:
    """A FrameRing plus its payload block (one direction)."""

    def __init__(self, ring_buf, payload_buf, n_slots: int = DEFAULT_SLOTS,
                 snap: int = DEFAULT_SNAP, create: bool = True):
        self.ring = FrameRing(ring_buf, n_slots=n_slots, create=create)
        n_slots = self.ring.n_slots
        self.snap = snap
        need = n_slots * VEC * snap
        mv = memoryview(payload_buf)
        if len(mv) < need:
            raise ValueError(f"payload buffer too small: {len(mv)} < {need}")
        self.payload = np.frombuffer(mv, np.uint8, count=need).reshape(
            n_slots, VEC, snap
        )
        lib = self.ring.lib
        self._hdr_size = int(lib.fr_header_size())
        self._slot_size = int(lib.fr_slot_size())

    @classmethod
    def required_sizes(cls, n_slots: int = DEFAULT_SLOTS,
                       snap: int = DEFAULT_SNAP) -> Tuple[int, int]:
        return FrameRing.required_size(n_slots), n_slots * VEC * snap

    def _slot_index(self, off: int) -> int:
        return (off - self._hdr_size) // self._slot_size

    # --- producer ---
    def push(self, cols: Dict[str, np.ndarray], n: int,
             payload: Optional[np.ndarray] = None, epoch: int = 0) -> bool:
        """Write one frame (+payload rows) — False if full.

        Payload rows are copied only up to the frame's max wire length
        (pkt_len + ethernet header), not the full snap width: consumers
        never read past wire_len per packet, and copying snap bytes per
        row (512 KB/frame at snap 2048) would bottleneck the host path
        on memcpy for small-packet traffic."""
        off = self.ring.reserve()
        if off < 0:
            return False
        if payload is not None:
            w = self.snap
            if n and "pkt_len" in cols:
                w = min(self.snap, int(np.max(cols["pkt_len"][:n])) + 14)
            self.payload[self._slot_index(off), :n, :w] = payload[:n, :w]
        self.ring.write_slot(off, cols, n, epoch)
        self.ring.commit()
        return True

    def push_packed(self, packed: np.ndarray, poff: int, n: int,
                    rx_frame: Frame, host_if: int, epoch: int,
                    cause: np.ndarray) -> bool:
        """Fast-path producer: decode packed device results
        ([5, bucket] int32, columns [poff, poff+n)) STRAIGHT into the
        reserved slot's column block in one native call (pass-through
        columns from the rx slot, non-IPv4 re-punted to ``host_if``),
        then copy the payload rows. Per-packet drop_cause lands in
        ``cause`` (int32[VEC]) for the caller. False if full."""
        from vpp_tpu_torch.native.pktio import unpack_to_slot

        ring = self.ring
        off = ring.reserve()
        if off < 0:
            return False
        hdr = np.frombuffer(ring._mv, np.uint32, count=2, offset=off)
        hdr[0] = n
        hdr[1] = epoch
        base = ring._arr.ctypes.data
        unpack_to_slot(
            packed, poff, n,
            rx_frame.cols["src_ip"].ctypes.data,
            base + off + ring._slot_hdr, host_if, cause,
        )
        if rx_frame.payload is not None:
            w = self.snap
            if n:
                w = min(self.snap,
                        int(np.max(rx_frame.cols["pkt_len"][:n])) + 14)
            self.payload[self._slot_index(off), :n, :w] = \
                rx_frame.payload[:n, :w]
        ring.commit()
        return True

    # --- consumer ---
    def peek(self) -> Optional[Frame]:
        """Zero-copy views of the oldest frame (cols + payload), or None.
        Valid until release()."""
        lib, base = self.ring.lib, self.ring._base
        off = lib.fr_consume_peek(base)
        if off < 0:
            return None
        idx = self._slot_index(off)
        hdr = np.frombuffer(self.ring._mv, np.uint32, count=2, offset=off)
        return Frame(
            self.ring._slot_views(off), int(hdr[0]), int(hdr[1]),
            self.payload[idx],
        )

    def peek_nth(self, k: int) -> Optional[Frame]:
        """Zero-copy views of the k-th oldest pending frame (k=0 ==
        peek()), or None if fewer than k+1 frames are committed. The
        slot stays ring-owned until k+1 release() calls happen, so the
        views are stable while the frame is in flight on the device."""
        lib, base = self.ring.lib, self.ring._base
        off = lib.fr_consume_peek_nth(base, k)
        if off < 0:
            return None
        idx = self._slot_index(off)
        hdr = np.frombuffer(self.ring._mv, np.uint32, count=2, offset=off)
        return Frame(
            self.ring._slot_views(off), int(hdr[0]), int(hdr[1]),
            self.payload[idx],
        )

    def release(self) -> None:
        self.ring.release()

    def pending(self) -> int:
        return self.ring.pending()


class IORingPair:
    """rx + tx rings over in-process buffers or named shared memory."""

    def __init__(self, n_slots: int = DEFAULT_SLOTS, snap: int = DEFAULT_SNAP,
                 shm_name: Optional[str] = None, create: bool = True):
        ring_sz, pay_sz = IORing.required_sizes(n_slots, snap)
        self._shm = None
        self._views: list = []
        if shm_name is None:
            bufs = [bytearray(ring_sz), bytearray(pay_sz),
                    bytearray(ring_sz), bytearray(pay_sz)]
        else:
            from multiprocessing import shared_memory

            total = 2 * (ring_sz + pay_sz)
            if create:
                try:
                    self._shm = shared_memory.SharedMemory(
                        name=shm_name, create=True, size=total
                    )
                except FileExistsError:
                    # A crashed previous agent (kill -9 / OOM) leaves the
                    # segment behind; the restart must reclaim it, not
                    # fail to boot until an operator clears /dev/shm.
                    stale = shared_memory.SharedMemory(name=shm_name)
                    stale.close()
                    stale.unlink()
                    self._shm = shared_memory.SharedMemory(
                        name=shm_name, create=True, size=total
                    )
            else:
                self._shm = shared_memory.SharedMemory(name=shm_name)
                # Python < 3.13 registers an ATTACHED segment with this
                # process's resource tracker too, which unlinks it when
                # the process exits (a SIGKILL included): the first IO
                # daemon to die would take the agent's ring name with it
                # and every respawn would fail to attach. The creator
                # owns the segment; an attacher leaves it alone.
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self._shm._name, "shared_memory")
            mv = self._shm.buf
            o = 0
            bufs = []
            for sz in (ring_sz, pay_sz, ring_sz, pay_sz):
                view = mv[o:o + sz]
                self._views.append(view)
                bufs.append(view)
                o += sz
        self.rx = IORing(bufs[0], bufs[1], n_slots, snap, create=create)
        self.tx = IORing(bufs[2], bufs[3], n_slots, snap, create=create)

    def close(self, unlink: bool = False) -> None:
        # Numpy arrays + memoryview slices into the shm buffer must all
        # be dropped before SharedMemory.close() (it refuses while
        # exported pointers exist); anything still pinned is reclaimed at
        # process exit, so failures here must not mask real errors.
        import gc

        for ring in (self.rx, self.tx):
            if ring is not None:
                ring.payload = None
                ring.ring._arr = None
                ring.ring._mv = None
                ring.ring._base = None
        self.rx = self.tx = None
        gc.collect()
        if self._shm is not None:
            for v in self._views:
                try:
                    v.release()
                except BufferError:
                    pass
            self._views.clear()
            try:
                self._shm.close()
            except BufferError:
                pass
            if unlink:
                try:
                    self._shm.unlink()
                except FileNotFoundError:
                    pass
            self._shm = None
