"""ctypes bindings for the native packet codec (pkt_io.cpp).

The port's copy of ``vpp_tpu/native/pktio.py`` and its source.

Batch wire-format work — ethernet/IPv4/L4 parse into the ring's SoA
columns, header rewrite with incremental checksums, VXLAN encap/decap —
one ctypes call per 256-packet frame. This is the native input/output
node layer of the data plane (reference: VPP's af-packet-input /
ethernet-input / ip4-rewrite / interface-output C graph nodes).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from vpp_tpu_torch.native.ring import RING_COLUMNS, load_native

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "pkt_io.cpp")
_BUILD_DIR = (
    os.path.join(_PKG_DIR, "build")
    if os.access(_PKG_DIR, os.W_OK)
    else os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"vpp_tpu_torch_native_{os.getuid()}"
    )
)
_LIB = os.path.join(_BUILD_DIR, "libpktio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

VEC = 256
N_COLUMNS = len(RING_COLUMNS)

FLAG_VALID = 1
FLAG_NON_IP4 = 2
FLAG_TRUNC = 4   # captured < claimed length: drop, never transmit

_COL_INDEX = {name: i for i, (name, _) in enumerate(RING_COLUMNS)}


def flatten_cols(cols) -> np.ndarray:
    """Column dict → the contiguous [N_COLUMNS, VEC] int32 block the
    native calls consume. Passes a pre-flattened block through, so hot
    paths flatten ONCE and hand the same buffer to rewrite + dispatch."""
    if isinstance(cols, np.ndarray):
        return cols
    flat = np.zeros((N_COLUMNS, VEC), np.int32)
    for name, arr in cols.items():
        flat[_COL_INDEX[name]] = np.asarray(arr).view(np.int32)
    return flat


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_native(_SRC, _LIB)
        lib.pio_vec.restype = ctypes.c_uint32
        lib.pio_columns.restype = ctypes.c_uint32
        lib.pio_parse.restype = ctypes.c_uint32
        lib.pio_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint32,
        ]
        lib.pio_rewrite.restype = None
        lib.pio_rewrite.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint32,
        ]
        lib.pio_encap.restype = ctypes.c_uint32
        lib.pio_encap.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint16, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pio_decap_offset.restype = ctypes.c_uint32
        lib.pio_decap_offset.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.pio_send_batch.restype = ctypes.c_int32
        lib.pio_send_batch.argtypes = [
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
        ]
        lib.pio_recv_batch.restype = ctypes.c_int32
        lib.pio_recv_batch.argtypes = [
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32,
        ]
        lib.pio_parse_inplace.restype = ctypes.c_uint32
        lib.pio_parse_inplace.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.pio_decap_batch.restype = ctypes.c_uint32
        lib.pio_decap_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.pio_encap_tx_batch.restype = ctypes.c_int32
        lib.pio_encap_tx_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_uint32,
        ]
        lib.pio_mac_put.restype = ctypes.c_int32
        lib.pio_mac_put.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32,
        ]
        lib.pio_mac_get.restype = ctypes.c_int32
        lib.pio_mac_get.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.pio_mac_unpin.restype = ctypes.c_int32
        lib.pio_mac_unpin.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.pio_mac_learn.restype = None
        lib.pio_mac_learn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint32,
        ]
        lib.pio_tx_dispatch.restype = None
        lib.pio_tx_dispatch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pio_pack_batch.restype = None
        lib.pio_pack_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.pio_unpack_to_slot.restype = None
        lib.pio_unpack_to_slot.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p,
        ]
        assert int(lib.pio_vec()) == VEC
        assert int(lib.pio_columns()) == N_COLUMNS
        _lib = lib
        return lib


class MacTable:
    """Native (ip → MAC) neighbor table: static entries from the control
    plane (the reference's configured per-pod static ARPs,
    plugins/contiv/pod.go:375-452) plus rx learning, stored in numpy
    arrays the C helpers operate on — lookup AND learning run inside
    the per-frame native calls, never per packet in Python."""

    def __init__(self, capacity: int = 4096):
        assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
        self.capacity = capacity
        self.ips = np.zeros(capacity, np.uint32)
        self.macs = np.zeros((capacity, 6), np.uint8)
        # per-slot seqlock word (0 empty, odd writing, even>0 valid)
        self.seq = np.zeros(capacity, np.uint32)
        # pinned = static control-plane entry: rx learning may refresh
        # its MAC but never evict it for an unrelated IP
        self.pin = np.zeros(capacity, np.uint8)
        self._lib = _load()

    def put(self, ip: int, mac: bytes, pin: bool = True) -> int:
        """Install an entry; ``pin`` (default, the control-plane path)
        protects it from learning-pressure eviction. Returns 0 when the
        entry could NOT be installed (unpinned put into a fully pinned
        probe run, or pathological contention), 1 on a clean install,
        and 2 when the install DISPLACED another IP's pinned entry (a
        pinned put into a fully pinned probe run) — control-plane
        callers must surface 0 and 2, never swallow them."""
        return int(self._lib.pio_mac_put(
            self.ips.ctypes.data_as(ctypes.c_void_p),
            self.macs.ctypes.data_as(ctypes.c_void_p),
            self.seq.ctypes.data_as(ctypes.c_void_p),
            self.pin.ctypes.data_as(ctypes.c_void_p),
            self.capacity, ip & 0xFFFFFFFF,
            (ctypes.c_char * 6).from_buffer_copy(mac),
            1 if pin else 0,
        ))

    def unpin(self, ip: int) -> bool:
        """Drop an entry's static pin when its interface is unwired.
        The table is insert-only (no tombstones), so the entry stays
        resolvable but becomes evictable/refreshable like any learned
        entry instead of holding pin-limited space forever. True if an
        entry for ``ip`` existed."""
        return bool(self._lib.pio_mac_unpin(
            self.ips.ctypes.data_as(ctypes.c_void_p),
            self.pin.ctypes.data_as(ctypes.c_void_p),
            self.seq.ctypes.data_as(ctypes.c_void_p),
            self.capacity, ip & 0xFFFFFFFF,
        ))

    def get(self, ip: int) -> Optional[bytes]:
        out = np.zeros(6, np.uint8)
        found = self._lib.pio_mac_get(
            self.ips.ctypes.data_as(ctypes.c_void_p),
            self.macs.ctypes.data_as(ctypes.c_void_p),
            self.seq.ctypes.data_as(ctypes.c_void_p),
            self.capacity, ip & 0xFFFFFFFF,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out.tobytes() if found else None

    def entries(self) -> list:
        """Snapshot of valid entries: [(ip, mac_bytes, pinned), ...]
        (debug/CLI path — races with writers are benign here, a torn
        row just shows a transient value in `show neighbors`)."""
        valid = (self.seq > 0) & (self.seq % 2 == 0)
        return [
            (int(self.ips[i]), self.macs[i].tobytes(), bool(self.pin[i]))
            for i in np.nonzero(valid)[0]
        ]

    def learn(self, cols: Dict[str, np.ndarray], payload: np.ndarray,
              n: int) -> None:
        """Learn (src_ip → source MAC) for a parsed frame in one native
        pass over its flags/src_ip columns + payload source MACs."""
        flags = np.ascontiguousarray(cols["flags"], np.int32)
        src = np.ascontiguousarray(cols["src_ip"]).view(np.int32)
        self._lib.pio_mac_learn(
            self.ips.ctypes.data_as(ctypes.c_void_p),
            self.macs.ctypes.data_as(ctypes.c_void_p),
            self.seq.ctypes.data_as(ctypes.c_void_p),
            self.pin.ctypes.data_as(ctypes.c_void_p),
            self.capacity,
            flags.ctypes.data_as(ctypes.c_void_p),
            src.ctypes.data_as(ctypes.c_void_p),
            payload.ctypes.data_as(ctypes.c_void_p),
            payload.shape[1], n,
        )


class PacketCodec:
    """Frame-batch codec over a flat [N_COLUMNS, VEC] int32 scratch."""

    def __init__(self, snap: int = 2048):
        self.lib = _load()
        self.snap = snap

    def parse(
        self, frames: list, rx_if: int,
        payload: np.ndarray,
    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Parse raw ethernet frames (list of bytes) into SoA columns,
        copying each frame into ``payload`` (uint8 [VEC, snap])."""
        n = min(len(frames), VEC)
        buf = b"".join(frames[:n])
        bufs = np.frombuffer(buf, np.uint8)
        lens = np.array([len(f) for f in frames[:n]], np.uint32)
        offsets = np.zeros(n, np.uint64)
        if n > 1:
            offsets[1:] = np.cumsum(lens[:-1], dtype=np.uint64)
        flat = np.zeros((N_COLUMNS, VEC), np.int32)
        assert payload.shape == (VEC, self.snap) and payload.dtype == np.uint8
        self.lib.pio_parse(
            bufs.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            n, rx_if,
            flat.ctypes.data_as(ctypes.c_void_p),
            payload.ctypes.data_as(ctypes.c_void_p),
            self.snap,
        )
        cols = {
            name: flat[i].view(dtype)
            for i, (name, dtype) in enumerate(RING_COLUMNS)
        }
        return cols, n

    def rewrite(self, cols, payload: np.ndarray, n: int) -> None:
        """Patch stored frames in ``payload`` from (rewritten) columns
        (dict or pre-flattened block), fixing IPv4 + L4 checksums in
        place."""
        flat = flatten_cols(cols)
        self.lib.pio_rewrite(
            flat.ctypes.data_as(ctypes.c_void_p),
            payload.ctypes.data_as(ctypes.c_void_p),
            n, self.snap,
        )

    def encap(self, frame: np.ndarray, frame_len: int, src_ip: int,
              dst_ip: int, src_port: int, vni: int,
              src_mac: bytes, dst_mac: bytes) -> bytes:
        out = np.zeros(50 + frame_len, np.uint8)
        total = self.lib.pio_encap(
            frame.ctypes.data_as(ctypes.c_void_p), frame_len,
            src_ip & 0xFFFFFFFF, dst_ip & 0xFFFFFFFF, src_port & 0xFFFF,
            vni,
            (ctypes.c_char * 6).from_buffer_copy(src_mac),
            (ctypes.c_char * 6).from_buffer_copy(dst_mac),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out[:total].tobytes()

    def send_batch(self, fd: int, payload: np.ndarray,
                   rows: np.ndarray, lens: np.ndarray, n: int) -> int:
        """Transmit ``n`` frames (payload rows selected by ``rows``,
        wire lengths ``lens``) over socket ``fd`` with sendmmsg — one
        syscall per 64 frames instead of one per packet. Returns frames
        actually sent (short on tx-queue-full)."""
        if n == 0:
            return 0
        rows = np.ascontiguousarray(rows[:n], np.uint32)
        lens = np.ascontiguousarray(lens[:n], np.uint32)
        return int(self.lib.pio_send_batch(
            fd, payload.ctypes.data_as(ctypes.c_void_p), payload.shape[1],
            rows.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p), n,
        ))

    def recv_batch(self, fd: int, scratch: np.ndarray,
                   lens: np.ndarray) -> int:
        """Drain up to VEC frames from socket ``fd`` straight into the
        payload scratch rows (recvmmsg; no intermediate bytes objects).
        ``lens`` (uint32 [VEC]) receives each frame's byte count."""
        return int(self.lib.pio_recv_batch(
            fd, scratch.ctypes.data_as(ctypes.c_void_p), scratch.shape[1],
            lens.ctypes.data_as(ctypes.c_void_p), scratch.shape[0],
        ))

    def parse_inplace(self, scratch: np.ndarray, lens: np.ndarray,
                      n: int, rx_if: int) -> Tuple[Dict[str, np.ndarray], int]:
        """Parse frames already resident in ``scratch`` rows (written by
        recv_batch) into SoA columns — the zero-copy fast path."""
        flat = np.zeros((N_COLUMNS, VEC), np.int32)
        n = int(self.lib.pio_parse_inplace(
            scratch.ctypes.data_as(ctypes.c_void_p), scratch.shape[1],
            lens.ctypes.data_as(ctypes.c_void_p), n, rx_if,
            flat.ctypes.data_as(ctypes.c_void_p),
        ))
        cols = {
            name: flat[i].view(dtype)
            for i, (name, dtype) in enumerate(RING_COLUMNS)
        }
        return cols, n

    def encap_tx_batch(self, cols, payload: np.ndarray, rows: np.ndarray,
                       n: int, vtep_ip: int, vni: int, src_mac: bytes,
                       mac: "MacTable", fd: int, fd_is_sock: bool,
                       scratch: np.ndarray) -> int:
        """VXLAN-encap the selected payload rows into ``scratch`` rows
        and transmit them toward the uplink in one native pass (pkt_len,
        next_hop and dst_ip come straight from the flat column block;
        outer headers + neighbor-table VTEP MAC + sendmmsg). Returns
        frames sent."""
        if n == 0:
            return 0
        flat = flatten_cols(cols)
        return int(self.lib.pio_encap_tx_batch(
            flat.ctypes.data_as(ctypes.c_void_p),
            payload.ctypes.data_as(ctypes.c_void_p), payload.shape[1],
            np.ascontiguousarray(rows[:n], np.uint32).ctypes.data_as(
                ctypes.c_void_p),
            n, vtep_ip & 0xFFFFFFFF, vni & 0xFFFFFF,
            (ctypes.c_char * 6).from_buffer_copy(src_mac),
            mac.ips.ctypes.data_as(ctypes.c_void_p),
            mac.macs.ctypes.data_as(ctypes.c_void_p),
            mac.seq.ctypes.data_as(ctypes.c_void_p),
            mac.capacity, fd, 1 if fd_is_sock else 0,
            scratch.ctypes.data_as(ctypes.c_void_p), scratch.shape[1],
        ))

    def tx_dispatch(self, cols, payload: np.ndarray,
                    n: int, if_indices: np.ndarray, if_fds: np.ndarray,
                    if_sock: np.ndarray, if_macs: np.ndarray,
                    uplink_if: int, host_if: int,
                    mac: "MacTable") -> Tuple[np.ndarray, np.ndarray]:
        """One native pass over a tx frame: validity/trunc policy,
        disposition switch, Ethernet addressing from the neighbor
        table, per-egress batching, sendmmsg/write transmission.

        Returns (counters, remote_rows): counters = uint32
        [tx_pkts, tx_drops, tx_punts, trunc_drops, n_remote];
        remote_rows[:n_remote] are rows the caller must VXLAN-
        encapsulate (REMOTE disposition with a peer next-hop).
        ``cols`` may be a dict or a pre-flattened block (flatten_cols —
        the daemon flattens once for rewrite + dispatch)."""
        flat = flatten_cols(cols)
        remote = np.zeros(VEC, np.uint32)
        counters = np.zeros(5, np.uint32)
        self.lib.pio_tx_dispatch(
            flat.ctypes.data_as(ctypes.c_void_p),
            payload.ctypes.data_as(ctypes.c_void_p),
            payload.shape[1], n,
            if_indices.ctypes.data_as(ctypes.c_void_p),
            if_fds.ctypes.data_as(ctypes.c_void_p),
            if_sock.ctypes.data_as(ctypes.c_void_p),
            if_macs.ctypes.data_as(ctypes.c_void_p),
            len(if_indices), uplink_if, host_if,
            mac.ips.ctypes.data_as(ctypes.c_void_p),
            mac.macs.ctypes.data_as(ctypes.c_void_p),
            mac.seq.ctypes.data_as(ctypes.c_void_p),
            mac.capacity,
            remote.ctypes.data_as(ctypes.c_void_p),
            counters.ctypes.data_as(ctypes.c_void_p),
        )
        return counters, remote

    def decap_batch(self, scratch: np.ndarray, lens: np.ndarray,
                    n: int, vni: int) -> int:
        """Decap every VXLAN row of segment ``vni`` in place (inner
        frame shifted to row start, lens shrunk) in ONE native pass —
        the uplink rx path, where a per-packet ctypes decap call was
        the throughput cap. Returns rows decapped."""
        return int(self.lib.pio_decap_batch(
            scratch.ctypes.data_as(ctypes.c_void_p), scratch.shape[1],
            lens.ctypes.data_as(ctypes.c_void_p), n, vni & 0xFFFFFF,
        ))

    def decap_offset(self, frame: bytes, vni: int) -> int:
        """Offset of the inner frame if this is a VXLAN datagram for
        segment ``vni`` (I-flag set, VNI match), else 0."""
        arr = np.frombuffer(frame, np.uint8)
        return int(self.lib.pio_decap_offset(
            arr.ctypes.data_as(ctypes.c_void_p), len(arr), vni & 0xFFFFFF
        ))


# --- pump fast-path kernels (one GIL-releasing native call per batch /
# per frame; layouts mirror pipeline/dataplane.py's packed boundary) ---

def pack_batch(slot_bases: np.ndarray, ns: np.ndarray, n_frames: int,
               flat: np.ndarray, non_ip: np.ndarray) -> None:
    """Pack ``n_frames`` rx ring slots (column-block base addresses in
    ``slot_bases`` uint64) sequentially into ``flat`` [5, bucket] int32,
    masking non-IPv4/truncated packets invalid and reporting the
    non-ip punt bit per packed column in ``non_ip`` (uint8[bucket])."""
    _load().pio_pack_batch(
        slot_bases.ctypes.data_as(ctypes.c_void_p),
        ns.ctypes.data_as(ctypes.c_void_p),
        n_frames,
        flat.ctypes.data_as(ctypes.c_void_p),
        flat.shape[1],
        non_ip.ctypes.data_as(ctypes.c_void_p),
    )


def unpack_to_slot(packed: np.ndarray, off: int, n: int,
                   rx_slot_base: int, tx_slot_base: int, host_if: int,
                   cause: np.ndarray) -> None:
    """Decode packed result columns [off, off+n) straight into a
    reserved TX ring slot's column block (pass-through columns from the
    rx slot, non-IPv4 re-punted to ``host_if``); per-packet drop_cause
    lands in ``cause`` (int32[VEC])."""
    _load().pio_unpack_to_slot(
        packed.ctypes.data_as(ctypes.c_void_p), packed.shape[1],
        off, n, ctypes.c_void_p(rx_slot_base),
        ctypes.c_void_p(tx_slot_base),
        host_if, cause.ctypes.data_as(ctypes.c_void_p),
    )
