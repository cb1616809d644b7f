"""ctypes bindings for the native frame ring (native/frame_ring.cpp).

The port's copy of ``vpp_tpu/native/ring.py`` and its source: the ring
layout is byte-identical to the reference's, so either package's side
reads frames the other wrote over one buffer (the IO daemon shares
these rings across a process boundary).

The ring lives in caller-provided shared memory
(multiprocessing.shared_memory for cross-process, a plain bytearray for
in-process), so the same binding serves the agent side and the IO side.
Column order MUST match vpp_tpu_torch.pipeline.vector.PacketVector's
fields — a committed slot is viewed as nine numpy arrays, zero-copy,
and can be lifted into a PacketVector of tensors for the step.

Build: compiled on demand with g++ into native/build/libframering.so
(cached; rebuilt when the source is newer).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

# First nine must match PacketVector field order (pipeline/vector.py);
# the last three are IO-direction columns (tx disposition, VXLAN peer,
# spare metadata) consumed by the IO daemon, not the pipeline.
PV_COLUMNS: Tuple[Tuple[str, type], ...] = (
    ("src_ip", np.uint32),
    ("dst_ip", np.uint32),
    ("proto", np.int32),
    ("sport", np.int32),
    ("dport", np.int32),
    ("ttl", np.int32),
    ("pkt_len", np.int32),
    ("rx_if", np.int32),
    ("flags", np.int32),
)
RING_COLUMNS: Tuple[Tuple[str, type], ...] = PV_COLUMNS + (
    ("disp", np.int32),
    ("next_hop", np.uint32),
    ("meta", np.int32),
)

# Source ships inside the package so installed wheels can build it
# (cache goes to a writable build dir beside the source, or TMPDIR when
# the package directory is read-only, e.g. a system site-packages).
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "frame_ring.cpp")
_BUILD_DIR = (
    os.path.join(_PKG_DIR, "build")
    if os.access(_PKG_DIR, os.W_OK)
    else os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"vpp_tpu_torch_native_{os.getuid()}"
    )
)
_LIB = os.path.join(_BUILD_DIR, "libframering.so")

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_native(src: str, lib: str, force: bool = False) -> str:
    """Compile one native source if missing/stale; returns the .so path."""
    with _build_lock:
        if (
            not force
            and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)
        ):
            return lib
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        # per-process tmp name: concurrent builds from separate processes
        # must not clobber each other's output mid-write
        tmp = f"{lib}.tmp.{os.getpid()}.so"
        proc = subprocess.run(
            ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build of {os.path.basename(src)} failed "
                f"(g++ rc={proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, lib)
        return lib


def build_library(force: bool = False) -> str:
    """Compile the ring library if missing/stale; returns the .so path."""
    return build_native(_SRC, _LIB, force)


def load_native(src: str, lib_path: str) -> ctypes.CDLL:
    """Build-if-stale then dlopen, with a rebuild fallback: a cached .so
    from another arch/libc (copied build dir, container image change)
    passes the mtime check but fails to load — force a recompile from
    source instead of surfacing the dlopen error."""
    path = build_native(src, lib_path)
    try:
        return ctypes.CDLL(path)
    except OSError:
        return ctypes.CDLL(build_native(src, lib_path, force=True))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    # build_library no-ops when the cached .so is fresh, and rebuilds on
    # source changes — loading a stale binary would silently run old
    # slot-layout semantics against peers built from the new source
    lib = load_native(_SRC, _LIB)
    lib.fr_required_size.restype = ctypes.c_uint64
    lib.fr_required_size.argtypes = [ctypes.c_uint32]
    for fn in ("fr_slot_size", "fr_vec", "fr_columns", "fr_header_size",
               "fr_slot_header_size"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = []
    lib.fr_create.restype = ctypes.c_int
    lib.fr_create.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.fr_attach.restype = ctypes.c_int
    lib.fr_attach.argtypes = [ctypes.c_void_p]
    lib.fr_produce_reserve.restype = ctypes.c_int64
    lib.fr_produce_reserve.argtypes = [ctypes.c_void_p]
    lib.fr_produce_commit.restype = None
    lib.fr_produce_commit.argtypes = [ctypes.c_void_p]
    lib.fr_consume_peek.restype = ctypes.c_int64
    lib.fr_consume_peek.argtypes = [ctypes.c_void_p]
    lib.fr_consume_peek_nth.restype = ctypes.c_int64
    lib.fr_consume_peek_nth.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.fr_consume_release.restype = ctypes.c_int
    lib.fr_consume_release.argtypes = [ctypes.c_void_p]
    lib.fr_n_slots.restype = ctypes.c_uint32
    lib.fr_n_slots.argtypes = [ctypes.c_void_p]
    lib.fr_pending.restype = ctypes.c_uint64
    lib.fr_pending.argtypes = [ctypes.c_void_p]
    lib.fr_write_frame.restype = None
    lib.fr_write_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.fr_read_frame.restype = None
    lib.fr_read_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    _lib = lib
    return lib


class FrameRing:
    """One SPSC ring over a shared buffer. VEC = 256 packets per frame."""

    def __init__(self, buf, n_slots: int = 64, create: bool = True):
        """``buf`` is any writable buffer (memoryview/bytearray/shm.buf)
        of at least required_size(n_slots) bytes."""
        self.lib = _load()
        self.vec = int(self.lib.fr_vec())
        self._mv = memoryview(buf)
        self._arr = np.frombuffer(self._mv, np.uint8)
        self._base = self._arr.ctypes.data_as(ctypes.c_void_p)
        if create:
            need = int(self.lib.fr_required_size(n_slots))
            if len(self._mv) < need:
                raise ValueError(f"buffer too small: {len(self._mv)} < {need}")
            self._arr[:need] = 0
            rc = self.lib.fr_create(self._base, need, n_slots)
            if rc != 0:
                raise RuntimeError(f"ring create failed: rc={rc}")
            self.n_slots = n_slots
        else:
            # validate against the CREATOR's slot count, not the caller's
            # guess — a short mapping would let the C side write past the
            # end of the buffer
            if len(self._mv) < int(self.lib.fr_header_size()):
                raise ValueError("buffer smaller than ring header")
            rc = self.lib.fr_attach(self._base)
            if rc != 0:
                raise RuntimeError(f"ring attach failed: rc={rc}")
            self.n_slots = int(self.lib.fr_n_slots(self._base))
            need = int(self.lib.fr_required_size(self.n_slots))
            if len(self._mv) < need:
                raise ValueError(
                    f"buffer covers {len(self._mv)} bytes but the ring "
                    f"was created with {self.n_slots} slots ({need} bytes)"
                )
        self._slot_hdr = int(self.lib.fr_slot_header_size())

    @classmethod
    def required_size(cls, n_slots: int) -> int:
        return int(_load().fr_required_size(n_slots))

    def _slot_views(self, off: int) -> Dict[str, np.ndarray]:
        cols: Dict[str, np.ndarray] = {}
        pos = off + self._slot_hdr
        for name, dtype in RING_COLUMNS:
            cols[name] = np.frombuffer(self._mv, dtype, count=self.vec, offset=pos)
            pos += self.vec * 4
        return cols

    # --- producer ---
    def reserve(self) -> int:
        """Reserve the next slot; returns its byte offset or -1 (full).
        Write via write_slot() then commit()."""
        return int(self.lib.fr_produce_reserve(self._base))

    def write_slot(self, off: int, columns: Dict[str, np.ndarray],
                   n_packets: int, epoch: int = 0) -> None:
        """Fill a reserved slot: header words + all columns (the single
        copy of the slot-write protocol; IORing reuses it)."""
        hdr = np.frombuffer(self._mv, np.uint32, count=2, offset=off)
        hdr[0] = n_packets
        hdr[1] = epoch
        for name, slot_col in self._slot_views(off).items():
            # IO-direction columns (disp/next_hop/meta) may be omitted by
            # rx-side producers; zero-fill so the consumer sees no stale
            # data from a previous lap of the ring.
            if name in columns:
                slot_col[:] = columns[name]
            else:
                slot_col[:] = 0

    def commit(self) -> None:
        self.lib.fr_produce_commit(self._base)

    def push(self, columns: Dict[str, np.ndarray], n_packets: int,
             epoch: int = 0) -> bool:
        """Write one frame; False if the ring is full. ``columns`` maps
        PacketVector field names to [VEC] arrays of the right dtype.
        Columns are written straight into the slot (one copy total)."""
        off = self.reserve()
        if off < 0:
            return False
        self.write_slot(off, columns, n_packets, epoch)
        self.commit()
        return True

    # --- consumer ---
    def peek_views(self) -> Optional[Tuple[Dict[str, np.ndarray], int, int]]:
        """Zero-copy views of the oldest frame: (columns, n_packets,
        epoch), or None if empty. Views are valid until release()."""
        off = self.lib.fr_consume_peek(self._base)
        if off < 0:
            return None
        hdr = np.frombuffer(self._mv, np.uint32, count=2, offset=off)
        return self._slot_views(off), int(hdr[0]), int(hdr[1])

    def pop(self) -> Optional[Tuple[Dict[str, np.ndarray], int, int]]:
        """Copy-out the oldest frame and release its slot."""
        off = self.lib.fr_consume_peek(self._base)
        if off < 0:
            return None
        flat = np.empty((len(RING_COLUMNS), self.vec), np.int32)
        n = ctypes.c_uint32()
        epoch = ctypes.c_uint32()
        self.lib.fr_read_frame(
            self._base, off, flat.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(n), ctypes.byref(epoch),
        )
        self.lib.fr_consume_release(self._base)
        # flat is a fresh local array; views of it are already safe to
        # hand out without a second copy
        cols = {
            name: flat[i].view(dtype)
            for i, (name, dtype) in enumerate(RING_COLUMNS)
        }
        return cols, int(n.value), int(epoch.value)

    def release(self) -> None:
        rc = self.lib.fr_consume_release(self._base)
        if rc != 0:
            raise RuntimeError("release() without a pending frame")

    def pending(self) -> int:
        return int(self.lib.fr_pending(self._base))

    def to_packet_vector(self, cols: Dict[str, np.ndarray], device=None):
        """Lift ring columns into a PacketVector of int32 tensors on
        ``device`` (None: the CPU) for the pipeline step; the uint32
        address columns keep their bits. The three IO-only columns
        (disp/next_hop/meta) are dropped."""
        import torch

        from vpp_tpu_torch.pipeline.vector import PacketVector

        return PacketVector(**{
            k: torch.from_numpy(np.ascontiguousarray(cols[k]).view(
                np.int32)).to(device) for k, _ in PV_COLUMNS})
