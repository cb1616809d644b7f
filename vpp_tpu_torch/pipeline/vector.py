"""Packet vectors: fixed-size struct-of-arrays batches of packet headers.

The PyTorch counterpart of ``vpp_tpu/pipeline/vector.py``: ``VEC=256``
packets per frame, one int32 tensor per header field.

The uint32 representation (the ONE scheme of the whole package)
----------------------------------------------------------------
The reference computes addresses, packed ports, hashes and bitmaps in
``uint32``: wraparound multiplies, logical ``>>`` and unsigned ordering.
PyTorch's ``uint32`` lacks most arithmetic and ``>>`` on int32 is
arithmetic, so the port fixes one convention:

* **Storage.** Every uint32 field is an ``int32`` tensor holding the SAME
  bit pattern (``np.uint32`` arrays are viewed as ``np.int32`` on the
  way in, and back on the way out). The CUDA kernels therefore read the
  reference's bytes and compare them as ``uint32_t``.
* **Arithmetic.** Hashes widen to int64, mask with ``& 0xFFFFFFFF`` after
  every multiply (``u32`` below), and narrow back with ``to_i32``; a
  logical shift is a shift of the widened, non-negative value.
* **Ordering.** An unsigned compare or sorted search widens both sides
  with ``u32`` (int64, non-negative), or flips the sign bit of both
  sides (``bias``: the ``_lpm_bias`` trick — int32 order of the biased
  value equals uint32 order of the raw value).
* **Equality** needs nothing: equal bit patterns are equal int32s.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

# Native packet-frame size (packets per vector).
VEC = 256

FLAG_VALID = 1

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 31)


class Disposition(enum.IntEnum):
    """Where a packet goes after the pipeline — VPP's "next node" analog."""

    DROP = 0
    LOCAL = 1
    REMOTE = 2
    HOST = 3
    UNKNOWN = 4


class PacketVector(NamedTuple):
    """A frame of packet headers in SoA layout: int32 tensors of shape
    [P]; ``src_ip``/``dst_ip`` hold uint32 bit patterns (module doc).
    ``flags`` bit 0 = packet slot valid."""

    src_ip: torch.Tensor
    dst_ip: torch.Tensor
    proto: torch.Tensor
    sport: torch.Tensor
    dport: torch.Tensor
    ttl: torch.Tensor
    pkt_len: torch.Tensor
    rx_if: torch.Tensor
    flags: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return (self.flags & 1) == 1

    @property
    def five_tuple(self):
        """(src_ip, dst_ip, proto, sport, dport): the header columns the
        session and classify kernels take, in their order."""
        return self.src_ip, self.dst_ip, self.proto, self.sport, self.dport


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its uint32 value as int64 (non-negative)."""
    return x.to(torch.int64) & _M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value mod 2^32 -> int32 with the same low bits."""
    x = x & _M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def bias(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int32 whose signed order is the unsigned
    order of the pattern (flip the sign bit)."""
    return x ^ _SIGN


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index into an axis of ``n`` as JAX gathers it: a negative
    index wraps once, then the index clamps to [0, n). (PyTorch raises
    on an out-of-range index instead.)"""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def scatter_index(idx: torch.Tensor, mask: torch.Tensor, n: int):
    """(keep [P] bool, index [P] int64) of a masked scatter into an axis
    of ``n`` as JAX's ``mode="drop"`` scatters it: a negative index
    wraps once, whatever is still out of range is dropped."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    keep = mask & (idx >= 0) & (idx < n)
    return keep, torch.where(keep, idx, 0)


def as_i32(a) -> np.ndarray:
    """numpy uint32/int32 array -> int32 array with the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.astype(np.int32)


def ip4(addr: str) -> int:
    """Dotted-quad string -> uint32 host-order integer value."""
    a, b, c, d = (int(x) for x in addr.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def ip4_str(value: int) -> str:
    value = int(value) & _M32
    return f"{value >> 24}.{(value >> 16) & 255}.{(value >> 8) & 255}.{value & 255}"


def packet_vector_from_numpy(cols, device) -> PacketVector:
    """Build a PacketVector from nine numpy columns (field order, or a
    mapping by field name); uint32 columns keep their bits."""
    if isinstance(cols, dict):
        cols = [cols[f] for f in PacketVector._fields]
    return PacketVector(*(torch.from_numpy(np.array(as_i32(c), order="C"))
                          .to(device) for c in cols))


def make_packet_vector(packets: Optional[list] = None, n: int = VEC,
                       device="cpu") -> PacketVector:
    """Build a PacketVector from a list of dicts (host-side test/ingest
    path). Each dict may carry: src, dst (dotted strings or ints),
    proto, sport, dport, ttl, len, rx_if. Missing slots are zero-filled
    and marked invalid."""
    packets = packets or []
    assert len(packets) <= n, f"{len(packets)} packets > frame size {n}"

    def col(name, default, dtype=np.int32):
        out = np.full((n,), default, dtype=dtype)
        for i, p in enumerate(packets):
            v = p.get(name, default)
            if name in ("src", "dst") and isinstance(v, str):
                v = ip4(v)
            out[i] = v
        return out

    flags = np.zeros((n,), dtype=np.int32)
    flags[: len(packets)] = FLAG_VALID
    return packet_vector_from_numpy(
        [col("src", 0, np.uint32), col("dst", 0, np.uint32),
         col("proto", 6), col("sport", 0), col("dport", 0),
         col("ttl", 64), col("len", 64), col("rx_if", 0), flags],
        device)
