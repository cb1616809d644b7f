"""Host-side ICMP error generation (time-exceeded / unreachable).

The port's copy of ``vpp_tpu/io/icmp.py``. Reference analog: VPP's
ip4 error path — `error-drop` is only one branch of the graph;
TTL-expired packets branch to ip4-icmp-error and emit ICMP
time-exceeded, FIB misses emit net-unreachable (the upstream project's
docs/VPP_PACKET_TRACING_K8S.md:28-50 shows the chain; pod `traceroute`
depends on the time-exceeded hop). The device
pipeline attributes every drop (graph.py DROP_*, carried across the
packed boundary); this module turns the attributed drops into ICMP
error frames on the tx ring — an error path belongs on the host CPU,
not in the packet-rate device program.

RFC 792 format: IP header (src = this vswitch's gateway address) +
8-byte ICMP header + the invoking packet's IP header + first 8 L4
bytes. Token-bucket rate-limited like VPP's ICMP error throttling.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

ICMP_TIME_EXCEEDED = 11   # code 0: TTL expired in transit
ICMP_UNREACHABLE = 3      # code 0: net unreachable
ETH_HDR = 14
_IP_HDR = 20
_ICMP_HDR = 8


def _checksum(data: np.ndarray) -> int:
    """RFC 1071 internet checksum of a uint8 array (even length pads)."""
    if data.size % 2:
        data = np.concatenate([data, np.zeros(1, np.uint8)])
    words = data.reshape(-1, 2).astype(np.uint32)
    s = int((words[:, 0] * 256 + words[:, 1]).sum())
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def build_icmp_error(
    icmp_type: int,
    src_ip: int,
    orig_frame: np.ndarray,
    orig_len: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, int]]:
    """One ICMP error frame quoting ``orig_frame`` (the invoking packet
    as received, Ethernet included). ``orig_len`` is the invoking
    packet's L3 length — the quote must never read past it: payload
    rows are ring slots copied only up to each frame's wire length, so
    bytes beyond the packet are leftovers from a previous ring lap
    (another flow's data — quoting them would leak it to the sender).
    Returns (frame bytes with MAC-less Ethernet header, pkt_len) or
    None when the original is not a quotable IPv4 packet. pkt_len is
    the L3 length (wire = +14)."""
    if orig_frame.shape[0] < ETH_HDR + _IP_HDR:
        return None
    oip = orig_frame[ETH_HDR:]
    if (int(oip[0]) >> 4) != 4:
        return None
    oihl = (int(oip[0]) & 0xF) * 4
    avail = oip.shape[0]
    if orig_len is not None:
        avail = min(avail, max(int(orig_len), 0))
    # RFC 792/1122: never generate an ICMP error about an ICMP error
    # (types 3/4/5/11/12) — an undeliverable error must die silently,
    # not ping-pong more errors through the data plane. The type byte
    # is read only within the packet's REAL length (bytes past
    # orig_len are another flow's residue from a previous ring lap);
    # an ICMP packet whose type byte is unreadable is conservatively
    # not quoted at all.
    if int(oip[9]) == 1:
        if oihl >= avail:
            return None
        if int(oip[oihl]) in (3, 4, 5, 11, 12):
            return None
    quote = min(oihl + 8, avail)
    if quote < _IP_HDR:
        return None
    orig_src = int.from_bytes(bytes(oip[12:16]), "big")
    total = _IP_HDR + _ICMP_HDR + quote

    frame = np.zeros(ETH_HDR + total, np.uint8)
    # MACs are filled by the tx dispatch (neighbor table + egress
    # interface); the EtherType is ours to set — a zero type field
    # would be silently ignored by the receiving kernel
    frame[12] = 0x08
    frame[13] = 0x00
    ip = frame[ETH_HDR:]
    ip[0] = 0x45
    ip[2:4] = np.frombuffer(total.to_bytes(2, "big"), np.uint8)
    ip[8] = 64                      # ttl
    ip[9] = 1                       # proto ICMP
    ip[12:16] = np.frombuffer(int(src_ip).to_bytes(4, "big"), np.uint8)
    ip[16:20] = np.frombuffer(orig_src.to_bytes(4, "big"), np.uint8)
    ck = _checksum(ip[:_IP_HDR])
    ip[10:12] = np.frombuffer(ck.to_bytes(2, "big"), np.uint8)

    icmp = ip[_IP_HDR:]
    icmp[0] = icmp_type             # code stays 0 for both types
    icmp[_ICMP_HDR:_ICMP_HDR + quote] = oip[:quote]
    ck = _checksum(icmp[: _ICMP_HDR + quote])
    icmp[2:4] = np.frombuffer(ck.to_bytes(2, "big"), np.uint8)
    return frame, total


def classify_drops(causes: np.ndarray, flags: np.ndarray,
                   ttl: np.ndarray, n: int):
    """Which attributed drops deserve an ICMP error, and which type:
    (idxs, types) over positions [0, n). DROP_IP4 covers TTL/len/bad-if
    — only a TTL of <= 1 at ingress is a time-exceeded; FIB misses are
    net-unreachable; every other cause (policy, fib-drop, NAT) stays
    silent. Shared by the single-node and cluster pumps so the
    cause→error mapping can never diverge between them."""
    from vpp_tpu_torch.pipeline.graph import DROP_IP4, DROP_NO_ROUTE

    c = causes[:n]
    valid = (np.asarray(flags[:n]).view(np.int32) & 1) != 0
    t = np.asarray(ttl[:n]).view(np.int32)
    ttl_exp = (c == DROP_IP4) & (t <= 1) & valid
    no_rt = (c == DROP_NO_ROUTE) & valid
    idxs = np.nonzero(ttl_exp | no_rt)[0]
    types = np.where(ttl_exp[idxs], ICMP_TIME_EXCEEDED, ICMP_UNREACHABLE)
    return idxs, types


class IcmpErrorGen:
    """Builds rate-limited ICMP error *frames* (ring columns + payload
    rows) for a batch of attributed drops."""

    def __init__(self, src_ip: int, vec: int, snap: int,
                 rate_per_s: float = 256.0):
        self.src_ip = int(src_ip)
        self.vec = vec
        self.snap = snap
        self.rate = float(rate_per_s)
        self._tokens = self.rate
        self._t_last = time.monotonic()
        self.emitted = 0
        self.suppressed = 0

    def _take(self, want: int) -> int:
        now = time.monotonic()
        self._tokens = min(
            self.rate, self._tokens + (now - self._t_last) * self.rate
        )
        self._t_last = now
        grant = min(want, int(self._tokens))
        self._tokens -= grant
        self.suppressed += want - grant
        return grant

    def build_frame(
        self, idxs: np.ndarray, types: np.ndarray, cols: Dict[str, np.ndarray],
        payload: np.ndarray, scratch: np.ndarray,
        rx_if: Optional[int] = None,
    ) -> Optional[Tuple[Dict[str, np.ndarray], int]]:
        """ICMP error frame for dropped packets ``idxs`` (positions in
        the ORIGINAL rx frame): ``cols``/``payload`` are that frame's
        ring columns + payload rows; ``scratch`` is a [VEC, snap] uint8
        payload buffer for the new frame. ``rx_if`` is the interface
        the error packets claim as INGRESS — self-originated traffic
        enters via the node's host interface and the caller routes it
        through the pipeline like any packet (VPP: ip4-icmp-error
        feeds ip4-lookup). Returns (ring columns, n) or None when rate
        limiting suppressed everything."""
        grant = self._take(len(idxs))
        if not grant:
            return None
        out = {
            name: np.zeros(self.vec, arr.dtype) for name, arr in cols.items()
        }
        n = 0
        for k, i in enumerate(idxs[:grant]):
            built = build_icmp_error(
                int(types[k]), self.src_ip, payload[i],
                orig_len=int(cols["pkt_len"][i]),
            )
            if built is None:
                continue
            frame, pkt_len = built
            scratch[n, : frame.shape[0]] = frame
            scratch[n, frame.shape[0]:] = 0
            out["src_ip"][n] = np.uint32(self.src_ip)
            out["dst_ip"][n] = cols["src_ip"][i]  # back to the sender
            out["proto"][n] = 1
            out["ttl"][n] = 64
            out["pkt_len"][n] = pkt_len
            out["rx_if"][n] = (
                rx_if if rx_if is not None else cols["rx_if"][i]
            )
            out["flags"][n] = 1  # FLAG_VALID
            out["meta"][n] = -1
            n += 1
        if not n:
            return None
        self.emitted += n
        return out, n
