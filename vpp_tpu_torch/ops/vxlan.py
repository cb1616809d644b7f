"""VXLAN encap / decap on header vectors: the device half of the overlay.

The PyTorch counterpart of the device functions of
``vpp_tpu/ops/vxlan.py``. Headers are struct-of-arrays, so an encapped
packet is a pair of vectors (outer, inner): ``vxlan_encap`` builds the
outer IPv4/UDP header (RFC 7348 source-port entropy from the inner
5-tuple), ``vxlan_decap`` validates an outer header and its VNI, and
``vxlan_decap_step`` is the step's ip4-input half of the overlay
(pipeline/graph.py): an overlay-addressed frame whose VNI names a tenant
is re-admitted as its inner header in place, any other addressed frame
fails closed. The host byte codec (``encode_frame`` / ``decode_frame``,
RFC 7348 wire bytes) is the reference's, byte for byte.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import torch

from vpp_tpu_torch.ops.session import _mul32
from vpp_tpu_torch.pipeline.vector import (
    FLAG_VALID,
    PacketVector,
    to_i32,
    u32,
)

VXLAN_PORT = 4789
# the pod overlay's bridge domain in the reference deployment
DEFAULT_VNI = 10
# IPv4 (20) + UDP (8) + VXLAN (8) + the inner Ethernet header (14)
ENCAP_OVERHEAD = 50
OUTER_TTL = 254


class DecapResult(NamedTuple):
    inner: PacketVector   # inner headers, valid only where ok
    ok: torch.Tensor      # bool [P]: a well-formed VXLAN outer for vni


def _flow_entropy_sport(pkts: PacketVector) -> torch.Tensor:
    """RFC 7348 section 5.1 source port: a hash of the inner 5-tuple into
    the dynamic range, stable per flow (int32 [P])."""
    h = u32(pkts.src_ip) ^ _mul32(u32(pkts.dst_ip), 0x9E3779B1)
    h = h ^ (((u32(pkts.sport) << 16) & 0xFFFFFFFF) | u32(pkts.dport))
    h = _mul32(h, 0x85EBCA77) ^ u32(pkts.proto)
    h = h ^ (h >> 15)
    return (49152 + h % 16384).to(torch.int32)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor or an int as an int32 tensor on ``like``'s device
    (uint32 ints keep their bits)."""
    if torch.is_tensor(v):
        return v.to(torch.int32)
    return to_i32(torch.tensor(int(v) & 0xFFFFFFFF, dtype=torch.int64,
                               device=like.device))


def vxlan_encap(inner: PacketVector, encap_mask: torch.Tensor, local_vtep,
                remote_vtep: torch.Tensor) -> PacketVector:
    """The outer IPv4/UDP header vector of the packets of ``encap_mask``
    (``local_vtep`` a 0-d tensor or an int, ``remote_vtep`` [P] — the
    FIB's next hop). Lanes outside the mask come back with flags 0; the
    inner vector is untouched."""
    valid = inner.valid & encap_mask
    vtep = _scalar(local_vtep, inner.src_ip).expand(valid.shape)
    cols = torch.stack([
        vtep, remote_vtep.to(torch.int32),
        torch.full_like(inner.proto, 17), _flow_entropy_sport(inner),
        torch.full_like(inner.dport, VXLAN_PORT),
        torch.full_like(inner.ttl, OUTER_TTL),
        inner.pkt_len + ENCAP_OVERHEAD,
        torch.full_like(inner.flags, FLAG_VALID)])
    out = torch.where(valid, cols, 0).unbind(0)
    return PacketVector(*out[:7], rx_if=inner.rx_if, flags=out[7])


def vxlan_decap(outer: PacketVector, inner: PacketVector, vni: torch.Tensor,
                expected_vni: int = DEFAULT_VNI,
                local_vtep=None) -> DecapResult:
    """Validate the outer headers (UDP to the VXLAN port, the VNI, and
    with ``local_vtep`` the outer destination) and re-admit the inner
    packets where they pass; the inner keeps the outer's rx interface."""
    ok = (outer.valid & (outer.proto == 17) & (outer.dport == VXLAN_PORT)
          & (vni == expected_vni))
    if local_vtep is not None:
        ok = ok & (outer.dst_ip == _scalar(local_vtep, outer.dst_ip))
    flags = torch.where(ok & inner.valid, FLAG_VALID, 0).to(torch.int32)
    return DecapResult(inner._replace(rx_if=outer.rx_if, flags=flags), ok)


def vxlan_decap_step(tables, pkts: PacketVector, inner: PacketVector,
                     vni: torch.Tensor
                     ) -> Tuple[PacketVector, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The step's decap stage. ``pkts`` is the outer vector as received,
    ``inner`` / ``vni`` the inner-header sidecar the host parsed off the
    wire (``vni`` -1: no VXLAN framing). A frame is overlay-addressed
    when it is UDP to the VXLAN port at this node's VTEP
    (``tables.ovl_vtep_ip``; 0 admits any). An addressed frame whose VNI
    names a tenant (tenancy/derive.py ``vni_tenant``) and whose inner
    sidecar is valid is replaced by its inner header, keeping the
    outer's rx interface and flags; any other addressed frame fails
    closed. Returns ``(pkts', bad [P], decapped [P], tid [P])``: ``tid``
    is the VNI's tenant where decapped, 0 elsewhere."""
    from vpp_tpu_torch.tenancy.derive import vni_tenant

    vtep = tables.ovl_vtep_ip
    addressed = (pkts.valid & (pkts.proto == 17)
                 & (pkts.dport == VXLAN_PORT)
                 & ((pkts.dst_ip == vtep) | (vtep == 0)))
    tid, known = vni_tenant(tables, vni)
    ok = addressed & known & inner.valid
    bad = addressed & ~ok

    def pick(i, o):
        return torch.where(ok, i, o).to(torch.int32)

    out = PacketVector(
        src_ip=pick(inner.src_ip, pkts.src_ip),
        dst_ip=pick(inner.dst_ip, pkts.dst_ip),
        proto=pick(inner.proto, pkts.proto),
        sport=pick(inner.sport, pkts.sport),
        dport=pick(inner.dport, pkts.dport),
        ttl=pick(inner.ttl, pkts.ttl),
        pkt_len=pick(inner.pkt_len, pkts.pkt_len),
        rx_if=pkts.rx_if,
        flags=pkts.flags)
    return out, bad, ok, torch.where(ok, tid, 0).to(torch.int32)


# --- byte-level wire codec (host side, for the NIC/native-ring edge) ---
# RFC 7348 framing: outer IPv4 | outer UDP | VXLAN | inner Ethernet |
# inner IPv4 | inner L4. The inner Ethernet header is mandatory on the
# wire (VXLAN tunnels L2 frames); we synthesize locally-administered
# MACs derived from the inner IPs unless the caller provides real ones.

_IP_HDR = struct.Struct("!BBHHHBBHII")   # version/ihl, tos, len, id, frag, ttl, proto, csum, src, dst
_UDP_HDR = struct.Struct("!HHHH")
_VXLAN_HDR = struct.Struct("!II")        # flags(8)|rsvd(24), vni(24)|rsvd(8)
_ETH_HDR = struct.Struct("!6s6sH")       # dst mac, src mac, ethertype
_ETH_IPV4 = 0x0800


def _synth_mac(ip: int) -> bytes:
    """Locally-administered MAC from an IPv4 address (0x02 | ip bytes),
    the same trick the reference uses for pod-side MACs."""
    return bytes([0x02, 0x00]) + struct.pack("!I", ip & 0xFFFFFFFF)


def _ip_checksum(hdr: bytes) -> int:
    s = 0
    for i in range(0, len(hdr), 2):
        s += (hdr[i] << 8) | hdr[i + 1]
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def _ip4_bytes(src: int, dst: int, proto: int, ttl: int, payload_len: int) -> bytes:
    hdr = _IP_HDR.pack(
        0x45, 0, 20 + payload_len, 0, 0, ttl, proto, 0, src & 0xFFFFFFFF, dst & 0xFFFFFFFF
    )
    csum = _ip_checksum(hdr)
    return hdr[:10] + struct.pack("!H", csum) + hdr[12:]


def encode_frame(outer: dict, inner: dict, vni: int = DEFAULT_VNI,
                 inner_payload: bytes = b"",
                 inner_src_mac: bytes = None,
                 inner_dst_mac: bytes = None) -> bytes:
    """Serialize one encapped packet to RFC 7348 wire bytes:
    outer IPv4 | UDP | VXLAN | inner Ethernet | inner IPv4 | inner L4."""
    inner_l4 = _UDP_HDR.pack(
        inner.get("sport", 0), inner.get("dport", 0), 8 + len(inner_payload), 0
    )
    inner_ip = _ip4_bytes(
        inner["src"], inner["dst"], inner.get("proto", 17),
        inner.get("ttl", 64), len(inner_l4) + len(inner_payload),
    )
    eth = _ETH_HDR.pack(
        inner_dst_mac or _synth_mac(inner["dst"]),
        inner_src_mac or _synth_mac(inner["src"]),
        _ETH_IPV4,
    )
    vxlan = _VXLAN_HDR.pack(0x08 << 24, (vni & 0xFFFFFF) << 8)
    inner_bytes = eth + inner_ip + inner_l4 + inner_payload
    udp_len = 8 + len(vxlan) + len(inner_bytes)
    udp = _UDP_HDR.pack(outer.get("sport", 49152), VXLAN_PORT, udp_len, 0)
    outer_ip = _ip4_bytes(
        outer["src"], outer["dst"], 17, outer.get("ttl", OUTER_TTL), udp_len
    )
    return outer_ip + udp + vxlan + inner_bytes


# fixed offsets given options-free outer IPv4 (we validate IHL==5)
_OFF_UDP = 20
_OFF_VXLAN = 28
_OFF_ETH = 36
_OFF_INNER_IP = 50
_OFF_INNER_L4 = 70
_MIN_LEN = 78


def decode_frame(wire: bytes) -> Tuple[dict, dict, int, bytes]:
    """Parse RFC 7348 wire bytes back into (outer, inner, vni, payload).

    Raises ValueError on anything that is not a well-formed VXLAN-in-
    IPv4/UDP frame — the same checks the on-device decap kernel applies
    (proto 17, dst port 4789, I-flag) plus wire-only ones (version/IHL,
    length, inner ethertype).
    """
    if len(wire) < _MIN_LEN:
        raise ValueError(f"frame too short for VXLAN: {len(wire)} bytes")
    o = _IP_HDR.unpack_from(wire, 0)
    if o[0] != 0x45:
        raise ValueError(f"outer not options-free IPv4 (ver/ihl 0x{o[0]:02x})")
    outer = {"src": o[8], "dst": o[9], "proto": o[6], "ttl": o[5]}
    if outer["proto"] != 17:
        raise ValueError(f"outer proto {outer['proto']} is not UDP")
    sport, dport, _ulen, _ = _UDP_HDR.unpack_from(wire, _OFF_UDP)
    outer["sport"], outer["dport"] = sport, dport
    if dport != VXLAN_PORT:
        raise ValueError(f"not VXLAN: UDP dport {dport}")
    vflags, vvni = _VXLAN_HDR.unpack_from(wire, _OFF_VXLAN)
    if not (vflags >> 24) & 0x08:
        raise ValueError("VXLAN I-flag not set")
    vni = (vvni >> 8) & 0xFFFFFF
    dst_mac, src_mac, ethertype = _ETH_HDR.unpack_from(wire, _OFF_ETH)
    if ethertype != _ETH_IPV4:
        raise ValueError(f"inner ethertype 0x{ethertype:04x} not IPv4")
    i = _IP_HDR.unpack_from(wire, _OFF_INNER_IP)
    if i[0] != 0x45:
        raise ValueError(f"inner not options-free IPv4 (ver/ihl 0x{i[0]:02x})")
    inner = {"src": i[8], "dst": i[9], "proto": i[6], "ttl": i[5], "len": i[2],
             "src_mac": src_mac, "dst_mac": dst_mac}
    isport, idport, _, _ = _UDP_HDR.unpack_from(wire, _OFF_INNER_L4)
    inner["sport"], inner["dport"] = isport, idport
    return outer, inner, vni, wire[_MIN_LEN:]
