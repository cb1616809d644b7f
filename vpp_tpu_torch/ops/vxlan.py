"""VXLAN encap / decap on header vectors: the device half of the overlay.

The PyTorch counterpart of the device functions of
``vpp_tpu/ops/vxlan.py``. Headers are struct-of-arrays, so an encapped
packet is a pair of vectors (outer, inner): ``vxlan_encap`` builds the
outer IPv4/UDP header (RFC 7348 source-port entropy from the inner
5-tuple), ``vxlan_decap`` validates an outer header and its VNI, and
``vxlan_decap_step`` is the step's ip4-input half of the overlay
(pipeline/graph.py): an overlay-addressed frame whose VNI names a tenant
is re-admitted as its inner header in place, any other addressed frame
fails closed. The byte codec (``encode_frame`` / ``decode_frame``)
belongs to the IO daemon and comes with it (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

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
