"""NAT44: service DNAT with weighted backend pick, SNAT, reverse path.

The PyTorch counterpart of ``vpp_tpu/ops/nat44.py``: mappings match
densely ([P] x [M]); the backend is a consistent weighted pick keyed on
the flow hash; the NAT session table (the W-way set-associative map of
ops/session.py) records each translated flow under the key its reply
will present, so replies are un-NATed. The service-VIP planes
(``svc_*``, TableBuilder ``set_service``) are consulted beside the
mappings: an exact (ip, port, proto) row picks backend way ``flow hash
& (B - 1)``. With tenancy on (``tnt=True``) a NAT key's bucket lies in
its tenant's slice (``tnt_nat_base`` / ``tnt_nat_mask``). The mesh form
(``shard``) is the bucket-sharded table of ops/session.py's module doc:
the record elects per shard, and the reverse reads the owning shard's
row, so every shard leaves with the identical packet vector.
Session-table writes are in place (ops/session.py module doc).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from vpp_tpu_torch.ops.acl import first_true
from vpp_tpu_torch.ops.session import (
    _age,
    _bucket,
    _hash_mix,
    _mul32,
    _insert_sharded,
    _owned_idx,
    _pack_ports,
    _scatter_set,
    _slice_bucket,
    hashmap_insert,
    tenant_bucket,
)
from vpp_tpu_torch.pipeline.vector import PacketVector, u32


def _flow_hash(pkts: PacketVector) -> torch.Tensor:
    """32-bit flow hash for backend selection (uint32 value as int64)."""
    h = _mul32(u32(pkts.src_ip), 0x01000193)
    h ^= _mul32(u32(pkts.dst_ip), 0x9E3779B1)
    h ^= _mul32(u32(_pack_ports(pkts.sport, pkts.dport)), 0x85EBCA77)
    h ^= u32(pkts.proto)
    h ^= h >> 16
    h = _mul32(h, 0x7FEB352D)
    h ^= h >> 15
    return h


def _dnat_lookup(tables, pkts: PacketVector):
    """(matched [P], m_idx [P]): mapping match on (dst_ip, dport,
    proto); an exact-port mapping beats a port-0 wildcard."""
    exact = tables.nat_ext_port[None, :] == pkts.dport[:, None]
    wildcard = tables.nat_ext_port[None, :] == 0
    hit = ((tables.nat_ext_ip[None, :] == pkts.dst_ip[:, None])
           & (exact | wildcard)
           & (tables.nat_proto[None, :] == pkts.proto[:, None])
           & (tables.nat_bcnt[None, :] > 0))
    score = torch.where(hit, torch.where(exact, 2, 1), 0)
    m_idx = torch.argmax(score, dim=1)
    matched = torch.gather(score, 1, m_idx[:, None])[:, 0] > 0
    return matched, m_idx


def _svc_lookup(tables, pkts: PacketVector):
    """(matched [P], v_idx [P]): exact (dst_ip, dport, proto) match on
    the service-VIP rows; rows with ``svc_bk_n == 0`` never match."""
    hit = ((tables.svc_vip_ip[None, :] == pkts.dst_ip[:, None])
           & (tables.svc_vip_port[None, :] == pkts.dport[:, None])
           & (tables.svc_vip_proto[None, :] == pkts.proto[:, None])
           & (tables.svc_bk_n[None, :] > 0))
    return hit.any(dim=1), first_true(hit)


def nat44_dnat_match(tables, pkts: PacketVector,
                     eligible: torch.Tensor) -> torch.Tensor:
    """Would ``nat44_dnat`` translate any of these packets? The
    match-only probe (no rewrite, no backend pick) of the two-tier
    dispatch predicate: the dense mappings OR the service-VIP rows."""
    matched, _ = _dnat_lookup(tables, pkts)
    svc_matched, _ = _svc_lookup(tables, pkts)
    return (matched | svc_matched) & eligible


def nat44_dnat(tables, pkts: PacketVector, eligible: torch.Tensor
               ) -> Tuple[PacketVector, torch.Tensor, torch.Tensor]:
    """Translate service VIP traffic to a weighted-chosen backend.
    Returns (rewritten packets, applied mask, self_snat mask)."""
    n_b = tables.natb_ip.shape[0]
    raw_matched, m_idx = _dnat_lookup(tables, pkts)
    matched = raw_matched & eligible
    fh = _flow_hash(pkts)
    total_w = torch.clamp(tables.nat_total_w[m_idx], min=1)
    w = (fh % total_w).to(torch.int32)
    boff = tables.nat_boff[m_idx]
    bcnt = tables.nat_bcnt[m_idx]
    b_range = torch.arange(n_b, dtype=torch.int32,
                           device=pkts.dst_ip.device)[None, :]
    cand = ((b_range >= boff[:, None])
            & (b_range < (boff + bcnt)[:, None])
            & (tables.natb_cumw[None, :] > w[:, None]))
    b_idx = first_true(cand)
    new_dst = torch.where(matched, tables.natb_ip[b_idx], pkts.dst_ip)
    new_dport = torch.where(matched, tables.natb_port[b_idx], pkts.dport)
    self_snat = matched & (tables.nat_self_snat[m_idx] == 1)

    svc_raw, v_idx = _svc_lookup(tables, pkts)
    svc_matched = svc_raw & eligible
    ways = tables.svc_bk_ip.shape[1]
    way = (fh & (ways - 1)).long()
    new_dst = torch.where(svc_matched, tables.svc_bk_ip[v_idx, way],
                          new_dst)
    new_dport = torch.where(svc_matched, tables.svc_bk_port[v_idx, way],
                            new_dport)
    self_snat = torch.where(svc_matched, tables.svc_vip_snat[v_idx] == 1,
                            self_snat)
    out = pkts._replace(dst_ip=new_dst, dport=new_dport)
    return out, matched | svc_matched, self_snat


def nat44_snat(tables, pkts: PacketVector, want: torch.Tensor
               ) -> Tuple[PacketVector, torch.Tensor]:
    """Source-NAT cluster-egress flows to the node's SNAT address; the
    port is derived from the flow hash (1024 + h % 64512) for TCP/UDP,
    ICMP keeps its id."""
    applied = want & (tables.nat_snat_ip != 0)
    sport = (1024 + _flow_hash(pkts) % 64512).to(torch.int32)
    rewrite_port = applied & ((pkts.proto == 6) | (pkts.proto == 17))
    out = pkts._replace(
        src_ip=torch.where(applied, tables.nat_snat_ip, pkts.src_ip),
        sport=torch.where(rewrite_port, sport, pkts.sport),
    )
    return out, applied


def _nat_bucket(tables, key_vals, tnt: bool, kt=None) -> torch.Tensor:
    """The NAT-session bucket of a key: its tenant's slice with ``tnt``
    (``kt``, where given, the key's tenant), else the whole table."""
    mix = _hash_mix(*key_vals)
    if not tnt:
        return _bucket(mix, tables.natsess_valid.shape[0])
    if kt is None:
        return tenant_bucket(tables, key_vals[0], key_vals[1], mix,
                             tables.tnt_nat_base, tables.tnt_nat_mask)
    return _slice_bucket(mix, kt, tables.tnt_nat_base, tables.tnt_nat_mask)


def nat44_record(tables, pkts: PacketVector, orig_dst, orig_dport,
                 orig_src, orig_sport, kind, want, now, shard=None,
                 tnt: bool = False):
    """Record NAT sessions (in place) for translated-and-forwarded
    flows, keyed as the reply will present them. Returns (tables,
    conflict, failed, evict_expired, evict_victim). With ``tnt`` the
    reply key lands in its tenant's NAT slice, the one the reply's
    ``nat44_reverse`` hashes (the same unordered address pair). With
    ``shard`` each shard elects the keys whose bucket it owns."""
    key_vals = (pkts.dst_ip, pkts.src_ip,
                _pack_ports(pkts.dport, pkts.sport), pkts.proto)
    h = _nat_bucket(tables, key_vals, tnt)
    insert = (hashmap_insert if shard is None
              else functools.partial(_insert_sharded, shard=shard))
    _, conflict, failed, ev_exp, ev_vic = insert(
        tables.natsess_valid, tables.natsess_time,
        (tables.natsess_a, tables.natsess_b, tables.natsess_ports,
         tables.natsess_proto),
        key_vals,
        (tables.natsess_orig_ip, tables.natsess_orig_port,
         tables.natsess_src_ip, tables.natsess_sport, tables.natsess_kind),
        (orig_dst, orig_dport, orig_src, orig_sport, kind),
        h, want, now, max_age=tables.sess_max_age)
    return tables, conflict, failed, ev_exp, ev_vic


def nat44_reverse(tables, pkts: PacketVector, eligible, now=None,
                  shard=None, tnt: bool = False, kt=None):
    """Untranslate NAT'd return traffic. Returns (pkts, applied,
    hit_idx) with ``hit_idx`` the matched flat slot (bucket·W + way).
    ``kt``: the tenant of the packets' address pairs, where the caller
    has it (with ``tnt``). With ``shard`` the reads are the owning
    shard's and ``hit_idx`` is 0 on a miss, as the reference's psum of
    owner-masked values gives."""
    n_buckets, ways = tables.natsess_valid.shape
    key_vals = (pkts.src_ip, pkts.dst_ip,
                _pack_ports(pkts.sport, pkts.dport), pkts.proto)
    b = _nat_bucket(tables, key_vals, tnt, kt)
    bl = b.long()
    slot_ok = tables.natsess_valid[bl] == 1
    if now is not None:
        slot_ok = slot_ok & (_age(now, tables.natsess_time[bl])
                             <= tables.sess_max_age)
    for arr, val in zip((tables.natsess_a, tables.natsess_b,
                         tables.natsess_ports, tables.natsess_proto),
                        key_vals):
        slot_ok = slot_ok & (arr[bl] == val[:, None])
    found = slot_ok.any(dim=1)
    first = first_true(slot_ok)
    hit_idx = b * ways + first.to(torch.int32)
    if shard is not None:
        hit_idx = _owned_idx(found, hit_idx)
    applied = found & eligible
    kind = torch.where(applied, tables.natsess_kind[bl, first], 0)
    orig_ip = tables.natsess_orig_ip[bl, first]
    orig_port = tables.natsess_orig_port[bl, first]
    src_ip = tables.natsess_src_ip[bl, first]
    sport = tables.natsess_sport[bl, first]
    undo_dnat = (kind & 1) != 0
    undo_snat = (kind & 2) != 0
    out = pkts._replace(
        src_ip=torch.where(undo_dnat, orig_ip, pkts.src_ip),
        sport=torch.where(undo_dnat, orig_port, pkts.sport),
        dst_ip=torch.where(undo_snat, src_ip, pkts.dst_ip),
        dport=torch.where(undo_snat, sport, pkts.dport),
    )
    return out, applied, hit_idx


def nat44_touch(tables, hit_idx, mask, now, shard=None):
    """Refresh natsess_time of sessions hit by reply traffic (in
    place; with ``shard`` into the owning shard's block)."""
    _scatter_set(tables.natsess_time.view(-1), hit_idx, mask, now)
    return tables
