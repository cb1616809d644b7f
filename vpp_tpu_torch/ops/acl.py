"""ACL classify: ordered 5-tuple first-match over rule tables.

The PyTorch counterpart of ``vpp_tpu/ops/acl.py``: the dense [P, R]
compare (the classifier ladder's ``dense`` rung) and the verdict
assembly the BV rungs reuse, so deny / permit / unmatched-default stay
in lockstep across rungs. Unmatched traffic: an empty table allows all;
a non-empty table denies unmatched TCP/UDP and permits other protocols.

On the mesh (vpp_tpu_torch/parallel/cluster.py) each rule shard
first-matches its block of rows and encodes the verdict as
``abs_idx << 1 | deny`` (``acl_encode_shard``), so a min over the
shards' encodings is the cluster-wide first match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpp_tpu_torch.pipeline.vector import PacketVector, gather_index


# Encoded "no rule matched" of a shard verdict: above every
# ``abs_idx << 1 | deny`` (rule indices stay below 2**30).
ENC_NO_MATCH = 0x7FFFFFFF


class AclVerdict(NamedTuple):
    permit: torch.Tensor     # bool [P]
    rule_idx: torch.Tensor   # int32 [P], matched rule index (-1 = none)


def first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none): the
    ``jnp.argmax`` of a bool mask. torch.argmax returns the FIRST
    maximum, as JAX does."""
    return torch.argmax(m.to(torch.int8), dim=-1)


def _match_mask(pkts: PacketVector, src_net, src_mask, dst_net, dst_mask,
                proto, sport_lo, sport_hi, dport_lo,
                dport_hi) -> torch.Tensor:
    """Dense [P, R] rule-match mask; rule arrays [P, R] or [R]."""
    src = pkts.src_ip[:, None]
    dst = pkts.dst_ip[:, None]
    m = (src & src_mask) == src_net
    m &= (dst & dst_mask) == dst_net
    m &= (proto == -1) | (proto == pkts.proto[:, None])
    m &= (pkts.sport[:, None] >= sport_lo) & (pkts.sport[:, None] <= sport_hi)
    m &= (pkts.dport[:, None] >= dport_lo) & (pkts.dport[:, None] <= dport_hi)
    return m


def acl_unmatched_default(pkts: PacketVector, nrules) -> torch.Tensor:
    """Default verdict for unmatched traffic (module doc)."""
    empty = nrules == 0
    non_l4 = (pkts.proto != 6) & (pkts.proto != 17)
    return empty | non_l4


def acl_encode_shard(pkts: PacketVector, src_net, src_mask, dst_net,
                     dst_mask, proto, sport_lo, sport_hi, dport_lo,
                     dport_hi, action, base_idx: int) -> torch.Tensor:
    """First match over one rule shard, encoded for the min recombine:
    ``(base_idx + first) << 1 | deny`` where the shard's rows (starting
    at absolute index ``base_idx``) match, ``ENC_NO_MATCH`` elsewhere
    (int32 [P])."""
    m = _match_mask(pkts, src_net, src_mask, dst_net, dst_mask, proto,
                    sport_lo, sport_hi, dport_lo, dport_hi)
    first = first_true(m)
    matched = torch.gather(m, 1, first[:, None])[:, 0]
    act = torch.gather(action.expand(m.shape), 1, first[:, None])[:, 0]
    enc = ((first + int(base_idx)) << 1) | (act != 1).to(torch.int64)
    return torch.where(matched, enc, ENC_NO_MATCH).to(torch.int32)


def _first_match(pkts: PacketVector, src_net, src_mask, dst_net, dst_mask,
                 proto, sport_lo, sport_hi, dport_lo, dport_hi, action,
                 nrules) -> AclVerdict:
    m = _match_mask(pkts, src_net, src_mask, dst_net, dst_mask, proto,
                    sport_lo, sport_hi, dport_lo, dport_hi)
    first = first_true(m)
    matched = torch.gather(m, 1, first[:, None])[:, 0]
    act = torch.gather(action.expand(m.shape), 1, first[:, None])[:, 0]
    permit = torch.where(matched, act == 1,
                         acl_unmatched_default(pkts, nrules))
    return AclVerdict(permit=permit,
                      rule_idx=torch.where(matched, first, -1)
                      .to(torch.int32))


def acl_classify_local(tables, pkts: PacketVector) -> AclVerdict:
    """Classify each packet against the local table of its rx interface;
    interfaces with no table (-1) permit."""
    tid = tables.if_local_table[
        gather_index(pkts.rx_if, tables.if_local_table.shape[0])]
    has_table = tid >= 0
    t = torch.clamp(tid, min=0).long()
    v = _first_match(
        pkts,
        tables.acl_src_net[t], tables.acl_src_mask[t],
        tables.acl_dst_net[t], tables.acl_dst_mask[t],
        tables.acl_proto[t],
        tables.acl_sport_lo[t], tables.acl_sport_hi[t],
        tables.acl_dport_lo[t], tables.acl_dport_hi[t],
        tables.acl_action[t], tables.acl_nrules[t],
    )
    return AclVerdict(permit=torch.where(has_table, v.permit, True),
                      rule_idx=torch.where(has_table, v.rule_idx, -1)
                      .to(torch.int32))


def acl_local_none(tables, pkts: PacketVector) -> AclVerdict:
    """The local stage of a policy-free node (every if_local_table is
    -1): a constant permit, bit-exact with acl_classify_local there."""
    n = pkts.src_ip.shape[0]
    dev = pkts.src_ip.device
    return AclVerdict(permit=torch.ones(n, dtype=torch.bool, device=dev),
                      rule_idx=torch.full((n,), -1, dtype=torch.int32,
                                          device=dev))


def assemble_global_verdict(tables, pkts: PacketVector,
                            matched: torch.Tensor,
                            permit_if_matched: torch.Tensor,
                            rule_idx: torch.Tensor) -> AclVerdict:
    """Fold a raw global-table match into the final verdict: unmatched
    traffic takes the default, and the table applies only on
    interfaces marked ``if_apply_global``."""
    permit = torch.where(matched, permit_if_matched,
                         acl_unmatched_default(pkts, tables.glb_nrules))
    applies = tables.if_apply_global[
        gather_index(pkts.rx_if, tables.if_apply_global.shape[0])] == 1
    return AclVerdict(permit=torch.where(applies, permit, True),
                      rule_idx=torch.where(applies & matched, rule_idx, -1)
                      .to(torch.int32))


def acl_classify_global(tables, pkts: PacketVector) -> AclVerdict:
    """Classify each packet against the node-global table (dense)."""
    v = _first_match(
        pkts, tables.glb_src_net, tables.glb_src_mask,
        tables.glb_dst_net, tables.glb_dst_mask, tables.glb_proto,
        tables.glb_sport_lo, tables.glb_sport_hi,
        tables.glb_dport_lo, tables.glb_dport_hi,
        tables.glb_action, tables.glb_nrules,
    )
    matched = v.rule_idx >= 0
    return assemble_global_verdict(tables, pkts, matched, v.permit,
                                   v.rule_idx)
