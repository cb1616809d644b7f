"""ip4-lookup: longest-prefix match over the FIB.

The PyTorch counterpart of ``vpp_tpu/ops/fib.py``: the dense [P, F]
masked-compare rung and the ONE shared slot resolver (unicast columns
or an ECMP member picked by the session flow hash) that the dense and
LPM rungs both end in, so route semantics cannot diverge between them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpp_tpu_torch.ops.session import _hash_mix, _pack_ports
from vpp_tpu_torch.pipeline.vector import Disposition, PacketVector


class FibResult(NamedTuple):
    matched: torch.Tensor   # bool [P] — a route exists
    tx_if: torch.Tensor     # int32 [P]
    disp: torch.Tensor      # int32 [P] Disposition (DROP when unmatched)
    next_hop: torch.Tensor  # int32 [P] (uint32 bits)
    node_id: torch.Tensor   # int32 [P] remote node index, -1 local
    snat: torch.Tensor      # bool [P] route is marked for source-NAT
    grp: torch.Tensor       # int32 [P] ECMP group, -1 = unicast
    way: torch.Tensor       # int32 [P] member way (0 when grp == -1)


def fib_flow_mix(pkts: PacketVector) -> torch.Tensor:
    """The ECMP member-selection hash [P]: the session 5-tuple mix
    (uint32 value as int64)."""
    return _hash_mix(pkts.src_ip, pkts.dst_ip,
                     _pack_ports(pkts.sport, pkts.dport), pkts.proto)


def resolve_fib_slot(tables, slot: torch.Tensor, matched: torch.Tensor,
                     mix: torch.Tensor) -> FibResult:
    """Resolve matched FIB slots [P] to forwarding data. ECMP slots
    (``fib_grp >= 0``) read member ``mix & (W-1)`` of their group; an
    empty group fails closed as a miss."""
    safe = torch.where(matched, slot, 0).long()
    tx_if = tables.fib_tx_if[safe]
    disp = tables.fib_disp[safe]
    next_hop = tables.fib_next_hop[safe]
    node_id = tables.fib_node_id[safe]
    snat = tables.fib_snat[safe]
    g = tables.fib_grp[safe]
    n_grp, ways = tables.fib_grp_nh.shape
    way = (mix & (ways - 1)).to(torch.int32)
    gs = torch.clamp(g, 0, n_grp - 1).long()
    wl = way.long()
    is_grp = matched & (g >= 0)
    live = is_grp & (tables.fib_grp_n[gs] > 0)
    tx_if = torch.where(live, tables.fib_grp_tx_if[gs, wl], tx_if)
    next_hop = torch.where(live, tables.fib_grp_nh[gs, wl], next_hop)
    node_id = torch.where(live, tables.fib_grp_node[gs, wl], node_id)
    matched = matched & (~is_grp | live)
    return FibResult(
        matched=matched,
        tx_if=torch.where(matched, tx_if, -1).to(torch.int32),
        disp=torch.where(matched, disp, int(Disposition.DROP))
        .to(torch.int32),
        next_hop=torch.where(matched, next_hop, 0).to(torch.int32),
        node_id=torch.where(matched, node_id, -1).to(torch.int32),
        snat=matched & (snat == 1),
        grp=torch.where(live, g, -1).to(torch.int32),
        way=torch.where(live, way, 0).to(torch.int32),
    )


def _dense_match(tables, dst_ip: torch.Tensor):
    """(matched [P], slot [P]) of the dense masked compare: longest
    prefix wins, ties go to the lowest slot (torch.argmax returns the
    first maximum, as jnp.argmax does)."""
    hits = (dst_ip[:, None] & tables.fib_mask[None, :]) == \
        tables.fib_prefix[None, :]
    hits = hits & (tables.fib_plen[None, :] >= 0)
    score = torch.where(hits, tables.fib_plen[None, :], -1)
    best = torch.argmax(score, dim=1)
    matched = torch.gather(score, 1, best[:, None])[:, 0] >= 0
    return matched, best.to(torch.int32)


def fib_lookup_dense(tables, pkts: PacketVector) -> FibResult:
    """The ``dense`` rung of the FIB ladder."""
    matched, slot = _dense_match(tables, pkts.dst_ip)
    return resolve_fib_slot(tables, slot, matched, fib_flow_mix(pkts))
