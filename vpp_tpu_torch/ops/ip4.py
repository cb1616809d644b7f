"""ip4-input: header validation + TTL handling (the counterpart of
``vpp_tpu/ops/ip4.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from vpp_tpu_torch.pipeline.vector import PacketVector


def ip4_input(pkts: PacketVector) -> Tuple[PacketVector, torch.Tensor]:
    """Validate packets; returns (packets with decremented TTL, drop
    mask). Drops: TTL <= 1, length below an IPv4 header. Invalid frame
    slots are never dropped (they do not exist)."""
    valid = pkts.valid
    drop = ((pkts.ttl <= 1) | (pkts.pkt_len < 20)) & valid
    out = pkts._replace(
        ttl=torch.where(valid & ~drop, pkts.ttl - 1, pkts.ttl))
    return out, drop
