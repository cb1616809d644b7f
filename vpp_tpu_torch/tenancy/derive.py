"""Tenancy on the device: tenant ids, token buckets, accounting planes.

The PyTorch counterpart of ``vpp_tpu/tenancy/derive.py``:

* **Derivation.** An address's tenant is the tenant of the FIRST
  prefix-map slot whose masked network matches it (tenants' prefixes
  are validated disjoint, so slot order never picks between tenants);
  no match is the default tenant 0. A packet's tenant is
  ``max(tenant(src), tenant(dst))``: symmetric under a src/dst swap, so
  a flow's forward insert key and its reply's lookup key land in the
  same session slice. A decapped VXLAN frame's tenant is its VNI's
  (``vni_tenant``; graph.py overrides the address derivation on those
  lanes).
* **Rate limiting.** A token bucket per tenant, refilled by ``rate``
  tokens a tick up to ``burst``; within a batch a tenant's packets
  consume in packet order (a per-tenant running count over the ``[T,
  P]`` one-hot), so admission is deterministic. ``rate == 0`` is
  unlimited. The idle gap clamps at 2^14 ticks and the increment is
  capped at the headroom BEFORE it is added, so no sum leaves int32.
* **Accounting.** Per-tenant rx / forwarded / rate-limited / slice
  insert-failure counters, ``index_add_`` into ``[T]`` planes (integer
  adds are exact in any order).

The bucket and counter planes are written IN PLACE (the session-table
discipline of ops/session.py): ``tenant_limit`` and ``tnt_account``
return nothing the caller must rebind.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vpp_tpu_torch.ops.acl import first_true
from vpp_tpu_torch.ops.session import _age
from vpp_tpu_torch.pipeline.vector import PacketVector

# the refill clamp: rate * dt stays within 2^30 with rate <= 2^16
_DT_CLAMP = 1 << 14


def addr_tenant(tables, addr: torch.Tensor) -> torch.Tensor:
    """Tenant id of each address ([P] int32 bits -> [P] int32): the
    first matching prefix-map slot's tenant, 0 when none matches. The
    masked compare is on the uint32 bits."""
    hit = (((addr[:, None] & tables.tnt_pfx_mask[None, :])
            == tables.tnt_pfx_net[None, :])
           & (tables.tnt_pfx_id[None, :] >= 0))
    first = first_true(hit)
    return torch.where(hit.any(dim=1), tables.tnt_pfx_id[first],
                       0).to(torch.int32)


def key_tenant(tables, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tenant of an address pair: ``max(tenant(a), tenant(b))`` (both
    addresses through one prefix compare)."""
    both = addr_tenant(tables, torch.cat([a, b])).view(2, -1)
    return both.max(dim=0).values


def vni_tenant(tables, vni: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tid [P] int32, known [P] bool) of each VXLAN VNI: the first
    tenant whose ``tnt_vni`` is the VNI; unknown or negative VNIs are
    not known (and tid 0)."""
    plane = tables.tnt_vni
    hit = ((vni[:, None] == plane[None, :])
           & (plane[None, :] >= 0) & (vni[:, None] >= 0))
    known = hit.any(dim=1)
    return torch.where(known, first_true(hit), 0).to(torch.int32), known


def tenant_ids(tables, pkts: PacketVector) -> torch.Tensor:
    """Per-packet tenant id [P] int32 of the ingress (pre-NAT) header:
    the billing tenant. Reads no state."""
    return key_tenant(tables, pkts.src_ip, pkts.dst_ip)


def tenant_limit(tables, tid: torch.Tensor, alive: torch.Tensor,
                 now) -> torch.Tensor:
    """One token-bucket round for the batch, IN PLACE on ``tnt_tokens``
    and ``tnt_tok_time``: refill every bucket by ``rate`` times the
    ticks since its last refill (clamped; the increment capped at the
    headroom), admit each alive packet whose arrival rank within its
    tenant fits the refilled level, drop the rest. ``now`` is the
    step's clock (a 0-d int32 tensor, or an int). Returns the dropped
    mask [P]; run it exactly once a step."""
    n_t = tables.tnt_rate.shape[0]
    rate, burst, tokens = (t.to(torch.int64) for t in (
        tables.tnt_rate, tables.tnt_burst, tables.tnt_tokens))
    dt = torch.clamp(_age(now, tables.tnt_tok_time), 0, _DT_CLAMP)
    # rate <= 2^16 (validated), dt <= 2^14 and burst and the carried
    # level within 0..2^30 (validated; the level is clipped to burst):
    # no term leaves int32, so the int64 sums are the reference's
    tok = tokens + torch.minimum(rate * dt, burst - tokens)
    limited = rate > 0
    tl = tid.long()
    # the [T, P] one-hot, packets along the innermost axis: the running
    # count of each tenant's row is one fast scan (a cumsum down the
    # packet axis of a [P, T] layout is a slow strided scan on CUDA);
    # a packet's arrival rank within its tenant is its row's count
    # before it, the inclusive count less itself
    onehot = ((torch.arange(n_t, device=tid.device)[:, None] == tl[None, :])
              & alive[None, :])
    count = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32)
    my_rank = count.gather(0, tl[None, :])[0] - 1
    dropped = alive & limited[tl] & (my_rank >= tok[tl])
    admitted = (onehot & ~dropped[None, :]).sum(dim=1)
    tok_after = torch.where(
        limited, torch.minimum(torch.clamp(tok - admitted, min=0), burst),
        burst)
    tables.tnt_tokens.copy_(tok_after.to(torch.int32))
    if torch.is_tensor(now):
        tables.tnt_tok_time.copy_(now.to(torch.int32).expand(n_t))
    else:
        v = int(now) & 0xFFFFFFFF
        tables.tnt_tok_time.fill_(v - (1 << 32) if v >> 31 else v)
    return dropped


def tnt_account(tables, tid: torch.Tensor, rx: torch.Tensor,
                forwarded: torch.Tensor, rl_dropped: torch.Tensor,
                quota_fail: torch.Tensor) -> None:
    """Add the batch into the per-tenant planes, in place: packets
    received, forwarded, rate-limited and failed in their session slice.
    A masked-out lane adds 0 to tenant 0 (the reference drops it at
    index T)."""
    tl = tid.long()
    for plane, mask in ((tables.tnt_rx_c, rx), (tables.tnt_tx_c, forwarded),
                        (tables.tnt_rl_c, rl_dropped),
                        (tables.tnt_qf_c, quota_fail)):
        plane.index_add_(0, torch.where(mask, tl, 0), mask.to(torch.int32))


def tenant_occupancy(valid: torch.Tensor, time: torch.Tensor, now,
                     max_age, base: torch.Tensor,
                     nbk: torch.Tensor) -> torch.Tensor:
    """Live sessions in each tenant's bucket range ``[base, base +
    nbk)`` ([T] int32): one prefix sum over the per-bucket live counts,
    then a range difference per tenant."""
    live = (valid == 1) & (_age(now, time) <= max_age)
    per_bucket = live.sum(dim=1, dtype=torch.int32)
    n = per_bucket.shape[0]
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=valid.device),
                     torch.cumsum(per_bucket, dim=0, dtype=torch.int32)])
    lo = torch.clamp(base, 0, n).long()
    hi = torch.clamp(base + nbk, 0, n).long()
    return cum[hi] - cum[lo]
