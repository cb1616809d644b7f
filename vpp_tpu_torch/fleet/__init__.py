"""Gateway fleet: consistent-hash flow steering, live session
migration, elastic scale-out (ISSUE 18; docs/FLEET.md).

The port's copy of ``vpp_tpu/fleet``; the instances are the port's
``Dataplane`` objects (one card holds them all in one process), and
the steering tier itself runs on the host. Layering:

* :mod:`vpp_tpu_torch.fleet.hashring` — bucket/range math: the bit-identical
  NumPy twin of the device ``sym`` session hash, rendezvous range
  assignment with a proven disruption bound, tenant-slice placement.
* :mod:`vpp_tpu_torch.fleet.membership` — kvstore-coordinated presence
  (TTL leases) and per-range ownership epochs (CAS fencing tokens).
* :mod:`vpp_tpu_torch.fleet.steering` — the routing brain: per-frame
  partition, live drain/adopt migration, crash recovery, exact
  conservation accounting.
* :mod:`vpp_tpu_torch.io.fleet` — the pump tier fronting the instances
  (bounded per-instance queues, worker threads, aggregate stats).
"""

from vpp_tpu_torch.fleet.hashring import (
    assign_ranges,
    buckets_of_packed,
    canon_mix_np,
    moved_ranges,
    range_span,
    tenant_ranges,
    tenant_spread,
)
from vpp_tpu_torch.fleet.membership import FleetMembership
from vpp_tpu_torch.fleet.steering import FleetSteering

__all__ = [
    "assign_ranges",
    "buckets_of_packed",
    "canon_mix_np",
    "moved_ranges",
    "range_span",
    "tenant_ranges",
    "tenant_spread",
    "FleetMembership",
    "FleetSteering",
]
