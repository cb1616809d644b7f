"""Host side of tenancy: the ``tenants:`` list, normalised and checked.

The port's copy of the configuration half of ``vpp_tpu/tenancy/sched.py``
(the same bounds, defaults and messages). ``TenantClassifier`` and
``TenantScheduler`` belong to the IO pump and come with it (ROADMAP
Queue 1 item 11). This module imports no torch at load, so the CLI and
light processes can use it.
"""

from __future__ import annotations

import ipaddress
from typing import Iterable, List, Tuple

# bounds shared with the token bucket's int32 refill (tenancy/derive.py):
# rate * dt stays within 2^30 with dt clamped at 2^14
MAX_RATE = 1 << 16
MAX_BURST = 1 << 30

_ML_MODES = ("inherit", "off", "score", "enforce")
# device encoding of the per-tenant ML mode vector (glb_ml_tnt_mode):
# 0 inherit the global stage, 1 off, 2 score only, 3 enforce
ML_MODE_CODES = {m: i for i, m in enumerate(_ML_MODES)}

_KNOWN_KEYS = {"id", "name", "prefixes", "vni", "rate", "burst",
               "sess_buckets", "nat_buckets", "weight", "ml_mode",
               "ml_thresh"}


def tenant_entries_from_config(entries: Iterable[dict]) -> List[dict]:
    """Normalise a ``tenants:`` list into full entry dicts with the
    defaults filled in; unknown keys are refused."""
    out = []
    for e in entries or ():
        e = dict(e or {})
        unknown = set(e) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown tenant config keys: {sorted(unknown)}")
        if "id" not in e:
            raise ValueError("tenant entry missing 'id'")
        out.append({
            "id": int(e["id"]),
            "name": str(e.get("name", f"tenant-{int(e['id'])}")),
            "prefixes": [str(p) for p in (e.get("prefixes") or ())],
            "vni": (int(e["vni"]) if e.get("vni") is not None else None),
            "rate": int(e.get("rate", 0)),
            "burst": int(e.get("burst", 0)),
            "sess_buckets": int(e.get("sess_buckets", 0)),
            "nat_buckets": int(e.get("nat_buckets", 0)),
            "weight": int(e.get("weight", 1)),
            "ml_mode": str(e.get("ml_mode", "inherit")),
            "ml_thresh": (int(e["ml_thresh"])
                          if e.get("ml_thresh") is not None else None),
        })
    return out


def validate_tenancy_config(dataplane_cfg, entries: Iterable[dict]
                            ) -> List[dict]:
    """Refuse a bad ``tenants:`` list before anything is staged: ids out
    of range or repeated, unparsable, non-IPv4 or cross-tenant
    overlapping prefixes, a prefix map larger than the device plane,
    rate / burst outside the int32 refill, and session / NAT slices that
    are not powers of two, oversubscribe the table, or leave no
    residual range while an unsliced tenant (the implicit default
    tenant 0 counts) needs one. Returns the normalised entries."""
    entries = tenant_entries_from_config(entries)
    from vpp_tpu_torch.pipeline.tables import (
        _is_pow2,
        natsess_slots_of,
        tnt_capacity,
    )

    tenants = int(getattr(dataplane_cfg, "tenancy_tenants", 8))
    ways = int(getattr(dataplane_cfg, "sess_ways", 4))
    sess_buckets = int(dataplane_cfg.sess_slots) // ways
    nat_buckets = natsess_slots_of(dataplane_cfg) // ways
    pfx_slots = tnt_capacity(dataplane_cfg)[1]
    seen = set()
    sliced = {"sess": 0, "nat": 0}
    # the default tenant 0 is unsliced unless registered with a slice
    unsliced = {"sess": not any(e["id"] == 0 and e["sess_buckets"]
                                for e in entries),
                "nat": not any(e["id"] == 0 and e["nat_buckets"]
                               for e in entries)}
    n_prefixes = 0
    nets_seen: List[Tuple[int, object]] = []
    for e in entries:
        tid = e["id"]
        if not 0 <= tid < tenants:
            raise ValueError(
                f"tenant id {tid} outside 0..{tenants - 1} "
                f"(dataplane.tenancy_tenants)")
        if tid in seen:
            raise ValueError(f"duplicate tenant id {tid}")
        seen.add(tid)
        for p in e["prefixes"]:
            net = ipaddress.ip_network(p, strict=False)
            if net.version != 4:
                raise ValueError(
                    f"tenant {tid}: prefixes must be IPv4, got {p!r}")
            # the device takes the first matching slot and the host
            # classifier the largest tenant: they agree only when the
            # tenants' prefixes are disjoint
            for other_tid, other_net in nets_seen:
                if other_tid != tid and net.overlaps(other_net):
                    raise ValueError(
                        f"tenant {tid}: prefix {p} overlaps tenant "
                        f"{other_tid}'s {other_net} — tenant prefixes "
                        f"must be disjoint across tenants (device "
                        f"first-match vs host max would diverge)")
            nets_seen.append((tid, net))
            n_prefixes += 1
        if not 0 <= e["rate"] <= MAX_RATE:
            raise ValueError(
                f"tenant {tid}: rate must be 0..{MAX_RATE} tokens/tick, "
                f"got {e['rate']}")
        if not 0 <= e["burst"] <= MAX_BURST:
            raise ValueError(
                f"tenant {tid}: burst must be 0..{MAX_BURST}, "
                f"got {e['burst']}")
        if e["rate"] and not e["burst"]:
            raise ValueError(
                f"tenant {tid}: rate {e['rate']} with burst 0 admits "
                f"no traffic (set burst >= rate)")
        if e["weight"] < 1:
            raise ValueError(
                f"tenant {tid}: weight must be >= 1, got {e['weight']}")
        if e["ml_mode"] not in _ML_MODES:
            raise ValueError(
                f"tenant {tid}: ml_mode must be one of {_ML_MODES}, "
                f"got {e['ml_mode']!r}")
        for kind, total in (("sess", sess_buckets), ("nat", nat_buckets)):
            nbk = e[f"{kind}_buckets"]
            if nbk and not _is_pow2(nbk):
                raise ValueError(
                    f"tenant {tid}: {kind}_buckets must be 0 (unsliced) "
                    f"or a power of two, got {nbk}")
            if nbk > total:
                raise ValueError(
                    f"tenant {tid}: {kind}_buckets {nbk} exceeds the "
                    f"table's {total} buckets")
            sliced[kind] += nbk
            if not nbk:
                unsliced[kind] = True
    if n_prefixes > pfx_slots:
        raise ValueError(
            f"tenant prefixes total {n_prefixes} exceeds the device "
            f"map's {pfx_slots} slots (raise dataplane.tenancy_prefixes)")
    for kind, total in (("sess", sess_buckets), ("nat", nat_buckets)):
        if sliced[kind] > total:
            raise ValueError(
                f"tenant {kind}_buckets oversubscribed: {sliced[kind]} "
                f"> {total} table buckets")
        if unsliced[kind] and sliced[kind] >= total:
            raise ValueError(
                f"tenant {kind}_buckets {sliced[kind]} fills the whole "
                f"{total}-bucket table but an unsliced tenant (the "
                f"default tenant counts) still needs residual range — "
                f"leave headroom or slice every tenant incl. id 0")
    return entries
