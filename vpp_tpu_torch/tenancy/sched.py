"""Host side of tenancy: the ``tenants:`` list, and the pump's lanes.

The port's copy of ``vpp_tpu/tenancy/sched.py``: the configuration
helpers (the same bounds, defaults and messages), and the IO pump's
``TenantClassifier`` (frame -> tenant, mirroring the device derivation
on frame column blocks) and ``TenantScheduler`` (weighted-fair dequeue
over per-tenant FIFO queues of ring-order ids, virtual-time WFQ, and
shedding from the tenant with the most backlog per unit weight). This
module imports no torch, so the CLI and light processes can use it.
"""

from __future__ import annotations

import collections
import ipaddress
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

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


class TenantClassifier:
    """Frame → tenant id for the pump's weighted-fair lanes.

    Mirrors the device derivation (tenancy/derive.py) on a frame's
    column block: per packet, the max tenant whose prefix matches src
    OR dst (tenant prefixes are validated DISJOINT across tenants at
    config load, so the device's first-match and this max derive
    identically); a frame classifies as the max over its packets
    (frames are the pump's scheduling unit). The VNI
    map serves encapsulated ingress where the daemon knows the VNI
    before any header parse.
    """

    def __init__(self, entries: Iterable[dict]):
        entries = tenant_entries_from_config(entries)
        nets: List[Tuple[int, int, int]] = []
        self.weights: Dict[int, int] = {}
        self.names: Dict[int, str] = {}
        self._vni: Dict[int, int] = {}
        for e in entries:
            tid = e["id"]
            self.weights[tid] = e["weight"]
            self.names[tid] = e["name"]
            if e["vni"] is not None:
                self._vni[e["vni"]] = tid
            for p in e["prefixes"]:
                net = ipaddress.ip_network(p, strict=False)
                nets.append((int(net.network_address), int(net.netmask),
                             tid))
        self._net = np.asarray([n for n, _m, _t in nets], np.uint32)
        self._mask = np.asarray([m for _n, m, _t in nets], np.uint32)
        self._tid = np.asarray([t for _n, _m, t in nets], np.int64)

    def weight(self, tid: int) -> int:
        return self.weights.get(tid, 1)

    def tenant_of_vni(self, vni: int) -> int:
        """Tenant of a VXLAN VNI (0 = unmapped → the default tenant)."""
        return self._vni.get(int(vni), 0)

    def packet_tenants(self, src_ip: np.ndarray,
                       dst_ip: np.ndarray) -> np.ndarray:
        """Per-packet tenant ids (int64 [n]) — max matching tenant of
        src or dst, 0 unmatched."""
        src = np.asarray(src_ip, np.uint32)
        dst = np.asarray(dst_ip, np.uint32)
        out = np.zeros(src.shape, np.int64)
        for net, mask, tid in zip(self._net, self._mask, self._tid):
            m = ((src & mask) == net) | ((dst & mask) == net)
            np.maximum(out, np.where(m, tid, 0), out=out)
        return out

    def frame_tenant(self, frame) -> int:
        """Tenant of one rx frame (max over its valid packets)."""
        n = frame.n
        if not n or self._net.size == 0:
            return 0
        c = frame.cols
        return int(self.packet_tenants(
            c["src_ip"][:n], c["dst_ip"][:n]).max())


class TenantScheduler:
    """Virtual-time weighted-fair queues over taken ring-order ids.

    Externally synchronized (the pump's ``_held_lock``). ``push``
    enqueues a classified frame; ``pick``/``pop`` implement WFQ
    service (least virtual time first, vtime advancing by
    ``packets / weight``); ``shed_pick`` names the brownout victim —
    the tenant with the largest backlog per unit weight."""

    def __init__(self, weights: Optional[Dict[int, int]] = None):
        self._w = dict(weights or {})
        self._q: Dict[int, "collections.deque"] = {}
        self._vtime: Dict[int, float] = {}
        self._backlog_pkts: Dict[int, int] = {}
        self.total_frames = 0
        self.total_pkts = 0

    def weight(self, tid: int) -> int:
        return max(1, int(self._w.get(tid, 1)))

    def push(self, tid: int, rid: int, n_pkts: int) -> None:
        q = self._q.get(tid)
        if q is None:
            q = self._q[tid] = collections.deque()
        if not q:
            # idle→active rebase: a tenant cannot bank idle time into
            # a burst that starves currently-active tenants
            active = [self._vtime[t] for t, tq in self._q.items()
                      if tq and t != tid]
            floor = min(active) if active else 0.0
            self._vtime[tid] = max(self._vtime.get(tid, 0.0), floor)
        q.append((rid, int(n_pkts)))
        self._backlog_pkts[tid] = self._backlog_pkts.get(tid, 0) + int(n_pkts)
        self.total_frames += 1
        self.total_pkts += int(n_pkts)

    def active(self) -> List[int]:
        return [t for t, q in self._q.items() if q]

    def pick(self) -> Optional[int]:
        """The WFQ service decision: non-empty tenant with least
        virtual time (ties broken by tenant id for determinism)."""
        best = None
        for t in self.active():
            key = (self._vtime.get(t, 0.0), t)
            if best is None or key < best[0]:
                best = (key, t)
        return None if best is None else best[1]

    def shed_pick(self) -> Optional[int]:
        """The brownout victim: most backlog packets per unit weight —
        per-tenant-weighted shedding, not FIFO."""
        best = None
        for t in self.active():
            key = (self._backlog_pkts.get(t, 0) / self.weight(t), t)
            if best is None or key > best[0]:
                best = (key, t)
        return None if best is None else best[1]

    def pop(self, tid: int, max_pkts: int) -> List[Tuple[int, int]]:
        """Dequeue up to ``max_pkts`` packets of ``tid`` (at least one
        frame), advancing its virtual time. Returns [(rid, n), ...]."""
        q = self._q.get(tid)
        out: List[Tuple[int, int]] = []
        pkts = 0
        while q and (not out or pkts + q[0][1] <= max_pkts):
            rid, n = q.popleft()
            out.append((rid, n))
            pkts += n
        if pkts:
            self._vtime[tid] = self._vtime.get(tid, 0.0) \
                + pkts / self.weight(tid)
            self._backlog_pkts[tid] = max(
                0, self._backlog_pkts.get(tid, 0) - pkts)
            self.total_frames -= len(out)
            self.total_pkts -= pkts
        return out

    def requeue_front(self, tid: int, frames: List[Tuple[int, int]]) -> None:
        """Return un-dispatched frames to the HEAD of their queue (the
        ring-fault fallback path) and roll their service back."""
        q = self._q.setdefault(tid, collections.deque())
        pkts = sum(n for _rid, n in frames)
        q.extendleft(reversed(frames))
        self._vtime[tid] = max(
            0.0, self._vtime.get(tid, 0.0) - pkts / self.weight(tid))
        self._backlog_pkts[tid] = self._backlog_pkts.get(tid, 0) + pkts
        self.total_frames += len(frames)
        self.total_pkts += pkts

    def backlog_pkts(self, tid: int) -> int:
        return self._backlog_pkts.get(tid, 0)

    def snapshot(self) -> Dict[int, dict]:
        """Per-tenant queue state (frames/packets queued, vtime) —
        CLI/collector reads; caller holds the pump's lock."""
        return {
            t: {"frames": len(q), "pkts": self._backlog_pkts.get(t, 0),
                "vtime": self._vtime.get(t, 0.0),
                "weight": self.weight(t)}
            for t, q in self._q.items() if q
        }
