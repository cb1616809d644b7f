"""Fleet membership and per-range ownership epochs (ISSUE 18).

The kvstore is the fleet's single coordination point, reusing the
machinery ISSUEs 10/13 built rather than inventing a second consensus:

* **Membership** is lease-backed presence (the DataplanePump
  registration pattern): an instance joins by writing
  ``<prefix>/members/<name>`` under a TTL lease and heartbeats the
  lease; a crashed instance vanishes when its lease expires, and every
  steering tier observes the SAME member set through a prefix watch —
  no gossip, no split view beyond store staleness (which the kvstore
  client already bounds and exposes).
* **Ownership epochs** are per-RANGE fencing tokens
  (``<prefix>/epoch/<rid>``), advanced only by compare-and-put — the
  witness/fencing discipline of kvstore/replica.py applied at
  hash-range granularity. A migration FENCES the range first (epoch
  bump, state ``fenced``), moves the sessions, then COMMITS
  (state ``serving``, new owner, same epoch). Steering tiers admit a
  packet only against the range's CURRENT serving epoch, so a tier that
  crashed mid-view or a migration that died mid-move can never cause
  two instances to serve one range: the range stays fenced (packets
  drop, attributed) until :meth:`FleetSteering.recover` re-runs the
  move. Epochs only advance — the monotonic-token law the witness
  enforces for whole-store primaries holds per range here.

Duck-typed over ``kvstore.store.KVStore`` and
``kvstore.client.RemoteKVStore`` alike — membership never imports a
transport. The port's copy of ``vpp_tpu/fleet/membership.py``: the keys
and records are the reference's, so either package's steering tier
reads the other's epochs.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("vpp_tpu_torch.fleet")

SERVING = "serving"
FENCED = "fenced"

# CAS retry bound for epoch advances: contention on ONE range is at
# most steering tiers racing a recover — single digits, not unbounded
_CAS_ATTEMPTS = 16


class FleetMembership:
    """One instance's (or steering tier's) handle on fleet state.

    Dataplane instances ``join()`` and ``heartbeat()``; steering tiers
    only read (``members()``/``watch_members()``) and drive epochs
    (``fence_range``/``commit_range``). All methods are safe to call
    from any thread — kvstore ops are atomic and local state is locked.
    """

    def __init__(self, store, name: str, addr: str = "",
                 prefix: str = "/fleet", ttl_s: float = 5.0):
        self.store = store
        self.name = name
        self.addr = addr
        self.prefix = prefix.rstrip("/")
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._lease: Optional[int] = None

    # --- presence ---------------------------------------------------

    def _member_key(self, name: str) -> str:
        return f"{self.prefix}/members/{name}"

    def join(self) -> None:
        """Register under a TTL lease; idempotent (re-join refreshes)."""
        with self._lock:
            if self._lease is None:
                self._lease = self.store.lease_grant(self.ttl_s)
            self.store.put(self._member_key(self.name),
                           {"name": self.name, "addr": self.addr},
                           lease=self._lease)

    def heartbeat(self) -> bool:
        """Keep the presence lease alive. False means the lease already
        expired — the member MUST treat itself as out of the fleet
        (its ranges may be reassigned) and re-``join()``."""
        with self._lock:
            lease = self._lease
        if lease is None:
            return False
        ok = bool(self.store.lease_keepalive(lease))
        if not ok:
            with self._lock:
                if self._lease == lease:
                    self._lease = None
        return ok

    def leave(self) -> None:
        """Deregister promptly (lease revoke beats TTL expiry)."""
        with self._lock:
            lease, self._lease = self._lease, None
        if lease is not None:
            self.store.lease_revoke(lease)

    def members(self) -> List[str]:
        """Current member names, sorted — the rendezvous input."""
        vals = self.store.list_values(f"{self.prefix}/members/")
        return sorted(v["name"] for v in vals.values()
                      if isinstance(v, dict) and "name" in v)

    def watch_members(self, callback: Callable[[List[str]], None]
                      ) -> Tuple[List[str], Callable[[], None]]:
        """Watch the member set: ``callback(sorted_names)`` on every
        join/leave/expiry. Returns ``(initial_members, cancel)`` with
        no gap between snapshot and stream
        (``watch_with_snapshot`` semantics). Over a RemoteKVStore the
        resync hook re-emits the member list after a reconnect — churn
        that happened during the outage never streams as events, so
        without it a steering tier would rendezvous on a stale fleet
        until the NEXT join/leave."""
        def on_event(_ev) -> None:
            callback(self.members())

        def on_resync(snap, _rev) -> None:
            callback(sorted(v["name"] for v in snap.values()
                            if isinstance(v, dict) and "name" in v))

        snap, _rev, cancel = self.store.watch_with_snapshot(
            f"{self.prefix}/members/", on_event, on_resync=on_resync)
        names = sorted(v["name"] for v in snap.values()
                       if isinstance(v, dict) and "name" in v)
        return names, cancel

    # --- per-range ownership epochs ---------------------------------

    def _epoch_key(self, rid: int) -> str:
        return f"{self.prefix}/epoch/{int(rid)}"

    def range_state(self, rid: int) -> Dict[str, Any]:
        """``{"epoch", "state", "owner", "to"}`` of one range; a range
        never written yet is epoch 0 serving under no owner."""
        cur = self.store.get(self._epoch_key(rid))
        if not isinstance(cur, dict):
            return {"epoch": 0, "state": SERVING, "owner": None,
                    "to": None}
        return cur

    def range_states(self) -> Dict[int, Dict[str, Any]]:
        vals = self.store.list_values(f"{self.prefix}/epoch/")
        out: Dict[int, Dict[str, Any]] = {}
        for k, v in vals.items():
            try:
                rid = int(k.rsplit("/", 1)[-1])
            except ValueError:
                continue
            if isinstance(v, dict):
                out[rid] = v
        return out

    def claim_range(self, rid: int, owner: str) -> int:
        """Initial ownership record of an unmoved range (epoch advance,
        straight to serving). Used at fleet bring-up so steering tiers
        validate epochs from the first packet."""
        return self._advance(rid, owner=owner, state=SERVING, to=None)

    def fence_range(self, rid: int, to: str) -> int:
        """Advance the range's epoch into ``fenced`` ahead of a
        migration. From this CAS on, NO steering tier admits traffic
        for the range under any older epoch — including tiers that have
        not yet seen the bump, because admission checks the serving
        epoch they cached and this bump invalidates it. Returns the new
        (fenced) epoch."""
        return self._advance(rid, owner=None, state=FENCED, to=to)

    def commit_range(self, rid: int, epoch: int, owner: str) -> bool:
        """Flip a fenced range to serving under its new owner, same
        epoch — only valid against the exact fenced record (CAS), so a
        stale migrator whose fence was superseded cannot commit."""
        cur = self.store.get(self._epoch_key(rid))
        if (not isinstance(cur, dict) or cur.get("state") != FENCED
                or int(cur.get("epoch", -1)) != int(epoch)):
            return False
        new = {"epoch": int(epoch), "state": SERVING,
               "owner": owner, "to": None}
        return bool(self.store.compare_and_put(
            self._epoch_key(rid), cur, new))

    def is_current(self, rid: int, epoch: int) -> bool:
        """The steer-time admission check: serving AND epoch matches."""
        cur = self.range_state(rid)
        return (cur.get("state") == SERVING
                and int(cur.get("epoch", 0)) == int(epoch))

    def fenced_ranges(self) -> Dict[int, Dict[str, Any]]:
        """Ranges stuck mid-migration (the recover() work-list)."""
        return {rid: st for rid, st in self.range_states().items()
                if st.get("state") == FENCED}

    def _advance(self, rid: int, owner: Optional[str], state: str,
                 to: Optional[str]) -> int:
        key = self._epoch_key(rid)
        for _ in range(_CAS_ATTEMPTS):
            cur = self.store.get(key)
            if cur is None:
                new = {"epoch": 1, "state": state,
                       "owner": owner, "to": to}
                if self.store.compare_and_put(key, None, new):
                    return 1
                continue
            if not isinstance(cur, dict):
                raise RuntimeError(
                    f"corrupt range-epoch record at {key}: {cur!r}")
            new = {"epoch": int(cur.get("epoch", 0)) + 1,
                   "state": state,
                   "owner": (owner if owner is not None
                             else cur.get("owner")),
                   "to": to}
            if self.store.compare_and_put(key, cur, new):
                return new["epoch"]
        raise RuntimeError(
            f"range {rid} epoch CAS contended past "
            f"{_CAS_ATTEMPTS} attempts")
