"""Fleet flow steering and live session migration (ISSUE 18).

:class:`FleetSteering` is the host-side control brain of a gateway
fleet: N ``Dataplane`` instances (each running ``sess_hash: sym``),
one consistent-hash ownership map over session-bucket RANGES, and a
per-packet routing decision computed entirely from frame columns
(hashring.buckets_of_packed — no device round-trip, no per-packet
kvstore read).

The invariants, in the order they are enforced:

* **Conservation.** Every offered packet is either steered to exactly
  one instance or dropped with an attributed cause (``fenced`` /
  ``no_owner``): ``offered == sum(steered) + fenced + no_owner``
  holds EXACTLY at all times, including mid-rebalance and after a
  crashed migration. The queue tier (io/fleet.py) extends the identity
  with its own attributed drops.
* **Single-writer per range.** The route table maps each range to at
  most one instance; a fenced range maps to NONE. Fencing happens
  FIRST in a migration (membership.fence_range — a kvstore CAS), so
  from the moment sessions start moving, no steering tier routes the
  range anywhere. "Never serve a fenced epoch" is structural: the
  route code literally has no destination for a fenced range.
* **Migration moves state, not flows.** A moved range's sessions are
  drained off the source (pipeline/snapshot.py ``drain_bucket_range``
  — the snapshot chunk program), adopted into the destination
  age-rebased (``adopt_bucket_range``), COMMITTED (epoch flips to
  serving under the new owner), then released on the source. The
  commit-before-release order makes a crash at ANY step recoverable
  by re-running the move (:meth:`recover`): until commit, the source
  still holds every session, so re-drain/re-adopt is idempotent; after
  commit, the destination serves and the source's stale rows are inert
  (steering never routes the range there) until released or
  idle-swept.

Fault points: ``fleet.steer`` fires per partition call;
``fleet.migrate`` fires per drained chunk inside drain_bucket_range
and once more before the commit — the chaos schedule in
tests/test_fleet.py kills a migration at both seams and proves
conservation + fencing hold through recovery.

**NAT cold starts (ISSUE 19).** Only the reflective table migrates;
NAT sessions key on the post-NAT pair and stay behind (the PR-18
limitation, docs/FLEET.md). Every migration now COUNTS the flows
that limitation touches: the NAT session extras carry the full
pre-NAT tuple, so :meth:`_nat_coldstarts_in_range` reconstructs each
live NAT session's steering bucket exactly and tallies the ones in
the moved range into ``stats["nat_coldstarts"]`` →
``vpp_tpu_fleet_nat_coldstarts_total``. Those flows keep flowing —
the destination re-establishes their NAT state from the mapping
tables within its first windows (tests/test_fleet_coldstart.py
bounds the re-establishment and proves conservation through it).

The port's copy of ``vpp_tpu/fleet/steering.py``. The instances are the
port's ``Dataplane`` objects: the migration goes through the port's
range drain, adopt and release (``pipeline/snapshot.py``), and the NAT
cold-start count hashes the NAT session columns with the port's
``ops.session.canon_mix`` on the instances' device. On one card every
instance shares the device: a fleet here is N dataplanes in one
process, not N hosts.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from vpp_tpu_torch.fleet.hashring import (
    assign_ranges,
    buckets_of_packed,
    buckets_per_range,
    moved_ranges,
    range_span,
)
from vpp_tpu_torch.fleet.membership import FENCED, SERVING, FleetMembership
from vpp_tpu_torch.testing import faults

log = logging.getLogger("vpp_tpu_torch.fleet")

# drop causes THIS layer attributes (the conservation identity's
# steering terms). The collector's vpp_tpu_fleet_drops_total cause
# axis must cover these — enforced by the --counters parity pass
# (tools/analysis/registries.py), the PUMP_DROP_REASONS discipline.
STEER_DROP_CAUSES = ("fenced", "no_owner")


class FleetSteering:
    """Steer packed frames across a fleet of sym-hash dataplanes.

    ``instances`` maps name → live ``Dataplane``; all must share one
    session-table geometry and run ``sess_hash: sym`` (validated —
    a fwd-hash instance would bucket replies differently than the
    steering tier and silently miss after every migration).

    With no ``membership``, a private in-proc kvstore backs the epoch
    records — the single-host fleet the bench runs. Hand in a shared
    :class:`FleetMembership` to coordinate multiple steering tiers.
    """

    def __init__(self, instances: Dict[str, Any],
                 membership: Optional[FleetMembership] = None,
                 n_ranges: int = 16):
        if not instances:
            raise ValueError("fleet needs at least one instance")
        self.instances = dict(instances)
        self._names = sorted(self.instances)
        self._name_idx = {n: i for i, n in enumerate(self._names)}
        geoms = set()
        for name, dp in self.instances.items():
            if getattr(dp, "_sess_hash", "fwd") != "sym":
                raise ValueError(
                    f"instance {name!r} runs sess_hash="
                    f"{getattr(dp, '_sess_hash', 'fwd')!r}; fleet "
                    f"steering requires 'sym' (direction-invariant "
                    f"buckets) on every instance")
            cfg = dp.config
            geoms.add((int(cfg.sess_slots),
                       int(getattr(cfg, "sess_ways", 4))))
        if len(geoms) != 1:
            raise ValueError(
                f"instances disagree on session geometry: {geoms} — "
                f"range migration splices same-shape tables")
        (slots, ways), = geoms
        self.n_buckets = slots // ways
        self.n_ranges = int(n_ranges)
        self._per = buckets_per_range(self.n_buckets, self.n_ranges)

        if membership is None:
            from vpp_tpu_torch.kvstore.store import KVStore
            membership = FleetMembership(KVStore(), name="steering")
        self.membership = membership

        # local route state: mutated only under _lock, read lock-free
        # by partition() as one immutable array reference (the
        # dataplane epoch-swap discipline, host-side)
        self._lock = threading.Lock()
        self._owners: Dict[int, str] = {}
        self._epochs: Dict[int, int] = {}
        self._fenced: set = set()
        self._route_code = np.full(self.n_ranges, -1, np.int64)
        self._migrate_lock = threading.Lock()

        self.stats: Dict[str, Any] = {
            "offered": 0, "fenced_drops": 0, "no_owner_drops": 0,
            "rebalances": 0, "migrated_ranges": 0,
            "migrated_sessions": 0, "recovered_ranges": 0,
            "nat_coldstarts": 0, "epoch_max": 0,
            "steered": {n: 0 for n in self._names},
        }

        # other tiers' fences must stop OUR routing too: follow the
        # epoch records. Callback runs under the store lock — it only
        # touches local maps (never calls back into the store).
        self._cancel_watch = self.membership.store.watch(
            f"{self.membership.prefix}/epoch/", self._on_epoch_event)

        self._bootstrap()

    # --- bring-up ----------------------------------------------------

    def _bootstrap(self) -> None:
        """Claim an initial serving epoch per range so admission is
        epoch-checked from the first packet; adopt existing records if
        another tier bootstrapped first."""
        target = assign_ranges(self._names, self.n_ranges)
        existing = self.membership.range_states()
        for rid in range(self.n_ranges):
            st = existing.get(rid)
            if st is None:
                owner = target[rid]
                epoch = self.membership.claim_range(rid, owner)
                st = {"epoch": epoch, "state": SERVING,
                      "owner": owner, "to": None}
            self._apply_record(rid, st)

    def close(self) -> None:
        if self._cancel_watch is not None:
            self._cancel_watch()
            self._cancel_watch = None

    # --- route table -------------------------------------------------

    def _apply_record(self, rid: int, st: Dict[str, Any]) -> None:
        with self._lock:
            epoch = int(st.get("epoch", 0))
            self._epochs[rid] = epoch
            self.stats["epoch_max"] = max(self.stats["epoch_max"],
                                          epoch)
            if st.get("state") == FENCED:
                self._fenced.add(rid)
            else:
                self._fenced.discard(rid)
                owner = st.get("owner")
                if owner is not None:
                    self._owners[rid] = owner
            self._rebuild_route_locked()

    def _on_epoch_event(self, ev) -> None:
        try:
            rid = int(ev.key.rsplit("/", 1)[-1])
        except ValueError:
            return
        if isinstance(ev.value, dict):
            self._apply_record(rid, ev.value)

    def _rebuild_route_locked(self) -> None:
        code = np.full(self.n_ranges, -1, np.int64)
        for rid, name in self._owners.items():
            code[rid] = self._name_idx.get(name, -1)
        for rid in self._fenced:
            code[rid] = -2
        self._route_code = code

    def owners(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._owners)

    # --- the per-frame decision --------------------------------------

    def partition(self, flat: np.ndarray,
                  tenant_ids: Optional[np.ndarray] = None,
                  tnt_base: Optional[np.ndarray] = None,
                  tnt_mask: Optional[np.ndarray] = None,
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
        """Route one packed ``[5, B]`` frame: returns
        ``({instance: packet index array}, {"fenced": n, "no_owner": n})``.
        Pure column math — one vectorized hash, one route-code gather;
        no locks on the hot path (the route code is read as a single
        immutable array reference)."""
        faults.fire("fleet.steer")
        b = buckets_of_packed(flat, self.n_buckets,
                              tenant_ids=tenant_ids,
                              tnt_base=tnt_base, tnt_mask=tnt_mask)
        rids = b // self._per
        code = self._route_code[rids]
        groups: Dict[str, np.ndarray] = {}
        for i, name in enumerate(self._names):
            idx = np.nonzero(code == i)[0]
            if idx.size:
                groups[name] = idx
        drops = {"fenced": int((code == -2).sum()),
                 "no_owner": int((code == -1).sum())}
        n = int(np.asarray(flat).shape[1])
        with self._lock:
            self.stats["offered"] += n
            self.stats["fenced_drops"] += drops["fenced"]
            self.stats["no_owner_drops"] += drops["no_owner"]
            for name, idx in groups.items():
                self.stats["steered"][name] += int(idx.size)
        return groups, drops

    # --- rebalance / migration ---------------------------------------

    def target_assignment(self,
                          members: Optional[List[str]] = None
                          ) -> Dict[int, str]:
        """Rendezvous target over ``members`` (default: registered
        fleet members that are live instances here, else all local
        instances)."""
        if members is None:
            live = [m for m in self.membership.members()
                    if m in self.instances]
            members = live or self._names
        return assign_ranges(members, self.n_ranges)

    def rebalance(self,
                  target: Optional[Dict[int, str]] = None) -> int:
        """Drive ownership to ``target`` (default: the rendezvous
        assignment over current members), migrating every moved
        range's live sessions. Serialized — one migration wave at a
        time. Returns the number of ranges migrated."""
        with self._migrate_lock:
            if target is None:
                target = self.target_assignment()
            with self._lock:
                current = dict(self._owners)
            moved = moved_ranges(current, target)
            for rid in moved:
                self._migrate(rid, current[rid], target[rid])
            with self._lock:
                self.stats["rebalances"] += 1
            return len(moved)

    def _nat_coldstarts_in_range(self, dp, start: int,
                                 n_buckets: int) -> int:
        """Count the source's live NAT sessions whose flow steers into
        bucket range ``[start, start+n)`` — exactly the flows the new
        owner will have to NAT-re-establish (the migration moves only
        the reflective table). The NAT extras columns carry the full
        PRE-NAT tuple (orig src/dst/ports), so each session's steering
        bucket is recomputed with the same sym canonical mix
        ``buckets_of_packed`` uses — ON DEVICE (``ops.session.
        canon_mix``), reducing to one count; only a scalar crosses the
        transport, vs the seven full natsess columns the first cut
        fetched host-side. The columns are read under the instance's
        ``_lock``: every step writes them in place.
        Tenant-sliced steering (partition with tenant_ids) re-bases
        buckets per tenant; this count uses the unsliced mix and is
        exact for the un-sliced fleets the bench and tests run."""
        from vpp_tpu_torch.ops.session import _age, canon_mix

        with dp._lock:
            tables = dp.tables
            if tables is None:
                return 0
            now = max(dp._now, dp.clock_ticks())
            live = ((tables.natsess_valid.reshape(-1) == 1)
                    & (_age(now, tables.natsess_time.reshape(-1))
                       <= tables.sess_max_age))
            mix = canon_mix(
                tables.natsess_src_ip.reshape(-1),
                tables.natsess_orig_ip.reshape(-1),
                tables.natsess_sport.reshape(-1) & 0xFFFF,
                tables.natsess_orig_port.reshape(-1) & 0xFFFF,
                tables.natsess_proto.reshape(-1) & 0xFF)
            b = mix & (self.n_buckets - 1)
            # transfer-ok: one device-reduced scalar crosses, not the
            # columns
            return int((live & (b >= start)
                        & (b < start + n_buckets)).sum().item())

    def _migrate(self, rid: int, src: str, dst: str) -> None:
        """One range's move: fence → drain → adopt → commit → release.
        Raises through on injected/real faults, leaving the range
        FENCED — conservation holds (steering attributes the drops)
        and :meth:`recover` completes the move."""
        from vpp_tpu_torch.pipeline.snapshot import (
            adopt_bucket_range,
            drain_bucket_range,
            release_bucket_range,
        )

        if dst not in self.instances:
            raise ValueError(f"migration target {dst!r} not a live "
                             f"instance")
        epoch = self.membership.fence_range(rid, dst)
        self._apply_record(rid, {"epoch": epoch, "state": FENCED,
                                 "owner": src, "to": dst})
        start, n = range_span(rid, self.n_buckets, self.n_ranges)
        cols, now_src = drain_bucket_range(self.instances[src],
                                           start, n)
        adopted = adopt_bucket_range(self.instances[dst], cols, start,
                                     now_src)
        coldstarts = self._nat_coldstarts_in_range(
            self.instances[src], start, n)
        faults.fire("fleet.migrate")
        if not self.membership.commit_range(rid, epoch, dst):
            raise RuntimeError(
                f"range {rid} commit superseded (epoch {epoch}) — "
                f"another migrator fenced past us")
        self._apply_record(rid, {"epoch": epoch, "state": SERVING,
                                 "owner": dst, "to": None})
        release_bucket_range(self.instances[src], start, n)
        with self._lock:
            self.stats["migrated_ranges"] += 1
            self.stats["migrated_sessions"] += int(adopted)
            self.stats["nat_coldstarts"] += coldstarts
        log.info("range %d migrated %s -> %s (%d sessions, epoch %d, "
                 "%d nat coldstarts)",
                 rid, src, dst, adopted, epoch, coldstarts)

    def recover(self) -> int:
        """Complete migrations that died mid-move: every FENCED range
        record still names its source (which holds all sessions until
        commit) and its target — re-run drain/adopt against the SAME
        epoch and commit. Idempotent; returns ranges recovered."""
        from vpp_tpu_torch.pipeline.snapshot import (
            adopt_bucket_range,
            drain_bucket_range,
            release_bucket_range,
        )

        done = 0
        with self._migrate_lock:
            for rid, st in sorted(
                    self.membership.fenced_ranges().items()):
                src, dst = st.get("owner"), st.get("to")
                epoch = int(st.get("epoch", 0))
                if dst not in self.instances:
                    log.warning("fenced range %d targets unknown "
                                "instance %r; leaving fenced",
                                rid, dst)
                    continue
                start, n = range_span(rid, self.n_buckets,
                                      self.n_ranges)
                adopted = 0
                coldstarts = 0
                if src in self.instances:
                    cols, now_src = drain_bucket_range(
                        self.instances[src], start, n)
                    adopted = adopt_bucket_range(
                        self.instances[dst], cols, start, now_src)
                    coldstarts = self._nat_coldstarts_in_range(
                        self.instances[src], start, n)
                if not self.membership.commit_range(rid, epoch, dst):
                    log.warning("range %d recovery commit superseded "
                                "(epoch %d)", rid, epoch)
                    continue
                self._apply_record(rid,
                                   {"epoch": epoch, "state": SERVING,
                                    "owner": dst, "to": None})
                if src in self.instances:
                    release_bucket_range(self.instances[src],
                                         start, n)
                with self._lock:
                    self.stats["migrated_ranges"] += 1
                    self.stats["migrated_sessions"] += int(adopted)
                    self.stats["nat_coldstarts"] += coldstarts
                    self.stats["recovered_ranges"] += 1
                done += 1
                log.info("range %d recovered %s -> %s "
                         "(%d sessions, epoch %d)",
                         rid, src, dst, adopted, epoch)
        return done

    # --- observability ----------------------------------------------

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self.stats)
            out["steered"] = dict(self.stats["steered"])
            out["instances"] = len(self.instances)
            out["ranges"] = self.n_ranges
            out["fenced_ranges"] = len(self._fenced)
            out["owners"] = dict(self._owners)
        return out

    def conservation(self) -> Tuple[int, int]:
        """(offered, accounted) at the steering layer — equal unless a
        packet vanished unattributed (the invariant tests assert on)."""
        with self._lock:
            accounted = (sum(self.stats["steered"].values())
                         + self.stats["fenced_drops"]
                         + self.stats["no_owner_drops"])
            return self.stats["offered"], accounted
