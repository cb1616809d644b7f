"""Warm-standby replication for the cluster kvstore.

The reference deploys etcd as a single-replica Deployment and leans on
Kubernetes to reschedule it (contiv-vpp's k8s/contiv-vpp.yaml:72-114)
— state survives via the host-path data dir, but the store is down until
the pod returns. This module gives the custom KVServer a hotter story:

  * a **follower** kvserver runs with ``Replicator`` attached: it
    list+watches EVERYTHING on the primary (the same snapshot-atomic
    contract the agents use) and applies the stream to its local store,
    staying a live, consistent, queryable copy;
  * while following, the server is **read-only** — writes answer
    "not primary" so a partitioned client can't fork history;
  * if the primary stays unreachable past ``promote_after`` seconds,
    the follower **promotes**: replication stops, the server turns
    writable, and clients configured with both endpoints
    (``tcp://primary:p,standby:p`` — see client.connect_store) fail
    over and resume.

Lease state is intentionally NOT replicated: lease-backed keys (node
liveness) arrive as plain keys. After a promotion every agent's
keepalive loop finds its lease unknown, re-grants against the new
primary, and re-puts its liveness key — the same self-healing path as
an etcd compaction of lease state.

Split-brain safety: with a ``witness`` configured (kvstore/witness.py —
the 2-replicas + arbiter quorum construction standing in for the raft
quorum the reference gets from etcd, k8s/contiv-vpp.yaml:72-114),
promotion is CLAIM-ARBITRATED: the standby turns writable only when the
witness grants its claim, which happens only after the primary's
witness lease expired — and the primary's PrimaryGuard self-demotes to
read-only strictly before that lease can expire. Any both-alive
partition therefore yields **exactly one writable store**, and the
granted claim carries a bumped fencing epoch that every client stamps
onto its writes, so a superseded ex-primary rejects (and is demoted
by) state from the new history. A denied claim is retried: the standby
keeps probing the primary, resumes following when the link heals, and
promotes the moment the witness agrees — no operator action.

Without a witness the legacy timer promotion applies (standalone
dev/test pairs); deployments that care about partitions run the
three-process form (docs/DEPLOYMENT.md).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from vpp_tpu_torch.kvstore.client import RemoteKVStore
from vpp_tpu_torch.kvstore.store import KVEvent, KVStore, Op
from vpp_tpu_torch.kvstore.witness import WitnessClient, WitnessUnreachable
from vpp_tpu_torch.net.backoff import Backoff

log = logging.getLogger("kvreplica")


class Replicator:
    def __init__(self, store: KVStore, primary_host: str, primary_port: int,
                 promote_after: float = 10.0,
                 on_promote: Optional[Callable[[], None]] = None,
                 grace_prefixes: tuple = (),
                 grace_ttl_s: float = 30.0,
                 witness: Optional[str] = None,
                 self_addr: str = "",
                 claim_ttl: float = 6.0):
        """``grace_prefixes``: key prefixes whose entries were
        lease-attached on the primary (leases don't replicate — the
        keys arrive plain). At promotion each such key gets a fresh
        ``grace_ttl_s`` lease: live owners re-grant and re-publish on
        their next keepalive (their old lease id is unknown here), dead
        owners' keys expire after the grace instead of lingering
        forever.

        ``witness``: "host:port" of the QuorumWitness. When set,
        promotion requires a granted claim (module docs) and
        ``self_addr`` must be this server's client-reachable address —
        the witness records it as the new primary identity, and the
        demoted ex-primary's operator can read it from witness status.
        ``claim_ttl`` must match the PrimaryGuard ttl of the primary.
        After a granted claim ``self.epoch`` holds the bumped fencing
        epoch (also already applied to ``store.fencing_epoch``)."""
        self.store = store
        self.primary = (primary_host, primary_port)
        self.promote_after = promote_after
        self.on_promote = on_promote
        self.grace_prefixes = tuple(grace_prefixes)
        self.grace_ttl_s = grace_ttl_s
        self.witness = witness
        self._witness_client = (
            WitnessClient(witness) if witness else None)
        self.self_addr = self_addr
        self.claim_ttl = claim_ttl
        self.epoch: Optional[int] = None
        # set once promotion has COMPLETED (epoch applied, grace leases
        # granted, on_promote run) — waiters see a fully writable store
        self.promoted = threading.Event()
        self._promoting = False              # winner-picks mutex flag
        self.synced = threading.Event()      # first snapshot applied
        self._client: Optional[RemoteKVStore] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()    # operator stop ≠ promotion
        self._lock = threading.Lock()
        self._retrying = False
        # denied-claim count (witness reachable, lease alive) — the
        # event tests gate on instead of wall-clock sleeps
        self.claim_denials = 0

    # --- lifecycle ---
    def start(self) -> "Replicator":
        """Connect to the primary and begin streaming. Blocks until the
        initial snapshot is applied (a follower that serves before its
        first sync would hand out empty state).

        A primary already unreachable at startup — the correlated-
        failure case: standby restarted during the primary's outage —
        promotes after ``promote_after`` instead of raising: with a
        persisted local replica this process may be the only surviving
        copy of the cluster state, and crash-looping here would keep
        the kvstore down until an operator stepped in."""
        try:
            self._client = RemoteKVStore(
                *self.primary,
                request_timeout=max(2.0, min(10.0, self.promote_after)),
                reconnect_timeout=self.promote_after,
                on_reconnect_failed=self._promote,
            )
        except ConnectionError:
            # ONLY the initial connect promotes directly: it already
            # waited promote_after across the reconnect deadline. A
            # failure after a successful connect must NOT short-circuit
            # the promote window (a primary mid-restart would fork).
            self._promote()
            return self
        try:
            self._client.watch("", self._apply_event,
                               on_resync=self._apply_snapshot)
        except (ConnectionError, TimeoutError, RuntimeError):
            # connection dropped right after connecting: the client's
            # reconnect loop re-registers the watch or, after
            # promote_after of failures, fires on_reconnect_failed
            log.warning("watch registration interrupted; relying on "
                        "reconnect/promote machinery")
        self._start_heartbeat()
        deadline = time.monotonic() + max(30.0, self.promote_after * 3)
        while not self.synced.wait(timeout=0.2):
            if self.promoted.is_set():
                return self
            with self._lock:
                retrying = self._retrying
            if retrying:
                # witness denied the claim AND the primary is
                # unreachable: limbo. Serve the local (persisted)
                # replica read-only instead of blocking boot; the
                # retry loop resumes following or promotes later.
                log.warning("starting in read-only limbo: primary "
                            "unreachable, witness lease still held")
                return self
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "initial sync from primary did not complete"
                )
        log.info("following primary %s:%d (%d keys)",
                 *self.primary, len(self.store.list_keys("")))
        return self

    def _heartbeat_loop(self) -> None:
        """Detect SILENT primary death (power loss, partition — no FIN,
        so the replication socket just blocks forever): ping the
        primary on its own request path; promote once promote_after
        passes without a successful round trip. TCP disconnects are
        still caught faster by on_reconnect_failed."""
        last_ok = time.monotonic()
        interval = max(0.2, self.promote_after / 4.0)
        while not self.promoted.is_set():
            c = self._client
            if c is None:
                return  # stopped
            try:
                c.ping()
                last_ok = time.monotonic()
            except Exception:  # noqa: BLE001 — any failure counts
                if self._stopped.is_set():
                    return  # operator stop, not a dead primary
                if time.monotonic() - last_ok > self.promote_after:
                    self._promote()
                    return
            if self.promoted.wait(timeout=interval):
                return

    def stop(self) -> None:
        # an operator stop must never look like a dead primary to the
        # heartbeat (the close makes its next ping raise)
        self._stopped.set()
        c = self._client
        self._client = None
        if c is not None:
            c.close()

    # --- replication ---
    def _apply_snapshot(self, snapshot: Dict[str, Any], rev: int) -> None:
        """Mark-and-sweep the local store to the primary's snapshot
        (first sync + every reconnect: deletions during an outage must
        not survive here)."""
        with self._lock:
            for key, value in snapshot.items():
                if self.store.get(key) != value:
                    self.store.put(key, value)
            for key in self.store.list_keys(""):
                if key not in snapshot:
                    self.store.delete(key)
        log.info("resynced from primary: %d keys @ rev %d",
                 len(snapshot), rev)
        self.synced.set()

    def _apply_event(self, ev: KVEvent) -> None:
        with self._lock:
            if ev.op is Op.PUT:
                self.store.put(ev.key, ev.value)
            elif ev.op is Op.DELETE:
                self.store.delete(ev.key)

    # --- failover ---
    def _promote(self) -> None:
        if self.promoted.is_set() or self._stopped.is_set():
            return
        if self._witness_client is not None:
            granted, epoch = self._try_claim()
            if not granted:
                # the witness would not arbitrate in our favour (the
                # primary's lease is alive — a standby-side partition —
                # or the witness is unreachable, meaning WE may be the
                # isolated one). Never promote unfenced; keep retrying
                # and resume following if the primary comes back.
                self._start_retry()
                return
            self._finish_promote(epoch)
        else:
            self._finish_promote(None)

    def _try_claim(self):
        try:
            rsp = self._witness_client.claim(self.self_addr, self.claim_ttl)
        except WitnessUnreachable as exc:
            log.warning("cannot promote: witness unreachable (%s)", exc)
            return False, None
        if rsp.get("granted"):
            return True, int(rsp["epoch"])
        with self._lock:
            self.claim_denials += 1
        log.warning(
            "claim denied: %s still holds the lease (%.1fs left) — "
            "primary is alive on the other side of a partition, "
            "NOT promoting", rsp.get("primary"),
            float(rsp.get("remaining", -1.0)))
        return False, None

    def _start_retry(self) -> None:
        with self._lock:
            if self._retrying:
                return
            self._retrying = True
        threading.Thread(target=self._retry_loop, daemon=True,
                         name="kv-replica-retry").start()

    def _retry_loop(self) -> None:
        """A standby whose claim was denied is in limbo: primary
        unreachable, witness says it's alive. Alternate between probing
        the primary (resume following the moment the partition heals)
        and re-claiming (promote the moment the witness-side lease
        lapses — i.e. the primary really died). Paced by the shared
        jittered backoff (vpp_tpu_torch.net.backoff) instead of the old fixed
        half-interval: after a two-sided partition heals, N limbo
        standbys re-claim spread out rather than storming the witness
        on one beat. The cap stays at the OLD fixed interval
        (promote_after/2), so the worst-case gap between claim
        attempts — and with it the write-unavailability window after
        a real primary death — never regresses past the pre-backoff
        cadence; the jitter only spreads attempts below it."""
        bo = Backoff(base=max(0.25, self.promote_after / 8.0),
                     cap=max(0.5, self.promote_after / 2.0))
        try:
            while not (self.promoted.is_set() or self._stopped.is_set()):
                # claim first — it answers in one witness round trip,
                # so a real primary death promotes promptly; a refollow
                # attempt against a down primary blocks for its whole
                # connect deadline
                granted, epoch = self._try_claim()
                if granted:
                    self._finish_promote(epoch)
                    return
                # then probe with a FRESH client (_try_refollow): the
                # old one has usually given up reconnecting (that's what
                # fired _promote), and pinging a dead client would stall
                # each iteration for its full request timeout. Refollow
                # closes the old client, so a silently-hung-then-healed
                # stream can't double-apply events either.
                if self._try_refollow():
                    return
                if self._stopped.wait(timeout=bo.next()):
                    return
        finally:
            with self._lock:
                self._retrying = False

    def _try_refollow(self) -> bool:
        """Rebuild the replication stream against a primary that is
        reachable again (the old client gave up after its reconnect
        deadline and won't retry)."""
        old = self._client
        try:
            client = RemoteKVStore(
                *self.primary,
                request_timeout=max(2.0, min(10.0, self.promote_after)),
                reconnect_timeout=self.promote_after,
                on_reconnect_failed=self._promote,
            )
        except ConnectionError:
            return False
        try:
            # a half-open path (a partitioned middlebox accepting and
            # resetting) lets the TCP connect succeed while no request
            # can complete — a round trip is the real reachability test
            client.ping()
        except Exception:  # noqa: BLE001 — not actually reachable
            client.close()
            return False
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._client = client
        try:
            client.watch("", self._apply_event,
                         on_resync=self._apply_snapshot)
        except (ConnectionError, TimeoutError, RuntimeError):
            pass  # the client's reconnect machinery re-registers
        self._start_heartbeat()
        log.info("primary %s:%d reachable again — resumed following",
                 *self.primary)
        return True

    def _start_heartbeat(self) -> None:
        # one heartbeat loop per replica: a refollow swaps _client and
        # the LIVE loop pings the new client on its next iteration, so
        # starting another would accumulate a thread per refollow cycle
        # on a flapping primary link — each independently able to fire
        # _promote (ADVICE r5)
        t = self._heartbeat_thread
        if t is not None and t.is_alive():
            return
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="kv-replica-hb"
        )
        self._heartbeat_thread.start()

    def _finish_promote(self, epoch: Optional[int]) -> None:
        # heartbeat and retry threads can race here; exactly one wins
        with self._lock:
            if self._promoting:
                return
            self._promoting = True
        if epoch is not None:
            # epoch FIRST: by the time the server flips writable
            # (on_promote), every accepted write is already stamped
            # into the new history
            self.store.fencing_epoch = epoch
            self.epoch = epoch
        log.warning(
            "primary %s:%d unreachable for %.0fs — promoting to primary"
            "%s", *self.primary, self.promote_after,
            f" @ fencing epoch {epoch}" if epoch is not None else
            " (UNFENCED: no witness configured)",
        )
        self.stop()
        for prefix in self.grace_prefixes:
            for key, value in self.store.list_values(prefix).items():
                lease = self.store.lease_grant(self.grace_ttl_s)
                self.store.put(key, value, lease=lease)
        cb = self.on_promote
        if cb is not None:
            cb()
        self.promoted.set()


class HaCoordinator:
    """Keeps one kvserver's HA role current for its whole lifetime.

    The reference's etcd members never change role — raft does it
    inside the store (contiv-vpp's k8s/contiv-vpp.yaml:72-114). Our
    pair swaps roles across failovers, and this object owns the swap so
    neither the binary (cmd/kvserver.py) nor an operator has to:

      * start as primary: guarded by PrimaryGuard (witness-fenced);
        when SUPERSEDED (a standby's claim won), automatically
        re-follow the new primary as the warm standby — the pair heals
        back to primary+standby with no operator action;
      * start as standby (``follow=addr``): replicate; a witness-granted
        claim promotes and starts the guard, after which a later
        supersession re-follows again, and so on.

    Without a witness the legacy timer promotion applies and a demoted
    ex-primary cannot be detected (nothing demotes it) — dev pairs only.
    """

    def __init__(self, server, witness: Optional[str], advertise: str,
                 fence_ttl: float = 6.0, promote_after: float = 10.0,
                 follow: Optional[str] = None,
                 grace_prefixes: tuple = ()):
        self.server = server
        self.witness = witness
        self.advertise = advertise
        self.fence_ttl = fence_ttl
        self.promote_after = promote_after
        self.follow = follow
        self.grace_prefixes = tuple(grace_prefixes)
        self.guard = None
        self.replicator: Optional[Replicator] = None
        self._stopped = threading.Event()
        self._lock = threading.Lock()

    def start(self) -> "HaCoordinator":
        if self.follow:
            self._become_standby(self.follow)
        else:
            self._become_primary()
        return self

    # --- role transitions ---
    def _become_primary(self) -> None:
        if self.witness is None:
            self.server.read_only = False
            return
        from vpp_tpu_torch.kvstore.witness import PrimaryGuard

        self.server.read_only = False
        with self._lock:
            self.guard = PrimaryGuard(
                self.server, self.witness, self.advertise,
                ttl=self.fence_ttl, on_demote=self._on_superseded,
            ).start()

    def _on_superseded(self, rsp: dict) -> None:
        """Guard callback (guard thread): a standby's claim won. Heal
        the pair by re-following the winner as the new warm standby."""
        new_primary = rsp.get("primary")
        if self._stopped.is_set() or not new_primary \
                or new_primary == self.advertise:
            return
        # the guard thread must not block on a full resync; hand off
        threading.Thread(target=self._become_standby,
                         args=(new_primary,), daemon=True,
                         name="kv-ha-refollow").start()

    def _become_standby(self, primary_addr: str) -> None:
        host, _, port = primary_addr.rpartition(":")
        self.server.read_only = True
        with self._lock:
            old = self.replicator
        if old is not None:
            old.stop()
        try:
            repl = Replicator(
                self.server.store, host, int(port),
                promote_after=self.promote_after,
                on_promote=self._become_primary,
                grace_prefixes=self.grace_prefixes,
                witness=self.witness,
                self_addr=self.advertise,
                claim_ttl=self.fence_ttl,
            )
            with self._lock:
                if self._stopped.is_set():
                    return
                self.replicator = repl
            repl.start()
            log.info("now the warm standby of %s", primary_addr)
        except (ConnectionError, TimeoutError) as exc:
            # stay read-only; the primary we were told to follow is
            # itself unreachable — Replicator's own retry/claim
            # machinery (started inside start()) keeps working at it
            log.error("re-follow of %s incomplete: %s", primary_addr, exc)

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            guard, repl = self.guard, self.replicator
        if guard is not None:
            guard.stop()
        if repl is not None:
            repl.stop()
