"""In-memory etcd-style KV store with prefix watch, CAS and persistence.

Values are JSON-serializable Python objects (the reference stores
protobufs; our data models are dataclasses serialized via their
``to_dict``/``from_dict``). Watch delivery is synchronous and in put()
order — deterministic for tests, matching how the reference's unit tests
feed synthetic datasync events (SURVEY.md §4).

Reference: cn-infra db/keyval + kvdbsync (vendored), used via brokers
with service-label prefixes (flavors/contiv/contiv_flavor.go:128-138).
"""

from __future__ import annotations

import enum
import json
import os
import threading
import time as _time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from vpp_tpu_torch.trace import spans


class Op(enum.Enum):
    PUT = "put"
    DELETE = "delete"


class KVEvent(NamedTuple):
    op: Op
    key: str
    value: Any            # new value (None for DELETE)
    prev_value: Any       # previous value (None if new key)
    rev: int              # store revision at which the change happened


WatchCallback = Callable[[KVEvent], None]


class KVStore:
    """Thread-safe watchable KV store with a global revision counter.

    Watch callbacks run synchronously under the store lock (an RLock, so
    a callback may re-enter the store from the same thread): this is what
    guarantees revision-ordered delivery across threads. Callbacks must
    not block on other threads that touch the store.
    """

    def __init__(self, persist_path: Optional[str] = None):
        self._lock = threading.RLock()
        self._last_save = 0.0
        self._data: Dict[str, Any] = {}
        self._rev = 0
        self._watchers: List[Tuple[str, WatchCallback]] = []
        # leases (etcd-style): lease id -> (deadline, ttl); keys attached
        # to a lease die with it — the node-liveness mechanism
        # (reference: etcd leases; node death must expire its routes)
        self._leases: Dict[int, Tuple[float, float]] = {}
        self._lease_keys: Dict[int, set] = {}
        self._lease_of: Dict[str, int] = {}
        self._next_lease = 1
        # HA fencing epoch (kvstore/witness.py): bumped by a granted
        # witness claim on promotion, stamped onto writes by fenced
        # clients, persisted so a restarted ex-primary still knows the
        # epoch it was superseded at
        self._fence = 0
        self._persist_path = persist_path
        if persist_path and os.path.exists(persist_path):
            self.load(persist_path)

    @property
    def persist_path(self) -> Optional[str]:
        return self._persist_path

    # --- basic ops ---
    def get(self, key: str) -> Any:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, value: Any, lease: Optional[int] = None) -> int:
        with self._lock:
            if lease is not None and lease not in self._leases:
                raise ValueError(f"unknown lease {lease}")
            prev = self._data.get(key)
            self._data[key] = value
            self._attach_lease(key, lease)
            self._rev += 1
            ev = KVEvent(Op.PUT, key, value, prev, self._rev)
            self._notify(ev)
            self._maybe_persist_locked()
        return ev.rev

    def delete(self, key: str) -> bool:
        with self._lock:
            if key not in self._data:
                return False
            prev = self._data.pop(key)
            self._attach_lease(key, None)
            self._rev += 1
            ev = KVEvent(Op.DELETE, key, None, prev, self._rev)
            self._notify(ev)
            self._maybe_persist_locked()
        return True

    def compare_and_put(self, key: str, expected: Any, value: Any) -> bool:
        """Atomic CAS; ``expected=None`` means "key must not exist".

        Reference analog: the ETCD compare-and-put used by the node-ID
        allocator (plugins/contiv/node_id_allocator.go:178).
        """
        with self._lock:
            cur = self._data.get(key)
            if cur != expected:
                return False
            prev = cur
            self._data[key] = value
            self._rev += 1
            ev = KVEvent(Op.PUT, key, value, prev, self._rev)
            self._notify(ev)
            self._maybe_persist_locked()
        return True

    def compare_and_delete(self, key: str, expected: Any) -> bool:
        with self._lock:
            if self._data.get(key) != expected:
                return False
            prev = self._data.pop(key)
            self._rev += 1
            ev = KVEvent(Op.DELETE, key, None, prev, self._rev)
            self._notify(ev)
            self._maybe_persist_locked()
        return True

    def list_values(self, prefix: str) -> Dict[str, Any]:
        with self._lock:
            return {k: v for k, v in self._data.items() if k.startswith(prefix)}

    def list_keys(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rev

    @property
    def fencing_epoch(self) -> int:
        with self._lock:
            return self._fence

    @fencing_epoch.setter
    def fencing_epoch(self, value: int) -> None:
        with self._lock:
            if value < self._fence:
                raise ValueError(
                    f"fencing epoch may only advance ({value} < {self._fence})")
            self._fence = int(value)
            self._maybe_persist_locked()

    # --- watch ---
    def watch(self, prefix: str, callback: WatchCallback) -> Callable[[], None]:
        """Subscribe to changes under a key prefix; returns unsubscribe fn."""
        entry = (prefix, callback)
        with self._lock:
            self._watchers.append(entry)

        def cancel() -> None:
            with self._lock:
                if entry in self._watchers:
                    self._watchers.remove(entry)

        return cancel

    def watch_with_snapshot(
        self, prefix: str, callback: WatchCallback,
        on_resync=None,
    ) -> Tuple[Dict[str, Any], int, Callable[[], None]]:
        """Atomically snapshot ``prefix`` and subscribe to later changes.

        Returns ``(snapshot, rev, cancel)``. No event with rev <= the
        returned rev will be delivered, and every change after it will —
        the list+watch handoff the reference gets from etcd's revisioned
        Watch (plugins/ksr/ksr_reflector.go:185-232 relies on the same
        contract for mark-and-sweep resync). ``on_resync`` exists for
        RemoteKVStore signature parity (reconnect re-registration);
        an in-process store never disconnects, so it never fires.
        """
        with self._lock:
            snapshot = {
                k: v for k, v in self._data.items() if k.startswith(prefix)
            }
            rev = self._rev
            cancel = self.watch(prefix, callback)
        return snapshot, rev, cancel

    def _notify(self, ev: KVEvent) -> None:
        # Called with the lock held; copy so callbacks may (un)subscribe.
        # Watch delivery joins the active config trace (span stage
        # "kvstore") so an applied txn's timeline shows the store hop;
        # un-traced traffic pays only the active() thread-local check.
        traced = spans.active()
        for prefix, cb in list(self._watchers):
            if ev.key.startswith(prefix):
                if traced:
                    with spans.RECORDER.span(
                        "kvstore", f"deliver {ev.key}", op=ev.op.value,
                    ):
                        cb(ev)
                else:
                    cb(ev)

    # --- leases (node-liveness TTL keys; etcd lease analog) ---
    def _attach_lease(self, key: str, lease: Optional[int]) -> None:
        old = self._lease_of.pop(key, None)
        if old is not None:
            self._lease_keys.get(old, set()).discard(key)
        if lease is not None:
            self._lease_of[key] = lease
            self._lease_keys.setdefault(lease, set()).add(key)

    def lease_grant(self, ttl_s: float) -> int:
        """Grant a lease; keys put with it are deleted (with DELETE
        events) unless lease_keepalive arrives within ttl_s."""
        if ttl_s <= 0:
            raise ValueError("ttl must be positive")
        with self._lock:
            lid = self._next_lease
            self._next_lease += 1
            self._leases[lid] = (_time.monotonic() + ttl_s, ttl_s)
            self._lease_keys[lid] = set()
            return lid

    def lease_keepalive(self, lease: int) -> bool:
        with self._lock:
            ent = self._leases.get(lease)
            if ent is None:
                return False
            _, ttl = ent
            self._leases[lease] = (_time.monotonic() + ttl, ttl)
            return True

    def lease_revoke(self, lease: int) -> int:
        """Drop a lease and delete its keys. Returns keys deleted."""
        with self._lock:
            return self._expire_lease_locked(lease)

    def _expire_lease_locked(self, lease: int) -> int:
        if lease not in self._leases:
            return 0
        del self._leases[lease]
        keys = self._lease_keys.pop(lease, set())
        n = 0
        for key in sorted(keys):
            self._lease_of.pop(key, None)
            if key in self._data:
                prev = self._data.pop(key)
                self._rev += 1
                self._notify(KVEvent(Op.DELETE, key, None, prev, self._rev))
                n += 1
        if n:
            self._maybe_persist_locked()
        return n

    def sweep_leases(self, now: Optional[float] = None) -> int:
        """Expire overdue leases; returns the number of keys deleted.
        KVServer runs this on a timer; in-process deployments call it
        from their maintenance loop."""
        now = _time.monotonic() if now is None else now
        with self._lock:
            overdue = [lid for lid, (dl, _) in self._leases.items()
                       if dl <= now]
            return sum(self._expire_lease_locked(lid) for lid in overdue)

    # --- persistence (checkpoint/resume; reference: ETCD durability) ---
    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "rev": self._rev,
                "fence": self._fence,
                "data": dict(self._data),
                "lease_of": dict(self._lease_of),
            }

    def save(self, path: Optional[str] = None) -> None:
        """Crash-safe checkpoint: write-to-temp, fsync the file, atomic
        rename, fsync the directory. A kill -9 mid-save leaves either
        the old snapshot or the new one, never a torn file — and the
        rename itself survives a host crash (the directory entry is on
        disk before save() returns)."""
        path = path or self._persist_path
        if not path:
            return
        with self._lock:
            snapshot = self.dump()
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            dirfd = os.open(os.path.dirname(os.path.abspath(path)),
                            os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
            self._last_save = _time.monotonic()

    def load(self, path: str) -> None:
        with open(path) as f:
            snapshot = json.load(f)
        with self._lock:
            self._data = dict(snapshot["data"])
            self._rev = int(snapshot["rev"])
            self._fence = int(snapshot.get("fence", 0))
            # leases do not survive a restart: their holders must
            # keepalive against the new process, so any persisted
            # lease-attached key (node liveness entries) starts expired
            for key in snapshot.get("lease_of", {}):
                self._data.pop(key, None)
            self._lease_of.clear()
            self._leases.clear()
            self._lease_keys.clear()

    # Autosave is debounced: the file is checkpoint-grade durability (the
    # reference's durable store is external etcd); call save() explicitly
    # for a synchronous checkpoint.
    AUTOSAVE_MIN_INTERVAL = 0.2  # seconds

    def _maybe_persist_locked(self) -> None:
        if self._persist_path and (
            _time.monotonic() - self._last_save >= self.AUTOSAVE_MIN_INTERVAL
        ):
            self.save()


class Broker:
    """A prefix-scoped view of a KVStore (cn-infra broker analog).

    All keys are automatically prefixed with the broker's prefix — the
    equivalent of cn-infra's servicelabel scoping
    (`/vnf-agent/<microservice-label>/`).
    """

    def __init__(self, store: KVStore, prefix: str):
        self.store = store
        self.prefix = prefix

    def _k(self, key: str) -> str:
        return self.prefix + key

    def get(self, key: str) -> Any:
        return self.store.get(self._k(key))

    def put(self, key: str, value: Any) -> int:
        return self.store.put(self._k(key), value)

    def delete(self, key: str) -> bool:
        return self.store.delete(self._k(key))

    def compare_and_put(self, key: str, expected: Any, value: Any) -> bool:
        return self.store.compare_and_put(self._k(key), expected, value)

    def list_values(self, prefix: str = "") -> Dict[str, Any]:
        full = self._k(prefix)
        return {
            k[len(self.prefix):]: v
            for k, v in self.store.list_values(full).items()
        }

    def watch(self, prefix: str, callback: WatchCallback) -> Callable[[], None]:
        full = self._k(prefix)

        def strip(ev: KVEvent) -> None:
            callback(ev._replace(key=ev.key[len(self.prefix):]))

        return self.store.watch(full, strip)

