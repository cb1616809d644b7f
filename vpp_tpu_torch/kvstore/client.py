"""RemoteKVStore: KVStore-interface client for a KVServer.

Drop-in replacement for ``KVStore`` (duck-typed: ``Broker``, ``KVProxy``,
the node-ID allocator, IPAM persistence and the agent watch bridge all
work unchanged), backed by a TCP connection to ``kvstore.server.KVServer``
— the deployed-etcd analog (reference: etcd DaemonSet
contiv-vpp's k8s/contiv-vpp.yaml:72-114, consumed through cn-infra
kvdbsync clones flavors/contiv/contiv_flavor.go:128-138).

Threading model:
  * caller threads send requests and block on per-request events;
  * one reader thread demultiplexes responses (by id) and watch pushes;
  * one dispatcher thread delivers watch events in arrival (= revision)
    order. Callbacks may freely call back into the store: their requests
    are answered by the reader thread, which never runs callbacks.

Reconnect: on connection loss the client reconnects with capped backoff
and re-registers every watch snapshot-atomically. Each watch's optional
``on_resync(snapshot, rev)`` hook is invoked with the fresh snapshot so
consumers can mark-and-sweep state that changed during the outage — the
reference KSR's reconnect behavior (plugins/ksr/ksr_reflector.go:185-232).
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from vpp_tpu_torch.kvstore.server import decode_event
from vpp_tpu_torch.kvstore.store import WatchCallback
from vpp_tpu_torch.net.backoff import Backoff
from vpp_tpu_torch.testing import faults

log = logging.getLogger("kvclient")

ResyncCallback = Callable[[Dict[str, Any], int], None]

_STOP = object()


class _Watch:
    __slots__ = ("wid", "prefix", "callback", "on_resync", "active")

    def __init__(self, wid: int, prefix: str, callback: WatchCallback,
                 on_resync: Optional[ResyncCallback]):
        self.wid = wid
        self.prefix = prefix
        self.callback = callback
        self.on_resync = on_resync
        self.active = True


class RemoteKVStore:
    def __init__(self, host: str, port: int,
                 request_timeout: float = 10.0,
                 reconnect_timeout: float = 30.0,
                 reconnect_backoff: Tuple[float, float] = (0.1, 2.0),
                 fallbacks: Optional[List[Tuple[str, int]]] = None,
                 on_reconnect_failed: Optional[Callable[[], None]] = None):
        """``fallbacks``: additional (host, port) endpoints tried in
        rotation when the current one is unreachable — the HA client
        side of a primary + standby kvserver pair (the reference simply
        points every agent at the etcd Service VIP; here failover is
        client-side). ``on_reconnect_failed`` fires when a reconnect
        gives up after ``reconnect_timeout`` across ALL endpoints (the
        replicator uses it as its promotion trigger)."""
        self.host = host
        self.port = port
        self.endpoints: List[Tuple[str, int]] = (
            [(host, port)] + list(fallbacks or [])
        )
        self.on_reconnect_failed = on_reconnect_failed
        self.request_timeout = request_timeout
        self.reconnect_timeout = reconnect_timeout
        self.reconnect_backoff = reconnect_backoff

        self._ids = itertools.count(1)
        self._wids = itertools.count(1)
        self._lock = threading.Lock()          # connection + pending state
        self._send_lock = threading.Lock()     # serializes socket writes
        self._sock: Optional[socket.socket] = None
        self._pending: Dict[int, "queue.Queue[Any]"] = {}
        self._watches: Dict[int, _Watch] = {}
        # request-id -> _Watch for in-flight watch registrations whose
        # snapshot must be delivered via on_resync. The READER thread
        # enqueues the resync when it sees the response — before it can
        # read any subsequent event — so snapshot-then-events ordering
        # is guaranteed (caller-side enqueueing raced the event stream).
        self._resync_rids: Dict[int, _Watch] = {}
        self._rotate_start = 0
        self._closed = False
        # degraded-mode surface: when the connection is
        # down the agent keeps serving its last-adopted config epoch;
        # these let the collector/CLI export HOW stale that state may
        # be. _disconnected_at is monotonic-clock, None while
        # connected; _backoff_state snapshots the live reconnect
        # pacer for `show resilience`. Both under _lock.
        self._disconnected_at: Optional[float] = None
        self._backoff_state: Dict[str, Any] = {}
        # HA fencing (kvstore/witness.py): the epoch learned from the
        # connected server, stamped onto every write so a superseded
        # ex-primary can never silently accept state derived from
        # another primary's history. None = server predates fencing.
        self._epoch: Optional[int] = None

        self._events: "queue.Queue[Any]" = queue.Queue()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="kv-dispatch"
        )
        self._dispatcher.start()
        self._reader: Optional[threading.Thread] = None
        self._connect(deadline=time.monotonic() + reconnect_timeout)

    # --- connection management ---
    def _connect(self, deadline: float) -> None:
        base, cap = self.reconnect_backoff
        # one shared pacing policy (vpp_tpu_torch.net.backoff): jittered
        # exponential instead of the old bare doubling, so a fleet of
        # agents reconnecting to a restarted kvserver desynchronizes
        # instead of arriving on the same beat
        bo = Backoff(base, cap)
        attempt = 0
        n = len(self.endpoints)
        while True:
            if self._closed:
                raise ConnectionError("client closed")
            # rotate through endpoints starting at _rotate_start: each
            # backoff round tries the next candidate, so a dead primary
            # fails over to a standby within one round. _rotate_start
            # persists across reconnects — a "not primary" rejection
            # advances it (see _request) so the rotation can move off a
            # live-but-read-only follower, and lands back on index 0
            # (the preferred primary) one step later.
            # _rotate_start is shared with _rotate_endpoint (the request
            # thread advances it off a read-only follower while THIS
            # reconnect thread retries): read and write it under the
            # lock — never held across the blocking connect — so a
            # concurrent advance isn't overwritten and re-tried dead
            with self._lock:
                idx = (self._rotate_start + attempt) % n
            host, port = self.endpoints[idx]
            attempt += 1
            try:
                faults.fire("kv.connect")
                sock = socket.create_connection(
                    (host, port), timeout=self.request_timeout
                )
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self.host, self.port = host, port
                with self._lock:
                    self._rotate_start = idx
                    self._disconnected_at = None
                    self._backoff_state = {}
                break
            except OSError as exc:
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"kvserver unreachable on {self.endpoints}: {exc}"
                    ) from exc
                if attempt % n == 0:
                    delay = bo.next()
                    with self._lock:
                        self._backoff_state = bo.state()
                    time.sleep(delay)
        with self._lock:
            self._sock = sock
            self._reader = threading.Thread(
                target=self._read_loop, args=(sock,), daemon=True,
                name="kv-reader",
            )
            self._reader.start()
        self._refresh_epoch()
        self._reregister_watches()

    def _read_loop(self, sock: socket.socket) -> None:
        buf = b""
        try:
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    msg = json.loads(line)
                    if "watch_id" in msg and "event" in msg:
                        self._events.put(msg)
                    else:
                        rid = msg.get("id")
                        w = self._resync_rids.pop(rid, None)
                        if w is not None and msg.get("ok"):
                            res = msg["result"]
                            self._events.put(
                                ("resync", w, res["snapshot"], res["rev"])
                            )
                        q = self._pending.pop(rid, None)
                        if q is not None:
                            q.put(msg)
        except OSError:
            pass
        finally:
            self._on_disconnect(sock)

    def _on_disconnect(self, sock: socket.socket) -> None:
        with self._lock:
            if self._sock is not sock:
                return  # stale reader from a previous connection
            self._sock = None
            if self._disconnected_at is None:
                self._disconnected_at = time.monotonic()
            pending = list(self._pending.values())
            self._pending.clear()
        for q in pending:
            q.put({"ok": False, "error": "connection lost", "_conn": True})
        if self._closed:
            return
        log.warning("kvserver connection lost; reconnecting")
        threading.Thread(
            target=self._reconnect_loop, daemon=True, name="kv-reconnect"
        ).start()

    def _reconnect_loop(self) -> None:
        try:
            self._connect(deadline=time.monotonic() + self.reconnect_timeout)
            log.info("kvserver reconnected (%s:%d)", self.host, self.port)
        except ConnectionError as exc:
            log.error("kvserver reconnect failed: %s", exc)
            cb = self.on_reconnect_failed
            if cb is not None and not self._closed:
                try:
                    cb()
                except Exception:  # noqa: BLE001 — observer must not kill us
                    log.exception("on_reconnect_failed callback failed")

    def _refresh_epoch(self) -> None:
        """Learn the connected server's fencing epoch. Every (re)connect
        refreshes it — failing over to a freshly promoted primary means
        a bumped epoch, and writes stamped with the old one would be
        rejected as stale forever."""
        try:
            self._epoch = int(self._request("epoch"))
        except RuntimeError:
            self._epoch = None  # pre-fencing server
        except (ConnectionError, TimeoutError):
            pass  # connection already dying; reconnect will retry

    def _reregister_watches(self) -> None:
        with self._lock:
            watches = [w for w in self._watches.values() if w.active]
        for w in watches:
            try:
                self._watch_request(w)
            except (ConnectionError, TimeoutError):
                return  # next reconnect will retry

    def _watch_request(self, w: _Watch) -> Any:
        """Send a watch registration whose snapshot (if the consumer
        wants it) is enqueued by the READER thread, ordered strictly
        before any event of the new watch stream."""
        rid = next(self._ids)
        if w.on_resync is not None:
            self._resync_rids[rid] = w
        try:
            return self._request("watch", _rid=rid,
                                 prefix=w.prefix, watch_id=w.wid)
        finally:
            # normally consumed by the reader; clean up on failure paths
            self._resync_rids.pop(rid, None)

    # --- request plumbing ---
    WRITE_OPS = frozenset(
        {"put", "delete", "cas", "cad",
         "lease_grant", "lease_keepalive", "lease_revoke"}
    )

    def _request(self, op: str, _rid: Optional[int] = None, **kw: Any) -> Any:
        rid = next(self._ids) if _rid is None else _rid
        deadline = time.monotonic() + self.request_timeout
        # per-request retry pacer (replaces the old fixed 50 ms sleeps):
        # jittered so callers retrying through an outage spread out
        retry_bo = Backoff(0.02, 0.25)
        faults.fire("kv.request")
        while True:
            msg = {"id": rid, "op": op, **kw}
            # stamp writes with the fencing epoch (rebuilt every
            # attempt: a retry after an epoch refresh must carry the
            # NEW epoch)
            if op in self.WRITE_OPS and self._epoch is not None:
                msg["fence"] = self._epoch
            data = json.dumps(msg, separators=(",", ":")).encode() + b"\n"
            with self._lock:
                sock = self._sock
                if sock is not None:
                    q: "queue.Queue[Any]" = queue.Queue()
                    self._pending[rid] = q
            if sock is None:
                if self._closed or time.monotonic() >= deadline:
                    raise ConnectionError("kvserver not connected")
                time.sleep(retry_bo.next())
                continue
            try:
                # sendall can be split across multiple send() syscalls;
                # without this lock two caller threads (maintenance loop,
                # watch dispatcher, CNI handlers) could interleave partial
                # writes and corrupt the newline-delimited stream.
                with self._send_lock:
                    faults.fire("kv.send")
                    sock.sendall(data)
            except OSError:
                self._pending.pop(rid, None)
                time.sleep(retry_bo.next())
                continue
            try:
                resp = q.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                self._pending.pop(rid, None)
                raise TimeoutError(f"kvserver request {op!r} timed out")
            if resp.get("_conn"):
                # Connection died mid-request. Mutating ops may or may not
                # have applied; surface that instead of blindly retrying.
                raise ConnectionError("connection lost during request")
            if not resp.get("ok"):
                err = str(resp.get("error"))
                if "stale fencing epoch" in err and \
                        time.monotonic() < deadline:
                    # the server's epoch moved past ours (a promotion we
                    # haven't heard about). The op did NOT apply; learn
                    # the current epoch and retry with it.
                    self._refresh_epoch()
                    continue
                if ("not primary" in err or "superseded" in err) and \
                        len(self.endpoints) > 1 and \
                        time.monotonic() < deadline:
                    # connected to a read-only follower (e.g. the
                    # primary blipped and we failed over before the
                    # standby promoted). The op did NOT apply, so it is
                    # safe to rotate endpoints and retry: advance the
                    # rotation cursor — the next reconnect starts one
                    # past this follower, which wraps back to the
                    # preferred primary — and force the reconnect by
                    # dropping the socket.
                    self._rotate_endpoint()
                    time.sleep(retry_bo.next())
                    continue
                raise RuntimeError(f"kvserver error: {err}")
            return resp.get("result")

    def _rotate_endpoint(self) -> None:
        with self._lock:
            self._rotate_start = (
                (self._rotate_start + 1) % len(self.endpoints)
            )
            sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already dying; the reader's disconnect handles it

    # --- watch event dispatch (single thread, arrival order) ---
    def _dispatch_loop(self) -> None:
        while True:
            item = self._events.get()
            if item is _STOP:
                return
            try:
                if isinstance(item, tuple) and item[0] == "resync":
                    _, w, snapshot, rev = item
                    if w.active and w.on_resync is not None:
                        w.on_resync(snapshot, rev)
                    continue
                w = self._watches.get(item["watch_id"])
                if w is not None and w.active:
                    w.callback(decode_event(item["event"]))
            except Exception:  # noqa: BLE001 — keep dispatching
                log.exception("watch callback raised")

    # --- KVStore interface ---
    @property
    def persist_path(self) -> Optional[str]:
        return None  # durability lives server-side

    @property
    def fencing_epoch(self) -> Optional[int]:
        """The HA fencing epoch this client's writes carry (learned at
        connect, refreshed on failover); None against a pre-fencing
        server or while a refresh is pending. Observability surface —
        `show store` reads it."""
        return self._epoch

    # --- degraded-mode surface ---
    @property
    def connected(self) -> bool:
        with self._lock:
            return self._sock is not None

    @property
    def degraded(self) -> bool:
        """True while the kvstore is unreachable: the agent serves its
        last-adopted epoch and the collector exports
        ``vpp_tpu_degraded{component="kvstore"}``."""
        with self._lock:
            return self._sock is None and not self._closed

    def staleness_s(self) -> float:
        """Seconds the served config may lag the cluster store: 0 while
        connected, else time since the connection was lost (the
        ``vpp_tpu_kvstore_staleness_seconds`` gauge)."""
        with self._lock:
            if self._sock is not None or self._disconnected_at is None:
                return 0.0
            return time.monotonic() - self._disconnected_at

    def backoff_state(self) -> Dict[str, Any]:
        """Live reconnect pacer snapshot (`show resilience`): empty
        while connected."""
        with self._lock:
            return dict(self._backoff_state)

    def get(self, key: str) -> Any:
        return self._request("get", key=key)

    def put(self, key: str, value: Any, lease: Optional[int] = None) -> int:
        if lease is None:
            return self._request("put", key=key, value=value)
        return self._request("put", key=key, value=value, lease=lease)

    # --- leases (node liveness; etcd lease analog) ---
    def lease_grant(self, ttl_s: float) -> int:
        return self._request("lease_grant", ttl=ttl_s)

    def lease_keepalive(self, lease: int) -> bool:
        return bool(self._request("lease_keepalive", lease=lease))

    def lease_revoke(self, lease: int) -> int:
        return self._request("lease_revoke", lease=lease)

    def delete(self, key: str) -> bool:
        return self._request("delete", key=key)

    def compare_and_put(self, key: str, expected: Any, value: Any) -> bool:
        return self._request("cas", key=key, expected=expected, value=value)

    def compare_and_delete(self, key: str, expected: Any) -> bool:
        return self._request("cad", key=key, expected=expected)

    def list_values(self, prefix: str = "") -> Dict[str, Any]:
        return self._request("list", prefix=prefix)

    def list_keys(self, prefix: str = "") -> List[str]:
        return self._request("list_keys", prefix=prefix)

    @property
    def revision(self) -> int:
        return self._request("rev")

    def save(self, path: Optional[str] = None) -> None:
        self._request("save")

    def ping(self) -> bool:
        return self._request("ping") == "pong"

    def watch(self, prefix: str, callback: WatchCallback,
              on_resync: Optional[ResyncCallback] = None
              ) -> Callable[[], None]:
        """``on_resync(snapshot, rev)`` fires on EVERY snapshot-atomic
        registration — the initial one included, then each reconnect —
        so a consumer can mark-and-sweep from the same code path
        whether it is starting fresh or recovering from an outage."""
        wid = next(self._wids)
        w = _Watch(wid, prefix, callback, on_resync)
        with self._lock:
            self._watches[wid] = w
        self._watch_request(w)

        def cancel() -> None:
            w.active = False
            with self._lock:
                self._watches.pop(wid, None)
            try:
                self._request("unwatch", watch_id=wid)
            except (ConnectionError, TimeoutError, RuntimeError):
                pass  # server side is cleaned up on disconnect anyway

        return cancel

    def watch_with_snapshot(
        self, prefix: str, callback: WatchCallback,
        on_resync: Optional[ResyncCallback] = None
    ) -> Tuple[Dict[str, Any], int, Callable[[], None]]:
        """The initial snapshot is the synchronous return value;
        ``on_resync(snapshot, rev)`` fires only on reconnect
        re-registrations — the outage-time churn a live event stream
        cannot replay (the watch() resync contract, minus the initial
        delivery the return value already covers)."""
        wid = next(self._wids)
        w = _Watch(wid, prefix, callback, on_resync)
        with self._lock:
            self._watches[wid] = w
        res = self._request("watch", prefix=prefix, watch_id=wid)

        def cancel() -> None:
            w.active = False
            with self._lock:
                self._watches.pop(wid, None)
            try:
                self._request("unwatch", watch_id=wid)
            except (ConnectionError, TimeoutError, RuntimeError):
                pass

        return res["snapshot"], res["rev"], cancel

    def close(self) -> None:
        self._closed = True
        with self._lock:
            sock = self._sock
            self._sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._events.put(_STOP)


def connect_store(url: Optional[str],
                  persist_path: Optional[str] = None,
                  **kw: Any):
    """Build the configured store backend.

    ``url`` forms:
      * ``None`` / ``""``                 -> in-process KVStore (dev/tests)
      * ``"tcp://host:port"``             -> RemoteKVStore against a KVServer
      * ``"tcp://h1:p1,h2:p2[,...]"``     -> HA pair/list: first endpoint
        preferred, the rest are failover candidates (primary + standby
        kvservers; see kvstore/replica.py)
    """
    if not url:
        from vpp_tpu_torch.kvstore.store import KVStore

        return KVStore(persist_path=persist_path)
    if url.startswith("tcp://"):
        endpoints = []
        for hostport in url[len("tcp://"):].split(","):
            host, _, port = hostport.strip().rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"bad store url: {url!r}")
            endpoints.append((host, int(port)))
        (host, port), fallbacks = endpoints[0], endpoints[1:]
        return RemoteKVStore(host, port, fallbacks=fallbacks, **kw)
    raise ValueError(f"unsupported store url scheme: {url!r}")
