"""KVServer: serve a KVStore over TCP so state spans processes and nodes.

This is the deployment analog of the reference's etcd DaemonSet
(contiv-vpp's k8s/contiv-vpp.yaml:72-114): one served store per
cluster, with every agent/KSR process connecting through
``vpp_tpu_torch.kvstore.client.RemoteKVStore``. The wire protocol is
newline-delimited JSON frames:

  request   {"id": N, "op": "...", ...}        -> {"id": N, "ok": true, "result": ...}
  watch push                                     {"watch_id": W, "event": {...}}

Watch registration is snapshot-atomic (``KVStore.watch_with_snapshot``):
the client receives the current state under the prefix plus the store
revision, then a gapless event stream — the etcd revisioned list+watch
contract the reference's kvdbsync resync logic depends on
(flavors/contiv/contiv_flavor.go:128-138).

Store watch callbacks run under the store lock, so events are only
*enqueued* there; a per-connection writer thread drains the queue to the
socket. A slow or dead client therefore never blocks writers.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import socketserver
import threading
import time
from typing import Any, Callable, Dict, Optional

from vpp_tpu_torch.kvstore.store import KVEvent, KVStore, Op
from vpp_tpu_torch.stats.prometheus import Histogram

log = logging.getLogger("kvserver")

_SENTINEL = object()

# served-request latencies are dominated by the in-memory store ops +
# JSON framing: micro- to low-millisecond regime
KV_REQUEST_BUCKETS = (
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.05, 0.25, 1.0,
)


def make_request_histogram() -> Histogram:
    """The kvstore request-latency family (factored out so the metrics
    lint can validate it without binding a server socket)."""
    return Histogram(
        "vpp_tpu_kvstore_request_seconds",
        "kvstore server request handling latency by op",
        buckets=KV_REQUEST_BUCKETS,
    )


def encode_event(ev: KVEvent) -> Dict[str, Any]:
    return {
        "op": ev.op.value,
        "key": ev.key,
        "value": ev.value,
        "prev_value": ev.prev_value,
        "rev": ev.rev,
    }


def decode_event(d: Dict[str, Any]) -> KVEvent:
    return KVEvent(
        Op(d["op"]), d["key"], d.get("value"), d.get("prev_value"), d["rev"]
    )


class _Conn(socketserver.BaseRequestHandler):
    """One client connection: request loop + watch push queue."""

    def setup(self) -> None:
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.server.live_conns.add(self.request)  # type: ignore[attr-defined]
        self._out: "queue.Queue[Any]" = queue.Queue()
        self._watch_cancels: Dict[int, Callable[[], None]] = {}
        self._writer = threading.Thread(target=self._drain, daemon=True)
        self._writer.start()

    def _drain(self) -> None:
        while True:
            item = self._out.get()
            if item is _SENTINEL:
                return
            try:
                self.request.sendall(
                    json.dumps(item, separators=(",", ":")).encode() + b"\n"
                )
            except OSError:
                return

    def _send(self, obj: Dict[str, Any]) -> None:
        self._out.put(obj)

    def handle(self) -> None:
        store: KVStore = self.server.store  # type: ignore[attr-defined]
        buf = b""
        while True:
            try:
                chunk = self.request.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    self._send({"id": None, "ok": False, "error": "bad json"})
                    continue
                self._handle_req(store, req)

    WRITE_OPS = frozenset(
        {"put", "delete", "cas", "cad",
         "lease_grant", "lease_keepalive", "lease_revoke"}
    )
    READ_OPS = frozenset(
        {"get", "list", "list_keys", "rev", "save", "watch", "unwatch",
         "ping", "epoch"}
    )

    def _handle_req(self, store: KVStore, req: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        try:
            self._handle_req_inner(store, req)
        finally:
            hist = getattr(self.server, "request_hist", None)
            if hist is not None:
                op = req.get("op")
                # clamp the label to the known op vocabulary: a
                # misbehaving client must not mint unbounded label
                # cardinality (or crash the handler with an unhashable
                # op) out of garbage request fields
                if not isinstance(op, str) or (
                        op not in self.WRITE_OPS and op not in self.READ_OPS):
                    op = "other"
                hist.observe(time.perf_counter() - t0, op=op)

    def _handle_req_inner(self, store: KVStore, req: Dict[str, Any]) -> None:
        rid = req.get("id")
        op = req.get("op")
        try:
            if op in self.WRITE_OPS and \
                    self.server.read_only:  # type: ignore[attr-defined]
                raise PermissionError(
                    "not primary: this kvserver is a read-only follower"
                )
            if op in self.WRITE_OPS and req.get("fence") is not None:
                fence, epoch = int(req["fence"]), store.fencing_epoch
                if fence > epoch:
                    # the client has seen a NEWER primary than us: we
                    # are a superseded ex-primary that hasn't heard yet.
                    # Demote on the spot — the in-band beacon that
                    # closes the sub-ttl window between a standby's
                    # granted claim and our own guard noticing
                    # (kvstore/witness.py module docs). The generation
                    # bump first: the PrimaryGuard clears a demotion
                    # only when no demotion landed since its renew RPC
                    # began, so this one is never undone by a renew
                    # response that predates it.
                    with self.server.demote_lock:  # type: ignore[attr-defined]
                        self.server.demotions += 1  # type: ignore[attr-defined]
                        self.server.read_only = True  # type: ignore[attr-defined]
                    log.error("write carried fencing epoch %d > ours %d "
                              "— superseded, demoting to read-only",
                              fence, epoch)
                    raise PermissionError(
                        f"superseded: fencing epoch {fence} > {epoch}")
                if fence < epoch:
                    raise PermissionError(
                        f"stale fencing epoch {fence} != {epoch}")
            if op == "get":
                res = store.get(req["key"])
            elif op == "put":
                res = store.put(req["key"], req.get("value"),
                                lease=req.get("lease"))
            elif op == "delete":
                res = store.delete(req["key"])
            elif op == "cas":
                res = store.compare_and_put(
                    req["key"], req.get("expected"), req.get("value")
                )
            elif op == "cad":
                res = store.compare_and_delete(req["key"], req.get("expected"))
            elif op == "list":
                res = store.list_values(req.get("prefix", ""))
            elif op == "list_keys":
                res = store.list_keys(req.get("prefix", ""))
            elif op == "rev":
                res = store.revision
            elif op == "save":
                store.save()
                res = True
            elif op == "watch":
                wid = int(req["watch_id"])
                # Re-registration of a live wid (client retry racing a
                # reconnect) must not leak the old store watch or the
                # client would see every event twice.
                stale = self._watch_cancels.pop(wid, None)
                if stale:
                    stale()

                def push(ev: KVEvent, _wid: int = wid) -> None:
                    # Runs under the store lock: enqueue only.
                    self._send({"watch_id": _wid, "event": encode_event(ev)})

                snapshot, rev, cancel = store.watch_with_snapshot(
                    req.get("prefix", ""), push
                )
                self._watch_cancels[wid] = cancel
                res = {"snapshot": snapshot, "rev": rev}
            elif op == "unwatch":
                cancel = self._watch_cancels.pop(int(req["watch_id"]), None)
                if cancel:
                    cancel()
                res = True
            elif op == "lease_grant":
                res = store.lease_grant(float(req["ttl"]))
            elif op == "lease_keepalive":
                res = store.lease_keepalive(int(req["lease"]))
            elif op == "lease_revoke":
                res = store.lease_revoke(int(req["lease"]))
            elif op == "ping":
                res = "pong"
            elif op == "epoch":
                res = store.fencing_epoch
            else:
                raise ValueError(f"unknown op: {op!r}")
        except Exception as exc:  # noqa: BLE001 — protocol boundary
            self._send({"id": rid, "ok": False, "error": str(exc)})
            return
        self._send({"id": rid, "ok": True, "result": res})

    def finish(self) -> None:
        self.server.live_conns.discard(self.request)  # type: ignore[attr-defined]
        for cancel in self._watch_cancels.values():
            cancel()
        self._watch_cancels.clear()
        self._out.put(_SENTINEL)


class KVServer:
    """Threaded TCP front-end for a KVStore (etcd-deployment analog)."""

    def __init__(self, store: Optional[KVStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        self.store = store or KVStore(persist_path=persist_path)
        # request latency distribution (vpp_tpu_kvstore_request_seconds,
        # labelled by op); served over HTTP by vpp-tpu-torch-kvstore
        # --stats-port, readable in-process either way
        self.request_hist = make_request_histogram()

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Conn)
        self._server.store = self.store  # type: ignore[attr-defined]
        self._server.live_conns = set()  # type: ignore[attr-defined]
        self._server.read_only = False  # type: ignore[attr-defined]
        # monotone count of in-band demotions (fence > epoch writes):
        # the PrimaryGuard snapshots it around each renew RPC so a
        # demotion that lands mid-RPC is never cleared by the (stale)
        # successful response. demote_lock makes increment+demote and
        # the guard's check+clear mutually atomic — without it a
        # demotion interleaving between the guard's generation check
        # and its read_only=False assignment would be silently undone.
        self._server.demotions = 0  # type: ignore[attr-defined]
        self._server.demote_lock = threading.Lock()  # type: ignore[attr-defined]
        self._server.request_hist = self.request_hist  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._sweep_stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep_loop, daemon=True, name="kvserver-leases"
        )

    # lease sweep cadence: fine-grained enough that a node-liveness TTL
    # of a few seconds expires promptly (etcd's lease granularity is 1 s)
    LEASE_SWEEP_INTERVAL = 0.5

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self.LEASE_SWEEP_INTERVAL):
            try:
                n = self.store.sweep_leases()
                if n:
                    log.info("lease sweep expired %d keys", n)
            except Exception:  # noqa: BLE001 — keep sweeping
                log.exception("lease sweep failed")

    @property
    def epoch(self) -> int:
        """The served store's HA fencing epoch (kvstore/witness.py)."""
        return self.store.fencing_epoch

    @property
    def read_only(self) -> bool:
        return self._server.read_only  # type: ignore[attr-defined]

    @read_only.setter
    def read_only(self, value: bool) -> None:
        self._server.read_only = bool(value)  # type: ignore[attr-defined]

    @property
    def demotions(self) -> int:
        """In-band demotion generation (see __init__)."""
        return self._server.demotions  # type: ignore[attr-defined]

    @property
    def demote_lock(self):
        """Lock making demotion increments and the PrimaryGuard's
        generation-checked clear mutually atomic (see __init__)."""
        return self._server.demote_lock  # type: ignore[attr-defined]

    @property
    def address(self) -> tuple:
        return self._server.server_address

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "KVServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="kvserver-accept",
        )
        self._thread.start()
        self._sweeper.start()
        log.info("kvserver listening on %s:%d", *self._server.server_address)
        return self

    def serve_forever(self) -> None:
        log.info("kvserver listening on %s:%d", *self._server.server_address)
        self._sweeper.start()
        self._server.serve_forever()

    def close(self) -> None:
        self._sweep_stop.set()
        self._server.shutdown()
        self._server.server_close()
        # Established connections outlive shutdown() in socketserver; a
        # "stopped" server must actually disconnect its clients so their
        # reconnect/resync logic engages.
        for conn in list(self._server.live_conns):  # type: ignore[attr-defined]
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self.store.persist_path:
            self.store.save()
