"""Generic reflector engine: K8s watch events → kvstore, with resync.

One Reflector per object type subscribes to a K8s list-watch source,
converts objects to the data models of ``vpp_tpu_torch.ksr.model`` and writes
them under the KSR keyspace. On (re)connect it runs a mark-and-sweep
reconciliation: items present in K8s are added/updated in the store,
stale store items are deleted — so consumers always converge to the true
cluster state even across KSR or store outages.

The K8s source is abstracted behind ``K8sListWatch``; production can use
the kubernetes Python client (gated import), tests use MockK8sListWatch —
the same seam the reference tests use (mock.K8sListWatch,
plugins/ksr/ksr_reflector.go:41-98, markAndSweep :185-232).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from vpp_tpu_torch.ksr import model
from vpp_tpu_torch.kvstore.store import Broker
from vpp_tpu_torch.trace import spans

# Retry backoff bounds for resync attempts, in seconds
# (reference uses 100→1000 ms, ksr_reflector.go:35-38).
logger = logging.getLogger(__name__)

MIN_RESYNC_BACKOFF = 0.1
MAX_RESYNC_BACKOFF = 1.0


class K8sListWatch:
    """Interface to a K8s object source for one resource type."""

    def list(self) -> List[Any]:
        raise NotImplementedError

    def subscribe(self, on_add, on_update, on_delete) -> None:
        raise NotImplementedError


class MockK8sListWatch(K8sListWatch):
    """In-memory K8s source for tests/dev: call add/update/delete to
    simulate cluster changes (reference: mock.K8sListWatch)."""

    def __init__(self):
        self._objects: Dict[str, Any] = {}
        self._handlers = []

    def list(self) -> List[Any]:
        return list(self._objects.values())

    def subscribe(self, on_add, on_update, on_delete) -> None:
        self._handlers.append((on_add, on_update, on_delete))

    # --- simulation API ---
    def add(self, key: str, obj: Any) -> None:
        self._objects[key] = obj
        for on_add, _, _ in self._handlers:
            on_add(obj)

    def update(self, key: str, obj: Any) -> None:
        old = self._objects.get(key)
        self._objects[key] = obj
        for _, on_update, _ in self._handlers:
            on_update(old, obj)

    def delete(self, key: str) -> None:
        obj = self._objects.pop(key, None)
        if obj is not None:
            for _, _, on_delete in self._handlers:
                on_delete(obj)


class ReflectorStats:
    """Per-reflector gauges (reference: ksr_statscollector.go)."""

    def __init__(self):
        self.adds = 0
        self.updates = 0
        self.deletes = 0
        self.resyncs = 0
        self.add_errors = 0
        self.upd_errors = 0
        self.del_errors = 0
        self.arg_errors = 0

    def to_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class Reflector:
    """Reflects one object type into the kvstore. ``converter`` maps a raw
    K8s object to a model instance (or None to skip)."""

    def __init__(
        self,
        obj_type: str,
        broker: Broker,
        list_watch: K8sListWatch,
        converter: Callable[[Any], Optional[Any]],
    ):
        self.obj_type = obj_type
        self.broker = broker
        self.list_watch = list_watch
        self.converter = converter
        self.stats = ReflectorStats()
        self._lock = threading.Lock()
        self._synced = False
        self._paused = False

    # --- lifecycle ---
    def start(self) -> None:
        self.list_watch.subscribe(self._on_add, self._on_update, self._on_delete)
        self.resync()

    def has_synced(self) -> bool:
        with self._lock:
            return self._synced

    def stop_data_store_updates(self) -> None:
        """Deliberately pause store writes (e.g. store outage detected);
        events are suppressed until an explicit resync() reconciles."""
        with self._lock:
            self._synced = False
            self._paused = True

    # --- event handlers ---
    def _key_of(self, m: Any) -> str:
        return m.key()

    def _on_add(self, obj: Any) -> None:
        m = self.converter(obj)
        if m is None:
            self.stats.arg_errors += 1
            return
        with self._lock:
            paused = self._paused
        if paused:
            return
        if not self.has_synced():
            # A failed resync left us unsynced: retry once per incoming
            # event; the mark-and-sweep covers this event's object too.
            self.resync(max_attempts=1)
            return
        with self._lock:
            # root span: this reflector event's wall-clock start is the
            # event timestamp the config-propagation SLO measures from;
            # the store's synchronous watch fan-out parents every
            # downstream stage (kvstore → agent → render → swap) to it
            with spans.RECORDER.span(
                "ksr", f"reflector add {self._key_of(m)}",
                obj_type=self.obj_type,
            ):
                self.broker.put(self._key_of(m), m.to_dict())
            self.stats.adds += 1

    def _on_update(self, old: Any, new: Any) -> None:
        m = self.converter(new)
        if m is None:
            self.stats.arg_errors += 1
            return
        with self._lock:
            paused = self._paused
        if paused:
            return
        if not self.has_synced():
            # A failed resync left us unsynced: retry once per incoming
            # event; the mark-and-sweep covers this event's object too.
            self.resync(max_attempts=1)
            return
        with self._lock:
            prev = self.broker.get(self._key_of(m))
            if prev != m.to_dict():
                with spans.RECORDER.span(
                    "ksr", f"reflector update {self._key_of(m)}",
                    obj_type=self.obj_type,
                ):
                    self.broker.put(self._key_of(m), m.to_dict())
                self.stats.updates += 1

    def _on_delete(self, obj: Any) -> None:
        m = self.converter(obj)
        if m is None:
            self.stats.arg_errors += 1
            return
        with self._lock:
            paused = self._paused
        if paused:
            return
        if not self.has_synced():
            # A failed resync left us unsynced: retry once per incoming
            # event; the mark-and-sweep covers this event's object too.
            self.resync(max_attempts=1)
            return
        with self._lock:
            with spans.RECORDER.span(
                "ksr", f"reflector delete {self._key_of(m)}",
                obj_type=self.obj_type,
            ):
                self.broker.delete(self._key_of(m))
            self.stats.deletes += 1

    # --- resync (mark-and-sweep) ---
    def resync(self, max_attempts: int = 10) -> bool:
        """Reconcile the store with the K8s source, with backoff retries."""
        backoff = MIN_RESYNC_BACKOFF
        for attempt in range(max_attempts):
            try:
                self._mark_and_sweep()
                with self._lock:
                    self._synced = True
                    self._paused = False
                return True
            except Exception:
                logger.exception(
                    "%s reflector resync attempt %d/%d failed",
                    self.obj_type, attempt + 1, max_attempts,
                )
                time.sleep(backoff)
                backoff = min(backoff * 2, MAX_RESYNC_BACKOFF)
        logger.error(
            "%s reflector could not resync after %d attempts; "
            "will retry on the next watch event", self.obj_type, max_attempts,
        )
        return False

    def _mark_and_sweep(self) -> None:
        self.stats.resyncs += 1
        prefix = model.key_prefix(self.obj_type)
        store_items = dict(self.broker.list_values(prefix))
        for obj in self.list_watch.list():
            m = self.converter(obj)
            if m is None:
                continue
            key = self._key_of(m)
            want = m.to_dict()
            if store_items.pop(key, None) != want:
                with spans.RECORDER.span(
                    "ksr", f"resync put {key}", obj_type=self.obj_type,
                ):
                    self.broker.put(key, want)
                self.stats.updates += 1
        for key in store_items:
            with spans.RECORDER.span(
                "ksr", f"resync sweep {key}", obj_type=self.obj_type,
            ):
                self.broker.delete(key)
            self.stats.deletes += 1


class ReflectorRegistry:
    """Holds all reflectors of a KSR process (reference:
    reflector_registry.go)."""

    def __init__(self):
        self.reflectors: Dict[str, Reflector] = {}

    def add(self, r: Reflector) -> None:
        if r.obj_type in self.reflectors:
            raise ValueError(f"duplicate reflector for {r.obj_type}")
        self.reflectors[r.obj_type] = r

    def start_all(self) -> None:
        for r in self.reflectors.values():
            r.start()

    def all_synced(self) -> bool:
        return all(r.has_synced() for r in self.reflectors.values())

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {t: r.stats.to_dict() for t, r in self.reflectors.items()}


def make_standard_reflectors(
    broker: Broker, sources: Dict[str, K8sListWatch]
) -> ReflectorRegistry:
    """Create the six standard reflectors (pod, namespace, policy, service,
    endpoints, node). ``sources`` maps obj type -> list-watch; the
    converter is the identity for already-modelled objects."""
    registry = ReflectorRegistry()
    for obj_type, model_cls in model.MODEL_TYPES.items():
        lw = sources.get(obj_type)
        if lw is None:
            lw = MockK8sListWatch()
            sources[obj_type] = lw

        def converter(obj, _cls=model_cls):
            if isinstance(obj, _cls):
                return obj
            if isinstance(obj, dict):
                try:
                    return _cls.from_dict(obj)
                except Exception:
                    return None
            return None

        registry.add(Reflector(obj_type, broker, lw, converter))
    return registry
