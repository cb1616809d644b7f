"""KVProxy: a kvstore watch proxy that can skip self-inflicted events.

The agent persists its own configuration (pod configs, vswitch config)
into the same store it watches; without filtering it would react to the
echo of its own writes. A consumer registers one-shot ignore entries
before writing; the matching change event is then swallowed once.

The proxy installs a single store-level watch and dispatches to its own
subscribers: the skip decision is evaluated exactly once per event (not
once per subscriber), and an ignore entry is consumed by the echo even
when no subscriber matches it — so stale entries cannot linger and
swallow a later external change.

Reference: plugins/kvdbproxy (plugin_impl_kvdbproxy.go:26-76).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Tuple

from vpp_tpu_torch.kvstore.store import KVEvent, KVStore, Op, WatchCallback


class KVProxy:
    def __init__(self, store: KVStore):
        self.store = store
        self._lock = threading.Lock()
        self._ignore: List[Tuple[str, Op]] = []
        self._subs: List[Tuple[str, WatchCallback]] = []
        # One underlying watch for all subscribers (see module doc).
        self._cancel_store_watch = store.watch("", self._dispatch)

    def add_ignore_entry(self, key: str, op: Op) -> None:
        """Ignore the next change event matching (key, op) — one shot."""
        with self._lock:
            self._ignore.append((key, op))

    def _dispatch(self, ev: KVEvent) -> None:
        with self._lock:
            entry = (ev.key, ev.op)
            if entry in self._ignore:
                self._ignore.remove(entry)
                return
            subs = list(self._subs)
        for prefix, cb in subs:
            if ev.key.startswith(prefix):
                cb(ev)

    def watch(self, prefix: str, callback: WatchCallback) -> Callable[[], None]:
        entry = (prefix, callback)
        with self._lock:
            self._subs.append(entry)

        def cancel() -> None:
            with self._lock:
                if entry in self._subs:
                    self._subs.remove(entry)

        return cancel

    def close(self) -> None:
        self._cancel_store_watch()

    def _remove_ignore_entry(self, key: str, op: Op) -> None:
        with self._lock:
            entry = (key, op)
            if entry in self._ignore:
                self._ignore.remove(entry)

    # passthrough writes
    def put(self, key: str, value, ignore_echo: bool = True) -> int:
        if ignore_echo:
            self.add_ignore_entry(key, Op.PUT)
        return self.store.put(key, value)

    def delete(self, key: str, ignore_echo: bool = True) -> bool:
        if ignore_echo:
            self.add_ignore_entry(key, Op.DELETE)
        deleted = self.store.delete(key)
        if ignore_echo and not deleted:
            # No event was emitted: reclaim the entry so it cannot swallow
            # a later genuine external DELETE.
            self._remove_ignore_entry(key, Op.DELETE)
        return deleted
