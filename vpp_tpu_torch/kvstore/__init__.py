"""Watchable key-value store: the control-plane data backbone.

Reference analog: ETCD + cn-infra's kvdbsync (watch/resync semantics,
per-consumer key prefixes) — SURVEY.md §5.8(a). The store is in-memory
with optional JSON file persistence (the durable-store role ETCD plays in
the reference: checkpoint/resume = reload + watchers replay state).
"""

from vpp_tpu_torch.kvstore.store import Broker, KVEvent, KVStore, Op
from vpp_tpu_torch.kvstore.proxy import KVProxy
from vpp_tpu_torch.kvstore.client import RemoteKVStore, connect_store

__all__ = ["Broker", "KVEvent", "KVStore", "Op", "KVProxy", "RemoteKVStore",
           "connect_store"]
