"""contiv-ksr analog: the K8s State Reflector process.

Reference: cmd/contiv-ksr/main.go + flavors/ksr — runs the six
reflectors against the shared data store, exposes per-reflector gauges
and a health endpoint. The K8s API side is a K8sListWatch per type; in
a real cluster that's a kubernetes-client watch, in tests/dev it's the
MockK8sListWatch.

The port's copy of ``vpp_tpu/cmd/ksr_main.py``: ``--kubeconfig`` reads
a live API server through ``ksr/k8s_client.py`` (standard library HTTP),
``--store-url`` shares a ``tcp://`` KV server (``kvstore/client.py``).
The process serves its health and stats pages on every address, so the
deployment's liveness probe, which the kubelet sends to the pod's
address, reaches them; the reference's serve on loopback alone.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Dict, Optional

from vpp_tpu_torch.health.statuscheck import HealthHTTPServer, PluginState, StatusCheck
from vpp_tpu_torch.ksr.reflector import (
    K8sListWatch,
    ReflectorRegistry,
    make_standard_reflectors,
)
from vpp_tpu_torch.kvstore.store import Broker, KVStore
from vpp_tpu_torch.stats.collector import register_ksr_gauges
from vpp_tpu_torch.stats.prometheus import MetricsRegistry, StatsHTTPServer

log = logging.getLogger("vpp_tpu_torch.ksr")


class KsrAgent:
    def __init__(
        self,
        store: Optional[KVStore] = None,
        sources: Optional[Dict[str, K8sListWatch]] = None,
        persist_path: Optional[str] = None,
        store_url: str = "",
        stats_port: int = 9998,
        health_port: int = 9192,
        serve_http: bool = True,
        http_host: str = "127.0.0.1",
    ):
        if store is None:
            from vpp_tpu_torch.kvstore.client import connect_store

            store = connect_store(store_url, persist_path=persist_path)
        self.store = store
        self.broker = Broker(self.store, "ksr/")
        self.sources = sources if sources is not None else {}
        self.registry: ReflectorRegistry = make_standard_reflectors(
            self.broker, self.sources
        )
        self.statuscheck = StatusCheck()
        self._report = self.statuscheck.register("ksr")
        self.statuscheck.register_probe(
            "reflectors", self.registry.all_synced
        )
        self.metrics = MetricsRegistry()
        self.gauges, self.publish_gauges = register_ksr_gauges(
            self.metrics, self.registry
        )
        self.stats_http: Optional[StatsHTTPServer] = None
        self.health_http: Optional[HealthHTTPServer] = None
        self._serve_http = serve_http
        self._stats_port = stats_port
        self._health_port = health_port
        self._http_host = http_host

    def start(self) -> None:
        self.registry.start_all()
        if self._serve_http:
            self.stats_http = StatsHTTPServer(self.metrics,
                                              port=self._stats_port,
                                              host=self._http_host)
            # the KSR leg of config-path span timelines (in a separate
            # KSR process the trace ends at the store write; in-process
            # deployments see the full chain here too)
            from vpp_tpu_torch.trace import spans

            self.stats_http.add_page("/debug/spans", spans.RECORDER.to_json)
            self.stats_http.start()
            self.health_http = HealthHTTPServer(
                self.statuscheck, port=self._health_port,
                host=self._http_host,
            )
            self.health_http.start()
        self._report(
            PluginState.OK if self.registry.all_synced() else PluginState.ERROR
        )

    def close(self) -> None:
        for srv in (self.stats_http, self.health_http):
            if srv is not None:
                srv.close()
        if self.store.persist_path:
            self.store.save()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="vpp-tpu-torch-ksr")
    parser.add_argument("--persist", default=None, help="store snapshot path")
    parser.add_argument(
        "--store-url", default="",
        help="shared store, e.g. tcp://kvstore:12379 ('' = in-process)",
    )
    parser.add_argument(
        "--kubeconfig", default=None,
        help="reflect a real K8s API server (default: no sources)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    sources = None
    if args.kubeconfig:
        from vpp_tpu_torch.ksr.k8s_client import make_k8s_sources

        sources = make_k8s_sources(kubeconfig=args.kubeconfig)
    # the kubelet probes the pod's address: the process serves on every
    # address, where the reference's serves on loopback alone and its
    # deployment's liveness probe can never answer
    agent = KsrAgent(
        persist_path=args.persist, store_url=args.store_url, sources=sources,
        http_host="0.0.0.0",
    )
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    agent.start()
    log.info("ksr up: %d reflectors", len(agent.sources))
    stop.wait()
    agent.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
