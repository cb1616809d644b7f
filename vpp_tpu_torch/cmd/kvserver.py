"""vpp-tpu-torch-kvstore: the cluster-shared data store daemon (the
port's copy of ``vpp_tpu/cmd/kvserver.py``; either package's clients
speak to it).

Deployment analog of the reference's etcd DaemonSet
(contiv-vpp's k8s/contiv-vpp.yaml:72-114): a single served KVStore
that every KSR and agent process connects to via
``tcp://host:port`` store URLs, with file-snapshot durability standing
in for etcd's WAL.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from vpp_tpu_torch.kvstore.server import KVServer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vpp-tpu-torch-kvstore", description="vpp-tpu kvstore server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=12379)
    parser.add_argument("--persist", default=None,
                        help="snapshot file for durability")
    parser.add_argument("--port-file", default=None,
                        help="write the bound port here once listening "
                             "(--port 0 support: tests, supervisors)")
    parser.add_argument("--follow", default=None, metavar="HOST:PORT",
                        help="run as a warm-standby follower of this "
                             "primary kvserver: replicate continuously, "
                             "serve reads only, self-promote when the "
                             "primary stays unreachable (kvstore HA)")
    parser.add_argument("--promote-after", type=float, default=10.0,
                        help="seconds of primary unreachability before a "
                             "follower promotes itself to primary")
    parser.add_argument("--witness", default=None, metavar="HOST:PORT",
                        help="QuorumWitness address (vpp-tpu-torch-kvwitness). "
                             "Primary role: renew authority there and "
                             "self-demote when it can't. Follower role: "
                             "promote only on a granted claim. This is "
                             "what makes a both-alive partition yield "
                             "exactly one writable store")
    parser.add_argument("--advertise", default=None, metavar="HOST:PORT",
                        help="this server's client-reachable address, "
                             "recorded at the witness as the primary "
                             "identity (default host:port, required "
                             "explicitly when --host is a wildcard)")
    parser.add_argument("--fence-ttl", type=float, default=6.0,
                        help="witness lease ttl: primary renews every "
                             "ttl/6, self-demotes after 0.7*ttl unproven; "
                             "a standby claim is grantable after ttl")
    parser.add_argument("--stats-port", type=int, default=None,
                        help="serve Prometheus request-latency metrics "
                             "(/stats: vpp_tpu_kvstore_request_seconds) "
                             "on this port (0 = ephemeral; default: "
                             "disabled)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    server = KVServer(host=args.host, port=args.port,
                      persist_path=args.persist)
    stats_http = None
    if args.stats_port is not None:
        from vpp_tpu_torch.stats.prometheus import MetricsRegistry, StatsHTTPServer

        registry = MetricsRegistry()
        registry.register("/stats", server.request_hist)
        stats_http = StatsHTTPServer(registry, port=args.stats_port)
        stats_http.start()
        logging.getLogger("kvserver").info(
            "stats http on :%d/stats", stats_http.port)
    advertise = args.advertise or f"{args.host}:{server.port}"
    if args.witness and args.advertise is None and \
            args.host in ("0.0.0.0", "::"):
        parser.error("--witness with a wildcard --host needs --advertise "
                     "(the witness records the client-reachable address)")
    ha = None
    if args.follow or args.witness:
        from vpp_tpu_torch.agent.node_id import LIVENESS_PREFIX
        from vpp_tpu_torch.kvstore.replica import HaCoordinator

        # HaCoordinator owns the role for the process lifetime:
        # standby -> (claim granted) -> guarded primary ->
        # (superseded) -> standby of the winner, and so on — the pair
        # heals back to primary+standby with no operator action.
        ha = HaCoordinator(
            server, args.witness, advertise,
            fence_ttl=args.fence_ttl,
            promote_after=args.promote_after,
            follow=args.follow,
            grace_prefixes=(LIVENESS_PREFIX,),
        ).start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        import os

        os.replace(tmp, args.port_file)

    # Serve from a worker thread: calling shutdown() from the thread
    # running serve_forever() deadlocks, and a signal handler runs on
    # the main thread — so the main thread must only wait.
    import threading

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    stop.wait()
    if ha is not None:
        ha.stop()
    if stats_http is not None:
        stats_http.close()
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
