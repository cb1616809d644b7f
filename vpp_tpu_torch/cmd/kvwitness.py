"""vpp-tpu-torch-kvwitness: the HA kvstore pair's quorum arbiter (the
port's copy of ``vpp_tpu/cmd/kvwitness.py``).

Third voter of the 2-replicas + arbiter construction
(kvstore/witness.py) that stands in for the raft quorum the reference
gets from etcd (contiv-vpp's k8s/contiv-vpp.yaml:72-114). Holds no
cluster data — only the fencing epoch and the current primary's lease —
so it runs anywhere a few KB and a TCP port exist (the chart schedules
it on a third node, k8s/chart/).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from vpp_tpu_torch.kvstore.witness import QuorumWitness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vpp-tpu-torch-kvwitness",
        description="vpp-tpu kvstore quorum witness")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=12380)
    parser.add_argument("--persist", default=None,
                        help="epoch/primary survive restarts here "
                             "(atomic-rename JSON)")
    parser.add_argument("--port-file", default=None,
                        help="write the bound port here once listening")
    parser.add_argument("--status", default=None, metavar="HOST:PORT",
                        help="query a RUNNING witness and print its "
                             "arbitration state (epoch, primary, lease "
                             "remaining) — the operator one-liner for "
                             "'who is writable right now'")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)

    if args.status:
        from vpp_tpu_torch.kvstore.witness import (
            WitnessClient, WitnessUnreachable,
        )

        try:
            st = WitnessClient(args.status).status()
        except (WitnessUnreachable, ValueError) as exc:
            # ValueError: malformed host:port — same operator-facing
            # one-liner, not a traceback
            print(f"witness {args.status} unreachable: {exc}")
            return 1
        print(f"epoch {st['epoch']}  primary {st['primary'] or '(none)'}"
              f"  lease remaining {st['remaining']:.1f}s")
        return 0

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    witness = QuorumWitness(host=args.host, port=args.port,
                            persist_path=args.persist)
    if args.port_file:
        import os

        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(witness.port))
        os.replace(tmp, args.port_file)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    witness.start()
    stop.wait()
    witness.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
