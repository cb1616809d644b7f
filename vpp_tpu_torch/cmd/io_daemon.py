"""vpp-tpu-torch-io: the packet-IO daemon process.

The port's copy of ``vpp_tpu/cmd/io_daemon.py``; run it as
``python -m vpp_tpu_torch.cmd.io_daemon`` or ``vpp-tpu-torch-io``. It
imports no torch: the agent's pump drives the card, this process only
moves bytes between its transports and the agent's shared-memory rings.

Owns the node's packet endpoints (AF_PACKET uplink, TAP devices for
pods, inherited socketpair fds for tests) and pumps frames between them
and the agent's shared-memory rings. The process-split analog of VPP
running beside the contiv-agent in the vswitch pod
(docker/vpp-vswitch/supervisord.conf:18-22).

Interface spec syntax (repeatable --if):
  --if 3:afpacket:eth0       AF_PACKET bound to eth0 as if-index 3
  --if 5:tap:pod-abc         TAP device pod-abc as if-index 5
  --if 4:fd:17               inherited socketpair/tun fd 17 as if-index 4
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from vpp_tpu_torch.io.control import IOControlServer
from vpp_tpu_torch.io.daemon import IODaemon
from vpp_tpu_torch.io.rings import IORingPair
from vpp_tpu_torch.io.transport import make_transport

log = logging.getLogger("io_daemon")


def parse_if_spec(spec: str) -> tuple:
    idx, kind, arg = spec.split(":", 2)
    return int(idx), kind, arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vpp-tpu-torch-io")
    parser.add_argument("--shm", required=True,
                        help="shared-memory name of the ring pair")
    parser.add_argument("--slots", type=int, default=64)
    parser.add_argument("--snap", type=int, default=2048)
    parser.add_argument("--if", dest="ifs", action="append", default=[],
                        help="IDX:KIND:ARG (afpacket|tap|fd)", metavar="SPEC")
    parser.add_argument("--uplink", type=int, required=True,
                        help="if-index of the uplink")
    parser.add_argument("--host-if", type=int, default=None)
    parser.add_argument("--vtep", type=int, default=0,
                        help="this node's VTEP IPv4 as uint32")
    parser.add_argument("--vni", type=int, default=10)
    parser.add_argument("--control", default=None, metavar="SOCK",
                        help="unix socket for runtime attach/detach "
                             "(the agent's CNI server drives this)")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level)

    rings = IORingPair(n_slots=args.slots, snap=args.snap,
                       shm_name=args.shm, create=False)
    transports = {}
    for spec in args.ifs:
        idx, kind, arg = parse_if_spec(spec)
        transports[idx] = make_transport(kind, arg)
        log.info("if %d: %s(%s)", idx, kind, arg)
    daemon = IODaemon(
        rings, transports, uplink_if=args.uplink, host_if=args.host_if,
        vtep_ip=args.vtep, vni=args.vni,
    ).start()
    control = None
    if args.control:
        control = IOControlServer(daemon, args.control).start()
        log.info("control socket at %s", args.control)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    if control is not None:
        control.close()
    daemon.stop()
    for t in daemon.transports.values():
        t.close()
    rings.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
