"""vpp-tpu-torch-mesh-agent: the mesh vswitch process.

The port's ``vpp_tpu/cmd/mesh_main.py``: boots a ``MeshRuntime`` (N
cooperating node agents over one (node, rule) mesh with the fabric
exchange as the inter-node data plane, parallel/runtime.py) on the card.
The config adds a ``mesh`` section:

    mesh:
      nodes: 4          # mesh rows (vswitch nodes)
      rule_shards: 2    # global-ACL rule-axis shards

``nodes: 0`` means one node per device group: a single-host mesh lives
on one card, so that is one node.

Multi-host: ``--coordinator host:port --num-processes R --process-id r``
(or ``mesh.coordinator`` / ``mesh.num_processes`` / ``mesh.process_id``)
runs this process as rank ``r`` of R: the same binary on every host, its
process group up first (``init_multihost``), then a ``MultiHostRuntime``
whose agents drive the mesh rows this rank owns (parallel/multihost.py).
``nodes`` then counts the whole cluster's rows; ``nodes: 0`` is one node
per rank. A halted fabric (a failed collective) ends the process with
exit code 1. ``--device cpu`` runs the mesh on the CPU (default: the
card; without one it raises).
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("vpp_tpu_torch.mesh_agent")


def main(argv=None) -> int:
    import argparse

    from vpp_tpu_torch.cmd.config import load_config

    parser = argparse.ArgumentParser(prog="vpp-tpu-torch-mesh-agent")
    parser.add_argument("--config", default=None, help="agent YAML config")
    parser.add_argument("--nodes", type=int, default=None,
                        help="mesh rows (overrides mesh.nodes; default: "
                             "one per device group, 1 on one card; one "
                             "per rank in multi-host mode)")
    parser.add_argument("--rule-shards", type=int, default=None,
                        help="overrides mesh.rule_shards")
    parser.add_argument("--coordinator", default=None,
                        help="process-group coordinator host:port (rank "
                             "0 serves it) — enables MULTI-HOST mode "
                             "(one process per host; overrides "
                             "mesh.coordinator)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="ranks of the multi-host mesh (overrides "
                             "mesh.num_processes)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank (overrides "
                             "mesh.process_id)")
    parser.add_argument("--device", default=None,
                        help="torch device of the mesh (default: the "
                             "card; raises without one); ``--device "
                             "cpu`` asks for the CPU")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    config = load_config(args.config)
    rule_shards = (args.rule_shards if args.rule_shards is not None
                   else config.mesh.rule_shards)
    n_nodes = args.nodes if args.nodes is not None else config.mesh.nodes
    coordinator = (args.coordinator if args.coordinator is not None
                   else config.mesh.coordinator)
    if coordinator:
        # multi-host: the process group comes up before anything else,
        # then n_nodes counts the WHOLE cluster's mesh rows
        from vpp_tpu_torch.parallel.multihost import (
            MultiHostRuntime, init_multihost)

        num_procs = (args.num_processes if args.num_processes is not None
                     else config.mesh.num_processes)
        proc_id = (args.process_id if args.process_id is not None
                   else config.mesh.process_id)
        if num_procs <= 0 or not 0 <= proc_id < num_procs:
            parser.error("--coordinator requires --num-processes and "
                         "--process-id (or the mesh.* config keys)")
        init_multihost(coordinator, num_procs, proc_id)
        runtime = MultiHostRuntime(n_nodes or num_procs, config,
                                   rule_shards=rule_shards,
                                   device=args.device)
    else:
        from vpp_tpu_torch.parallel.runtime import MeshRuntime

        # one node per device group: the mesh lives on one device
        n_nodes = n_nodes or 1
        runtime = MeshRuntime(
            n_nodes, config, rule_shards=rule_shards,
            devices=(None if args.device is None
                     else [args.device] * (n_nodes * rule_shards)))
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    runtime.start()
    log.info("mesh agent up: %d nodes x %d rule shards, agents %s",
             runtime.n_nodes, rule_shards,
             [a.config.node_name for a in runtime.agents])
    halted = getattr(runtime, "halted", None)
    while not stop.wait(0.5):
        if halted is not None and halted.is_set():
            break
    log.info("shutting down")
    runtime.close()
    failed = getattr(runtime, "failed", None)
    if failed is not None:
        log.error("the mesh fabric halted: %r", failed)
        return 1
    if coordinator:
        from vpp_tpu_torch.parallel.multihost import shutdown_multihost

        shutdown_multihost()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
