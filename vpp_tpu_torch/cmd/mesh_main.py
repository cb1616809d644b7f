"""vpp-tpu-torch-mesh-agent: the mesh vswitch process.

The port's ``vpp_tpu/cmd/mesh_main.py``: boots a ``MeshRuntime`` (N
cooperating node agents over one (node, rule) mesh with the fabric
exchange as the inter-node data plane, parallel/runtime.py) on the card.
The config adds a ``mesh`` section:

    mesh:
      nodes: 4          # mesh rows (vswitch nodes)
      rule_shards: 2    # global-ACL rule-axis shards

``nodes: 0`` means one node per device group: this port holds a mesh on
one card, so that is one node. The multi-host form (``--coordinator`` /
``mesh.coordinator``) raises ``NotImplementedError``: ROADMAP Queue 1
item 14 (Multi-host mesh).
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("vpp_tpu_torch.mesh_agent")

MULTIHOST_REFUSAL = (
    "--coordinator / mesh.coordinator: the multi-host mesh "
    "(parallel/multihost.py) is not ported yet (ROADMAP Queue 1 item 14 "
    "(Multi-host mesh))")


def main(argv=None) -> int:
    import argparse

    from vpp_tpu_torch.cmd.config import load_config

    parser = argparse.ArgumentParser(prog="vpp-tpu-torch-mesh-agent")
    parser.add_argument("--config", default=None, help="agent YAML config")
    parser.add_argument("--nodes", type=int, default=None,
                        help="mesh rows (overrides mesh.nodes; default: "
                             "one per device group, 1 on one card)")
    parser.add_argument("--rule-shards", type=int, default=None,
                        help="overrides mesh.rule_shards")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host coordinator host:port (not "
                             "ported: ROADMAP Queue 1 item 14)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    config = load_config(args.config)
    coordinator = (args.coordinator if args.coordinator is not None
                   else config.mesh.coordinator)
    if coordinator:
        raise NotImplementedError(f"vpp-tpu-torch-mesh-agent: "
                                  f"{MULTIHOST_REFUSAL}")
    from vpp_tpu_torch.parallel.runtime import MeshRuntime

    rule_shards = (args.rule_shards if args.rule_shards is not None
                   else config.mesh.rule_shards)
    n_nodes = args.nodes if args.nodes is not None else config.mesh.nodes
    if not n_nodes:
        # one node per device group: the mesh lives on one device
        n_nodes = 1
    runtime = MeshRuntime(n_nodes, config, rule_shards=rule_shards)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    runtime.start()
    log.info("mesh agent up: %d nodes x %d rule shards, agents %s",
             runtime.n_nodes, rule_shards,
             [a.config.node_name for a in runtime.agents])
    stop.wait()
    log.info("shutting down")
    runtime.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
