"""The mesh agent: vpp_tpu_torch's MeshRuntime against the reference's
tests.

* Every case of ``tests/test_mesh_agent.py`` runs on the port through
  ``test_torch_hoststack.run_case`` (the module's names and imports
  bound to the port; ``MeshRuntime`` and ``cluster_mesh`` put the mesh
  on the CPU): N ContivAgents over one store and one ClusterDataplane,
  pods through the CNI, a NetworkPolicy reflected through KSR cutting a
  cross-node flow, a ClusterIP service whose backend sits on the other
  node, a mesh over a served KV store, a restart that keeps node ids and
  pod addresses, cluster session aging, per-node VCL sockets, the
  ``ClusterPump`` coalescing a backlog of wire frames across the fabric
  and an ICMP time-exceeded returning across it. The two cases the
  reference marks slow (its XLA compiles of the wire step) run here too:
  the port captures nothing on the CPU.
* The collector's and the CLI's mesh pages of a runtime's agent: ``show
  mesh``, ``show partitions`` and the partition gauges.

Every quantity compared is an integer or a string: the tolerance is
exact equality.
"""

from __future__ import annotations

import pytest

import test_mesh_agent as jmesh_tests
import vpp_tpu.io.cluster_pump  # noqa: F401  (test_torch_agent gotcha)
import vpp_tpu.kvstore.server  # noqa: F401
import vpp_tpu.native.pktio  # noqa: F401
import wire  # noqa: F401
from test_torch_agent import case_names
from test_torch_hoststack import run_case

CASES = case_names(jmesh_tests)


def test_case_list():
    """All nine cases run (seven tier-1 in the reference, two slow)."""
    assert len(CASES) == 9


@pytest.mark.parametrize("case", CASES)
def test_reference_mesh_agent_cases(case, request):
    run_case(jmesh_tests, case, request)


def _runtime(tmp_path, **io):
    from vpp_tpu_torch.cmd import AgentConfig
    from vpp_tpu_torch.kvstore import KVStore
    from vpp_tpu_torch.parallel.runtime import MeshRuntime

    cfg = AgentConfig.from_dict({
        "node_name": "mp", "serve_http": False,
        "dataplane": dict(max_tables=4, max_rules=16, max_global_rules=64,
                          max_ifaces=16, fib_slots=64, sess_slots=256,
                          nat_mappings=4, nat_backends=16),
        "io": io})
    return MeshRuntime(2, cfg, rule_shards=2, store=KVStore(),
                       devices=["cpu"] * 4).start()


def test_mesh_pages_of_the_cli_and_the_collector(tmp_path):
    """A runtime agent's CLI (built as the agent builds it) answers
    ``show mesh`` (the agents and the fabric pump) and ``show
    partitions`` (the mesh's placements and per-shard residency); its
    collector exports the mesh's shard count and the per-shard gauges,
    read off the cluster's tensors."""
    from vpp_tpu_torch.cli import DebugCLI
    from vpp_tpu_torch.stats.collector import STATS_PATH

    rt = _runtime(tmp_path, enabled=True, n_slots=16, snap=256)
    try:
        a0, a1 = rt.agents
        assert a0.io_pump is rt.cluster_pump and a0._external_io
        assert a0.mesh_runtime is rt and a1.mesh_runtime is rt

        def cli(a):
            return DebugCLI(a.dataplane, stats=a.stats, pump=a.io_pump,
                            mesh_runtime=a.mesh_runtime)
        mesh = cli(a0).run("show mesh")
        assert mesh.startswith(f"cluster: 2 nodes, epoch {rt.cluster.epoch}")
        assert "agents: mp-0(id" in mesh and "fabric pump: steps" in mesh
        part = cli(a1).run("show partitions")
        assert part.startswith("mesh: 2 nodes x 2 rule shards")
        assert "selection: classifier=dense fastpath=True ml=off" in part
        assert "per-shard sessions resident: shard 0: 0, shard 1: 0" in part
        a0.stats.publish()
        text = a0.stats.registry.render(STATS_PATH)
        assert ('vpp_tpu_partition_info{axis="rule",field="sess_valid",'
                'shards="2"} 1' in text)
        assert ('vpp_tpu_partition_info{axis="replicated",'
                'field="glb_ml_w1",shards="2"} 1' in text)
        assert 'vpp_tpu_shard_sessions_resident{shard="1"} 0' in text
        per = rt.cluster.shard_rule_plane_bytes()
        assert len(per) == 2 and per[0] == per[1] > 0
        assert a0.stats.shard_rule_bytes_gauge.get(shard="0") == per[0]
    finally:
        rt.close()
