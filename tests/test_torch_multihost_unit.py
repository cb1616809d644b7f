"""The lockstep driver and the multi-host cluster in one process:
vpp_tpu_torch/parallel/multihost.py against the reference's unit suite.

* Every case of ``tests/test_multihost_unit.py`` runs on the port through
  ``test_torch_hoststack.run_case`` (the module's names bound to the
  port, the cluster on the CPU), the three the reference slow-marks too:
  on the port they take seconds. Without a process group the cluster is
  a world of one and ``process_allgather`` the identity, as the
  reference's single-controller JAX: the stale stop baseline, the commit
  agreement (one publish a request, enforced on the same tick), the idle
  skip and the commit tick that always steps, aging on the tick cadence,
  the fleet-agreed FIB rung, and the publish guards.
* The process discipline of a world of one: the rows, the refusals.

Every quantity compared is an integer: the tolerance is exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest

import test_multihost_unit as junit
from test_torch_agent import case_names
from test_torch_hoststack import run_case
from vpp_tpu_torch.parallel import multihost as tmh
from vpp_tpu_torch.pipeline.tables import DataplaneConfig

SMALL = dict(max_tables=4, max_rules=16, max_global_rules=32, max_ifaces=8,
             fib_slots=32, sess_slots=256, nat_mappings=4, nat_backends=16)


class CpuMultiHostCluster(tmh.MultiHostCluster):
    """The port's MultiHostCluster on the CPU unless told otherwise."""

    def __init__(self, n_nodes, config=None, rule_shards=1, device="cpu"):
        super().__init__(n_nodes, config, rule_shards, device)


CASES = case_names(junit)


def test_case_list():
    """All seven cases run, the three slow-marked ones among them."""
    assert len(CASES) == 7


@pytest.mark.parametrize("case", CASES)
def test_reference_unit_cases(case, request):
    run_case(junit, case, request,
             names={"MultiHostCluster": CpuMultiHostCluster})


def test_world_of_one_owns_every_row():
    """No process group: rank 0 of 1 owns every row, the gather is the
    identity and the exchange's swap stays in-process."""
    assert tmh.rank_and_world() == (0, 1)
    cl = CpuMultiHostCluster(3, DataplaneConfig(**SMALL))
    assert cl.local_nodes == [0, 1, 2] and cl.fabric is None
    assert cl.plane._swap is None and cl.plane._world == 1
    got = tmh.process_allgather(np.int32([4, 5]))
    assert got.shape == (1, 2) and got.tolist() == [[4, 5]]
    with pytest.raises(KeyError):
        cl.node(3)


def test_node_swap_is_refused_and_step_needs_a_publish():
    cl = CpuMultiHostCluster(2, DataplaneConfig(**SMALL))
    with pytest.raises(RuntimeError, match="collective"):
        cl.node(0).swap()
    with pytest.raises(RuntimeError, match="publish"):
        cl.step(cl.make_frames([[], []], n=8))


@pytest.mark.parametrize("kw,match", [
    (dict(tenancy="on"), "tenancy"),
    (dict(classifier="pallas"), "PARTITION_RULES"),
])
def test_refuses_what_the_reference_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        CpuMultiHostCluster(2, DataplaneConfig(**SMALL, **kw), rule_shards=2)


def test_a_row_published_after_the_node_event_reroutes_the_peer():
    """A peer whose node event arrives before its mesh row is published
    gets edge routes (the resolver answers -1); once the row appears the
    runtime's watch has every agent re-resolve it, and the peer's pod
    network routes into the fabric at that row, with no next hop. The
    reference's runtime keeps the edge routes."""
    from vpp_tpu_torch.cmd import AgentConfig
    from vpp_tpu_torch.kvstore import KVStore

    store = KVStore()
    cfg = AgentConfig(node_name="mh", serve_http=False,
                      node_liveness_ttl_s=120.0,
                      dataplane=DataplaneConfig(**SMALL))
    rt = tmh.MultiHostRuntime(3, cfg, store=store, device="cpu")
    late = rt.agents[2].node_id
    store.delete(rt.POS_PREFIX + str(late))   # its row: not yet published
    rt.start()
    try:
        agent = rt.agents[0]
        net = agent.ipam.other_node_pod_network(late)

        def route():
            b = agent.dataplane.builder
            slot = [i for i in range(len(b.fib_plen))
                    if b.fib_plen[i] == net.prefixlen
                    and (int(b.fib_prefix[i]) & 0xFFFFFFFF)
                    == int(net.network_address)]
            assert len(slot) == 1, slot
            return int(b.fib_node_id[slot[0]]), int(b.fib_next_hop[slot[0]])

        node, hop = route()
        assert node == -1 and hop != 0                 # an edge route
        store.put(rt.POS_PREFIX + str(late), 2)
        assert route() == (2, 0)                       # the fabric, row 2
    finally:
        rt.close()
