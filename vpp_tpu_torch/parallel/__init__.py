"""The cluster data plane: N vswitch nodes over one (node, rule) mesh.

The PyTorch counterpart of ``vpp_tpu/parallel/``: axis ``node`` carries
one vswitch node per mesh row, axis ``rule`` splits the node-global
rule table, the ML planes and the session grids across rule shards, and
inter-node packets cross the fabric in one exchange per step in place
of VXLAN encapsulation (parallel/cluster.py). This port holds a mesh on
one device (parallel/mesh.py). The multi-host form is not ported yet:
ROADMAP Queue 1 item 14 (Multi-host mesh).
"""

from vpp_tpu_torch.parallel.cluster import ClusterDataplane, cluster_step
from vpp_tpu_torch.parallel.mesh import cluster_mesh, table_specs


def __getattr__(name):
    # MeshRuntime imports the agent stack (cmd.*): lazy, so importing
    # the cluster API never drags the control plane in
    if name == "MeshRuntime":
        from vpp_tpu_torch.parallel.runtime import MeshRuntime

        return MeshRuntime
    raise AttributeError(name)


__all__ = [
    "cluster_mesh", "table_specs", "ClusterDataplane", "cluster_step",
    "MeshRuntime",
]
