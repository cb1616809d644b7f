"""The cluster data plane: N vswitch nodes over one (node, rule) mesh.

The PyTorch counterpart of ``vpp_tpu/parallel/``: axis ``node`` carries
one vswitch node per mesh row, axis ``rule`` splits the node-global
rule table, the ML planes and the session grids across rule shards, and
inter-node packets cross the fabric in one exchange per step in place
of VXLAN encapsulation (parallel/cluster.py). A single-host mesh lives
on one device (parallel/mesh.py); the multi-host form splits the mesh
rows over ``torch.distributed`` ranks, one process per host, the
fabric's exchange crossing them (parallel/multihost.py).
"""

from vpp_tpu_torch.parallel.cluster import ClusterDataplane, cluster_step
from vpp_tpu_torch.parallel.mesh import cluster_mesh, table_specs


_MULTIHOST = ("MultiHostCluster", "LockstepDriver", "MultiHostRuntime",
              "init_multihost", "barrier")


def __getattr__(name):
    # MeshRuntime imports the agent stack (cmd.*), the multi-host names
    # torch.distributed: lazy, so importing the cluster API never drags
    # the control plane or the process group in
    if name == "MeshRuntime":
        from vpp_tpu_torch.parallel.runtime import MeshRuntime

        return MeshRuntime
    if name in _MULTIHOST:
        from vpp_tpu_torch.parallel import multihost

        return getattr(multihost, name)
    raise AttributeError(name)


__all__ = [
    "cluster_mesh", "table_specs", "ClusterDataplane", "cluster_step",
    "MeshRuntime", "MultiHostCluster", "LockstepDriver", "MultiHostRuntime",
    "init_multihost", "barrier",
]
