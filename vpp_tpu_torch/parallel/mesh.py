"""The (node, rule) mesh of the cluster data plane.

The PyTorch counterpart of ``vpp_tpu/parallel/mesh.py``. Axes: ``node``,
one vswitch node per mesh row (the reference's per-node DaemonSet
replica), and ``rule``, the capacity axis the partition layer
(parallel/partition.py) splits the global-ACL rules, the BV word
planes, the ML hidden / tree planes and the session bucket grids over.

A ``Mesh`` is an ``[N, R]`` grid of positions, each naming a
``torch.device``; positions may share a device. This port holds a mesh
on ONE device (the H100 of this round, or the CPU in the tests): the
cluster keeps every field node-stacked there, a node's rule shards are
blocks of its tensors, and the reference's collectives are in-process
tensor operations (parallel/cluster.py). A grid naming more than one
device is refused.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vpp_tpu_torch.parallel.partition import NODE_AXIS, RULE_AXIS, table_specs
from vpp_tpu_torch.pipeline.tables import resolve_device

__all__ = ["NODE_AXIS", "RULE_AXIS", "Mesh", "cluster_mesh", "table_specs"]


class Mesh:
    """An ``[N, R]`` grid of positions on one device: ``shape`` maps
    each axis name to its size (the reference's ``Mesh.shape``),
    ``devices`` is the grid, ``device`` the one device it names."""

    axis_names = (NODE_AXIS, RULE_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        n, r = devices.shape
        self.shape = {NODE_AXIS: int(n), RULE_AXIS: int(r)}
        named = {d for d in devices.reshape(-1)}
        if len(named) != 1:
            raise ValueError(
                f"mesh positions name {len(named)} devices "
                f"({sorted(map(str, named))}): this port places a mesh "
                "on one device")
        self.device = next(iter(named))

    @property
    def size(self) -> int:
        return self.shape[NODE_AXIS] * self.shape[RULE_AXIS]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[NODE_AXIS]} nodes x "
                f"{self.shape[RULE_AXIS]} rule shards on {self.device})")


def cluster_mesh(n_nodes: int, rule_shards: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """The (node, rule) mesh of ``n_nodes * rule_shards`` positions:
    ``devices`` names one device per position (the first ``n * r``
    are used); None places every position on the card (and raises
    without one)."""
    need = n_nodes * rule_shards
    if devices is None:
        devices = [resolve_device(None)] * need
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty((n_nodes, rule_shards), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // rule_shards, i % rule_shards] = d
    return Mesh(grid)
