"""The cluster data plane's other rungs: vpp_tpu_torch/parallel vs
vpp_tpu/parallel, and the port's cluster against standalone Dataplanes.

``tests/test_torch_cluster.py`` holds the differential's harness
(``build``, ``pair_step``, ``differential``) and its first cases; these
are more of its cases (``tests/test_torch_cluster_ml.py`` the ML
stage's), in a file of their own so that each file stays short under
``--dist loadfile``:

* the ``mxu`` classifier at 4 x 2 (the geometry the chip smoke's mesh
  phase times) and the ``dense`` one at 2 x 2 with payload;
* the ``lpm`` FIB rung, selected by the auto ladder once a node stages
  ``fib_lpm_min_routes`` routes, with nested prefixes whose longest
  match sends a packet across the fabric or keeps it on the node;
* the port's 2 x 2 cluster against two standalone port ``Dataplane``\\ s
  staged as its nodes: pass 1 is each node's own step, pass 2 the
  destination's step over the exchanged rows (rebuilt here in NumPy
  from pass 1's output), the stats their sum, the session planes each
  node's.

The reference's cluster step runs under the ``ref_mesh`` fixture of
``test_torch_cluster`` (its doc says why). Every quantity compared is an
integer: the tolerance is exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_cluster import (BASE, PORT, build, differential, forward,
                                 ref_mesh, replies, stage_node,
                                 stage_service)
from vpp_tpu_torch import interop
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.tables import SESSION_FIELDS
from vpp_tpu_torch.pipeline.vector import (FLAG_VALID, Disposition,
                                           PacketVector, make_packet_vector)

__all__ = ["ref_mesh"]   # the module-scoped fixture, used by name below

CASES = [
    # (nodes, shards, classifier, fast path, fabric budget, wire)
    pytest.param(4, 2, "mxu", True, 0, False, id="4x2-mxu-fast"),
    pytest.param(2, 2, "dense", False, 0, True, id="2x2-dense-wire"),
]


@pytest.mark.parametrize("nodes,shards,classifier,fast,budget,wire", CASES)
def test_cluster_equals_reference(ref_mesh, nodes, shards, classifier, fast,
                                  budget, wire):
    differential(nodes, shards, classifier, fast, budget, wire, rounds=1)


def test_lpm_fib_rung_equals_reference(ref_mesh):
    """11 routes a node reach ``fib_lpm_min_routes`` = 8: both packages
    select ``lpm`` on the mesh and step alike, the nested prefixes'
    packets split between the fabric and the node."""
    ref, port = differential(2, 2, "dense", False, 0, False, rounds=1,
                             nested=True, fib_lpm_min_routes=8)
    assert port.fib_impl == "lpm"


def _arrivals(first, dest, uplink, width):
    """The rows ``dest`` receives from the fabric at budget 0: for each
    source node in order, its REMOTE packets bound for ``dest`` in their
    order, padded to ``width`` invalid rows, every row on ``uplink``."""
    cols = {f: [] for f in PacketVector._fields}
    for res in first:
        disp, node_id = res.disp.numpy(), res.node_id.numpy()
        rows = np.nonzero((disp == int(Disposition.REMOTE))
                          & (node_id == dest))[0]
        for f in PacketVector._fields:
            block = np.zeros(width, np.int32)
            if f == "flags":
                block[:len(rows)] = FLAG_VALID
            elif f == "rx_if":
                block[:] = uplink
            else:
                block[:len(rows)] = getattr(res.pkts, f).numpy()[rows]
            cols[f].append(block)
    return PacketVector(*(torch.from_numpy(np.concatenate(cols[f]))
                          for f in PacketVector._fields))


def _tx(res):
    out = {f"pkts.{f}": getattr(res.pkts, f).numpy()
           for f in PacketVector._fields}
    for f in ("disp", "tx_if", "node_id", "next_hop", "drop_cause"):
        out[f] = getattr(res, f).numpy()
    return out


@pytest.mark.parametrize("classifier,fast", [("dense", True), ("bv", False)])
def test_cluster_equals_standalone_dataplanes(classifier, fast):
    """Each node of a 2 x 2 cluster steps as a standalone Dataplane
    staged alike: pass 1 as its step over its own vector, pass 2 as its
    step over the rows the exchange hands it; the stats are the two
    steps' sum and the session planes the standalone's, bit for bit.
    The idle sweep is off, as in the reference's own cluster-against-
    standalone case: a rule shard sweeps its own block of buckets, so
    the sweep's schedule (not what it keeps) differs from a standalone
    table's."""
    n, width = 2, 32
    kw = dict(classifier=classifier, fastpath=fast, sess_sweep_stride=0)
    clus, pod_ip, pod_if = build(PORT, n, 2, **kw)
    cfg = ttables.DataplaneConfig(**{**BASE, **kw})
    solos = [Dataplane(cfg, device="cpu", graphs=False) for _ in range(n)]
    for nid, dp in enumerate(solos):
        assert stage_node(PORT, dp, nid, n)[1] == {
            k: v for k, v in pod_if.items() if k.startswith(f"ns/pod{nid}-")}
    for nid, dp in enumerate(solos):
        stage_service(PORT, dp, nid, n, pod_ip)
        dp.swap()
    uplinks = [int(u) for u in clus._uplinks.tolist()]
    frames = forward(n, pod_ip, pod_if, seed=3)
    sent = 0
    for now in (10, 11):
        raw = clus.step(clus.make_frames(frames, n=width), now=now)
        res = interop.cluster_result_to_numpy(raw)
        first = [dp.process(make_packet_vector(frames[i], n=width),
                            now=now) for i, dp in enumerate(solos)]
        second = [dp.process(_arrivals(first, i, uplinks[i], width),
                             now=now) for i, dp in enumerate(solos)]
        sent += int(res["fabric_sent"].sum())
        for i in range(n):
            for side, solo in (("local", first[i]), ("delivered", second[i])):
                for k, v in _tx(solo).items():
                    np.testing.assert_array_equal(
                        res[f"{side}.{k}"][i], v, err_msg=f"{side}.{k}")
            for f in first[i].stats._fields:
                np.testing.assert_array_equal(
                    res[f"stats.{f}"][i],
                    (getattr(first[i].stats, f)
                     + getattr(second[i].stats, f)).numpy(), err_msg=f)
        planes = interop.cluster_tables_to_numpy(clus.tables, SESSION_FIELDS)
        for f, a in planes.items():
            for i, dp in enumerate(solos):
                np.testing.assert_array_equal(
                    a[i], getattr(dp.tables, f).numpy(), err_msg=f)
        frames = replies(raw, n, width)
    assert sent > 0 and int(clus.tables.sess_valid.sum()) > 0
