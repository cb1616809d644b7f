"""The cluster data plane with its ML stage on: vpp_tpu_torch/parallel vs
vpp_tpu/parallel.

The differential of ``tests/test_torch_cluster.py`` (``differential``:
both packages' clusters built alike step the same traffic, every
``ClusterStepResult`` field and session plane held bit for bit) with a
trained model staged on every node and ``ml_stage: enforce``: the MLP's
hidden units or the forest's trees split over the rule shards, their
partial scores summed before the policy. The reference's cluster step
runs under the ``ref_mesh`` fixture of ``test_torch_cluster`` (its doc
says why). Every quantity compared is an integer: the tolerance is exact
equality.
"""

from __future__ import annotations

import functools

import pytest

from test_torch_cluster import differential, ref_mesh
from vpp_tpu.ml import train as jtrain

__all__ = ["ref_mesh"]   # the module-scoped fixture, used by name below

ML = dict(ml_stage="enforce", ml_hidden=8, ml_trees=4, ml_depth=2)


@functools.lru_cache(maxsize=None)
def _model(kind: str) -> dict:
    """A small trained model of ``kind``, in the dict form both
    packages' ``set_ml_model`` take."""
    model, _ = jtrain.train_and_pack(kind=kind, hidden=8, trees=4, depth=2,
                                     samples=512, seed=7)
    return model.to_dict()


@pytest.mark.parametrize("kind", ["mlp", "forest"])
def test_ml_stage_equals_reference(ref_mesh, kind):
    """The ML stage enforcing over rule-sharded model planes (hidden
    units or trees split over the shards, the partial scores summed)."""
    ref, port = differential(2, 2, "dense", True, 0, False, rounds=1,
                             model=_model(kind), **ML)
    assert port.ml_selected == "enforce"
    assert port.node(0).builder.ml_kind_name == kind
