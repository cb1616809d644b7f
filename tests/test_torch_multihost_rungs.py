"""The multi-host cluster over 2 ``gloo`` ranks at 4 x 1, row for row
against the reference's cluster and the port's single-process one.

More cases of ``tests/test_torch_multihost_diff.py``'s differential (its
harness: the recorded single-process run, the reference on the same
vectors, two ``replay`` ranks), in a file of their own so that each file
stays short under ``--dist loadfile``: one rule shard a node, the
``mxu`` rung with a budget that overflows, the ``bv`` rung with the fast
path and the wire step's payload bytes, and the ``lpm`` FIB rung (nested
prefixes whose longest match crosses the fabric or stays on the node)
with the ML stage enforcing an MLP.

Every quantity compared is an integer: the tolerance is exact equality.
"""

from __future__ import annotations

import pytest

from test_torch_multihost_diff import (LPM, Case, Runs, check_ranks,
                                       check_reference, counts, ref_mesh)

__all__ = ["ref_mesh"]   # the module-scoped fixture, used by name below

CASES = {
    "4x1-mxu-budget3": Case(4, 1, "mxu", False, 3),
    "4x1-bv-fast-wire": Case(4, 1, "bv", True, 0, wire=True),
    "4x1-dense-fast-lpm-ml-mlp": Case(4, 1, "dense", True, 0, model="mlp",
                                      nested=True, kw=LPM),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(CASES, tmp_path_factory.mktemp("mh-rungs"))
    yield r
    r.close()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_equal_the_reference(ref_mesh, runs, name):
    case = CASES[name]
    steps, sel = runs.recorded[name]
    assert (sel["classifier"], sel["fast"]) == (case.classifier, case.fast)
    assert counts(steps, "fabric_sent")[0] > 0
    if case.budget:
        assert counts(steps, "fabric_overflow")[0] > 0
    if case.nested:
        assert sel["fib"] == "lpm"
    if case.model:
        assert sel["ml"] == "enforce"
    check_reference(case, steps)
    check_ranks(case, name, runs, sel)
