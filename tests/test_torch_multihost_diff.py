"""The multi-host cluster over 2 ``gloo`` ranks, row for row against the
reference's cluster and the port's single-process one.

Each case's traffic (``tests/test_torch_cluster.py``'s ``forward``
vectors, a quarter across the fabric, their ``replies``, then the two
mixed) steps the port's single-process ``ClusterDataplane`` (built by
that file's ``build``), which records every step's input vector; the
reference's cluster (the ``ref_mesh`` fixture's) steps the same vectors
and every ``ClusterStepResult`` field, the delivered payload rows and
the session, NAT and ECMP planes must equal the port's. Two ranks
(``vpp_tpu_torch.testing.multihost``'s ``replay``, each a subprocess
with a timeout of its own, on a coordinator port the kernel hands out)
replay the recorded vectors on a ``MultiHostCluster`` whose rows are
staged by ``stage_rank`` (``build``'s staging, one node at a time),
rank r holding rows 2r and 2r + 1: each rank's rows of every
field and plane must equal the same rows of the single-process run,
after every step. The ranks run in the background while the reference
steps.

The cases here are the 4 x 2 geometry; ``tests/test_torch_multihost_rungs.py``
holds the 4 x 1 ones. Between them: the ``dense``, ``bv`` and ``mxu``
rungs at both geometries, the ``lpm`` FIB rung, the ML stage (an MLP and
a forest), the fast path on and off, budget 0 and budgets that overflow,
and the wire step's payload bytes. ``NOT_RUN`` names what does not run.

Every quantity compared is an integer: the tolerance is exact equality.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import pytest

from test_torch_cluster import (PODS, PORT, REF, BASE, _ref_step, build,
                                forward, ref_mesh, replies, stage_node,
                                stage_service)
from vpp_tpu.ml import train as jtrain
from vpp_tpu_torch import interop
from vpp_tpu_torch.ml import train as ttrain
from vpp_tpu_torch.pipeline.tables import SESSION_FIELDS
from vpp_tpu_torch.testing import multihost as mh

__all__ = ["ref_mesh"]   # the module-scoped fixture, used by name below

WIDTH = 32
WORLD = 2
STATE = tuple(SESSION_FIELDS) + ("fib_ecmp_c",)
STAGER = "test_torch_multihost_diff:stage_rank"
ML = dict(ml_stage="enforce", ml_hidden=8, ml_trees=4, ml_depth=2)

# nothing of the listed rungs and options is left out
NOT_RUN: dict = {}


class Case(NamedTuple):
    nodes: int
    shards: int
    classifier: str
    fast: bool
    budget: int
    wire: bool = False
    model: str = ""        # "" (no ML stage), "mlp" or "forest"
    nested: bool = False   # the lpm FIB rung's nested prefixes
    kw: tuple = ()         # more DataplaneConfig knobs


# the lpm FIB rung: the nested prefixes' routes reach its floor
LPM = (("fib_lpm_min_routes", 8),)

# phase 4n of chip_smoke.py times the bv and mxu rungs with the fast path
# and the lpm FIB rung at 4 x 2: bv with lpm is a case here, mxu one
CASES = {
    "4x2-dense-fast-wire": Case(4, 2, "dense", True, 0, wire=True),
    "4x2-bv-fast-lpm-budget2": Case(4, 2, "bv", True, 2, nested=True,
                                    kw=LPM),
    "4x2-mxu-fast": Case(4, 2, "mxu", True, 0),
    "4x2-dense-ml-forest": Case(4, 2, "dense", False, 0, model="forest"),
}


def model_args(kind: str) -> dict:
    return dict(kind=kind, hidden=8, trees=4, depth=2, samples=512, seed=7)


@functools.lru_cache(maxsize=None)
def _model(pkg: str, kind: str) -> dict:
    train = ttrain if pkg == "port" else jtrain
    return train.train_and_pack(**model_args(kind))[0].to_dict()


def stage_rank(node, nid: int, n_nodes: int, model: str = "",
               nested: bool = False) -> None:
    """A replay's stager, in each rank: node ``nid`` staged as ``build``
    stages it (``model`` names the trained model's kind)."""
    stage_node(PORT, node, nid, n_nodes,
               model=_model("port", model) if model else None, nested=nested)
    peer = (nid + 1) % n_nodes
    ipam = PORT.IPAM(peer + 1)
    pods = [f"ns/pod{peer}-{p}" for p in range(PODS)]
    stage_service(PORT, node, nid, n_nodes,
                  {pod: str(ipam.next_pod_ip(pod)) for pod in pods})


def config_kw(case: Case) -> dict:
    kw = dict(classifier=case.classifier, fastpath=case.fast, **dict(case.kw))
    if case.model:
        kw.update(ML)
    return kw


def _build(pkg, case: Case):
    model = _model("port" if pkg is PORT else "ref", case.model) \
        if case.model else None
    return build(pkg, case.nodes, case.shards, model=model,
                 nested=case.nested, **config_kw(case))


def record(case: Case, spec_dir):
    """The port's single-process cluster steps the case's traffic; every
    step's frames, inputs, results and state planes, and the spec the
    ranks replay."""
    port, pod_ip, pod_if = _build(PORT, case)
    rng = np.random.default_rng(5)
    steps, inputs = [], {}

    def step(frames, now, payload):
        k = len(steps)
        pkts = port.make_frames(frames, n=WIDTH)
        inputs[f"cols.{k}"] = np.stack([f.numpy() for f in pkts], axis=1)
        if payload is None:
            res, pay = port.step(pkts, now=now, budget=case.budget), None
        else:
            inputs[f"payload.{k}"] = payload
            res, pay = port.step_wire(pkts, payload, now=now,
                                      budget=case.budget)
        out = interop.cluster_result_to_numpy(res)
        out.update({f"state.{f}": a for f, a in interop.cluster_tables_to_numpy(
            port.tables, STATE).items()})
        if pay is not None:
            out["payload"] = pay.numpy().copy()
        steps.append(dict(frames=frames, now=now, payload=payload, out=out))
        return res

    fwd = forward(case.nodes, pod_ip, pod_if, seed=0, nested=case.nested)
    payload = (rng.integers(0, 256, (case.nodes, WIDTH, 48), dtype=np.uint8)
               if case.wire else None)
    res = step(fwd, 10, payload)
    back = replies(res, case.nodes, WIDTH)
    step(back, 11, payload)
    step([f[:WIDTH // 2] + b[:WIDTH // 2] for f, b in zip(fwd, back)], 12,
         payload)
    cfg = {**BASE, **config_kw(case)}
    spec = dict(config=cfg, n_nodes=case.nodes, rule_shards=case.shards,
                stager=STAGER,
                stage_args=dict(model=case.model, nested=case.nested),
                state_fields=list(STATE),
                steps=[dict(now=s["now"], budget=case.budget)
                       for s in steps])
    mh.write_spec(spec_dir, spec, inputs)
    sel = dict(classifier=port.classifier_impl, fast=port.fastpath_selected,
               fib=port.fib_impl, ml=port.ml_selected)
    return steps, sel


class Runs:
    """Every case of one file recorded, and its ranks started once."""

    def __init__(self, cases: dict, root):
        self.cases = cases
        self.root = root
        self.recorded = {name: record(c, root / name)
                         for name, c in cases.items()}
        self.ranks = mh.start_ranks(
            "replay", WORLD, [str(root / name) for name in cases],
            device="cpu")
        self._verdicts = None

    def verdicts(self) -> dict:
        if self._verdicts is None:
            outs = self.ranks.wait(timeout=240)
            self._verdicts = [mh.verdict_of(o)["cases"] for o, _ in outs]
        return self._verdicts

    def close(self):
        self.ranks.kill()


def check_reference(case: Case, steps) -> None:
    """The reference's cluster on the recorded frames: every field,
    payload row and plane equal to the port's single-process run."""
    ref, _, _ = _build(REF, case)
    for k, s in enumerate(steps):
        r_res, r_pay = _ref_step(ref, ref.make_frames(s["frames"], n=WIDTH),
                                 s["now"], case.budget, s["payload"])
        got = interop.cluster_result_to_numpy(r_res)
        got.update({f"state.{f}": a for f, a in
                    interop.cluster_tables_to_numpy(ref.tables, STATE).items()})
        if r_pay is not None:
            got["payload"] = np.asarray(r_pay)
        assert got.keys() == s["out"].keys()
        for f, a in got.items():
            np.testing.assert_array_equal(a, s["out"][f],
                                          err_msg=f"step {k} {f}")


def check_ranks(case: Case, name: str, runs: Runs, sel: dict) -> None:
    """Each rank's rows of every recorded field and plane, after every
    step, equal the single-process run's."""
    steps = runs.recorded[name][0]
    n_local = case.nodes // WORLD
    for rank, verdicts in enumerate(runs.verdicts()):
        v = verdicts[name]
        assert v["local_nodes"] == list(range(rank * n_local,
                                              (rank + 1) * n_local))
        assert {k: v[k] for k in sel} == sel
        rows = mh.replay_rows(runs.root / name, rank)
        assert len(rows) == sum(len(s["out"]) for s in steps)
        for k, s in enumerate(steps):
            for f, a in s["out"].items():
                np.testing.assert_array_equal(
                    rows[f"{k}.{f}"], a[rank * n_local:(rank + 1) * n_local],
                    err_msg=f"rank {rank} step {k} {f}")
        if case.classifier == "mxu":
            # the mxu rung's plain version serves on the CPU: no launch
            assert v["launches"]["mxu_first_match"] == 0


def counts(steps, key):
    return [int(s["out"][key].sum()) for s in steps]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(CASES, tmp_path_factory.mktemp("mh-diff"))
    yield r
    r.close()


def test_case_list():
    assert len(CASES) == 4 and not NOT_RUN


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_equal_the_reference(ref_mesh, runs, name):
    case = CASES[name]
    steps, sel = runs.recorded[name]
    assert sel["classifier"] == case.classifier
    assert sel["fast"] == case.fast
    assert counts(steps, "fabric_sent")[0] > 0
    if case.budget:
        assert counts(steps, "fabric_overflow")[0] > 0
    if case.nested:
        assert sel["fib"] == "lpm"
    if case.model:
        assert sel["ml"] == "enforce"
    check_reference(case, steps)
    check_ranks(case, name, runs, sel)
