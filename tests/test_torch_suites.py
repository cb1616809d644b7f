"""Reference suites over modules the port already has, run on the port.

Each case of these reference files runs as written on the port
(``test_torch_hoststack.run_case``: the module's names, the imports its
functions make and its fixtures bound to the port, the dataplane and
the table builder on the CPU):

* ``tests/test_session_table.py``: the W-way session table against its
  ``DictOracle`` (the sequential NumPy model of insert, election and
  sweep). Its kernel drivers (``_kernel_insert``, ``_kernel_sweep``,
  ``jax.jit`` of the reference's ``hashmap_insert`` / ``_sweep_one``)
  are replaced by drivers of the port's, and its ``jnp`` by one that
  builds the port's tensors (uint32 columns read as their values);
  the oracle, the churn generator and every assertion are the
  reference's;
* ``test_session_hardening.py``, ``test_snat.py`` (``pipeline_step``
  over a CPU ``TableBuilder``'s tables), ``test_acl_mxu.py``,
  ``test_governor.py``, ``test_native_ring.py``, ``test_ksr.py``,
  ``test_codec_fuzz.py`` (hypothesis) and ``test_concurrency.py``.

``NOT_RUN`` names every case that does not run here, with the reason;
``test_two_node_e2e.py`` is not run here but in
``tests/test_torch_two_node_e2e.py`` (see ``SUITES_NOT_RUN``).
Every quantity compared is an integer or a boolean: the tolerance is
exact equality.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

# the reference suites and every reference module they reach, imported
# here, outside any ``port_imports`` block (which drops the reference
# modules first imported inside it)
import test_acl_mxu as jacl_mxu_tests
import test_codec_fuzz as jcodec_tests
import test_concurrency as jconc_tests
import test_governor as jgov_tests
import test_ksr as jksr_tests
import test_native_ring as jring_tests
import test_session_hardening as jhard_tests
import test_session_table as jtable_tests
import test_snat as jsnat_tests
import vpp_tpu.ops.session  # noqa: F401
import vpp_tpu.pipeline.persistent  # noqa: F401
import vpp_tpu.stats.collector  # noqa: F401
import vpp_tpu.testing.faults  # noqa: F401
from test_torch_fleet import FLEET_JNP, _cases, _ids
from test_torch_hoststack import run_case
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline.vector import to_i32, u32

_M32 = 0xFFFFFFFF


# --- the session table's drivers on the port ------------------------------

class _Dtype:
    """A ``jnp`` dtype of the suite: callable as a scalar constructor,
    and the dtype argument of ``zeros``. uint32 values live in int64
    tensors (the oracle reads them as values), int32 in int32."""

    def __init__(self, unsigned: bool):
        self.unsigned = unsigned
        self.torch = torch.int64 if unsigned else torch.int32

    def __call__(self, x=0) -> torch.Tensor:
        x = int(x)
        return torch.tensor(x & _M32 if self.unsigned else x,
                            dtype=self.torch)


def _asarray(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.int64) if a.dtype == np.uint32 else a))


TABLE_JNP = types.SimpleNamespace(
    int32=_Dtype(False), uint32=_Dtype(True), asarray=_asarray,
    zeros=lambda shape, dtype: torch.zeros(shape, dtype=dtype.torch),
    sum=lambda a, *k, **kw: np.asarray(a).sum(*k, **kw))

_COLUMNS = ("valid", "time", "k0", "k1", "k2", "k3", "e0")


def _port_insert(t, kv, ev, want, now, max_age):
    """``_kernel_insert`` on the port: the bucket hash and the batched
    insert of ``ops.session`` on int32 bit patterns of the columns."""
    nb = t["valid"].shape[0]
    kv = kv.to(torch.int64)
    key_vals = (to_i32(kv[:, 0]), to_i32(kv[:, 1]), to_i32(kv[:, 2]),
                to_i32(kv[:, 3]))
    h = tsess._bucket(tsess._hash_mix(*key_vals), nb)
    cols = {k: to_i32(t[k]) for k in _COLUMNS}
    masks = tsess.hashmap_insert(
        cols["valid"], cols["time"],
        (cols["k0"], cols["k1"], cols["k2"], cols["k3"]), key_vals,
        (cols["e0"],), (to_i32(ev[:, 0].to(torch.int64)),), h,
        want.to(torch.bool), now, max_age=max_age)
    out = dict(t)
    out.update({k: u32(v) if t[k].dtype == torch.int64 else v
                for k, v in cols.items()})
    return out, h, masks


def _port_sweep(t, now, max_age, stride):
    """``_kernel_sweep`` on the port: one stride of ``_sweep_one``."""
    valid, cursor = t["valid"].clone(), t["cursor"].clone()
    tsess._sweep_one(valid, t["time"], cursor, now, max_age, stride)
    return dict(t, valid=valid, cursor=cursor)


def _port_hash(src, dst, ports, proto, n_buckets):
    """The reference's ``_hash`` (mix, then bucket) on the port."""
    return tsess._bucket(tsess._hash_mix(src, dst, ports, proto),
                         n_buckets)


TABLE_NAMES = {
    "jnp": TABLE_JNP, "_kernel_insert": _port_insert,
    "_kernel_sweep": _port_sweep,
    "sess_ops": types.SimpleNamespace(_hash=_port_hash),
}


class CpuTableBuilder(ttables.TableBuilder):
    """The port's TableBuilder with its tables on the CPU."""

    def __init__(self, config=None, device="cpu"):
        super().__init__(config, device=device)


SNAT_NAMES = {"jnp": TABLE_JNP, "TableBuilder": CpuTableBuilder}


@pytest.fixture()
def port_capture_budget(request):
    """The reference's ``jit_compile_budget`` on the port: its compile
    unit is a captured step part (``capture.capture_budget``), with the
    budget of the reference case's ``jit_budget`` mark."""
    from vpp_tpu_torch.pipeline import capture

    name, case, _kw = request.node.callspec.params["case"]
    budget = _mark_args(SUITES[name][0], case).get("jit_budget", (0,))[0]
    with capture.capture_budget(int(budget)) as guard:
        yield guard


# --- the cases ------------------------------------------------------------

SUITES = {
    "session_table": (jtable_tests, TABLE_NAMES,
                      {"jit_compile_budget": "port_capture_budget"}),
    "session_hardening": (jhard_tests, {"jnp": FLEET_JNP}),
    "snat": (jsnat_tests, SNAT_NAMES),
    "acl_mxu": (jacl_mxu_tests, {"jnp": FLEET_JNP}),
    "governor": (jgov_tests, {"jnp": FLEET_JNP}),
    "native_ring": (jring_tests, {}),
    "ksr": (jksr_tests, {}),
    "codec_fuzz": (jcodec_tests, {}),
    "concurrency": (jconc_tests, {}),
}

_ONE_ELECTION = ("the port has one insert election (the stable sort, "
                 "ops/session.py _bucket_reps); the claim / sort "
                 "comparison has nothing to compare")
_MXU_INTERNALS = ("the reference's bf16 bit-plane operand and its "
                  "interpret-mode Pallas kernel; the port's MXU operand "
                  "is int8 with k folded in, held against these in "
                  "tests/test_torch_acl_mxu.py")
# the cases that do not run here, and why
NOT_RUN = {
    ("session_table",
     "TestRepWindowStrategies.test_claim_equals_sort_across_bit_regimes"):
        _ONE_ELECTION,
    ("session_hardening",
     "TestElectionStrategies.test_claim_and_sort_elections_identical"):
        _ONE_ELECTION,
    ("session_hardening",
     "TestWallClockAging.test_expiry_follows_wall_clock_not_load"):
        "wall-clock case: 51 eager CPU steps must take less than the "
        "5 s session age, which a loaded CPU under parallel workers "
        "does not promise (the port's steps are eager PyTorch on the "
        "CPU); the aging logic itself runs in the other cases here",
    ("acl_mxu", "test_bitplane_matches_dense"): _MXU_INTERNALS,
    ("acl_mxu", "test_pallas_kernel_interpret_matches_reference"):
        _MXU_INTERNALS,
    ("acl_mxu", "test_range_rules_fall_back"): _MXU_INTERNALS,
    ("acl_mxu", "test_dataplane_flips_to_mxu_path"):
        "reads the reference's private ``Dataplane._use_mxu`` (the "
        "port's is ``classifier_impl == 'mxu'``, held in "
        "tests/test_torch_acl_mxu.py)",
    ("acl_mxu", "TestIncrementalCompile.test_matches_full_compile_across_churn"):
        _MXU_INTERNALS,
    ("acl_mxu", "TestIncrementalCompile.test_snapshot_restore_invalidates_cache"):
        _MXU_INTERNALS,
    ("governor",
     "TestGovernorHostSideOnly.test_stager_preempts_window_with_backlog_queued"):
        "builds the reference's PersistentPump(tables, fastpath=, "
        "classifier=, ...) by hand; the port's takes the dataplane "
        "(PersistentPump(dp, batch, ring_slots, ring_windows)) and "
        "checks its window program out of it",
    ("native_ring", "test_cross_process_transport"):
        "its child process unpickles the reference test module's "
        "producer by name, which a rebound function is not",
}
def _mark_args(module, case: str) -> dict:
    """{mark name: its arguments} of a case and of its class."""
    parts = case.split(".")
    objs = [vars(module)[parts[0]]]
    if len(parts) == 2:
        objs.append(vars(objs[0])[parts[1]])
    return {mk.name: mk.args for o in objs
            for mk in getattr(o, "pytestmark", ())}


# the reference marks these slow: the driver's run skips the
# reference's own copy, and so does this file
SLOW = {(n, c) for n, (m, *_) in SUITES.items() for c, _kw in _cases(m)
        if "slow" in _mark_args(m, c)}
SUITES_NOT_RUN = {
    "test_two_node_e2e.py":
        "two init-supervised node processes on host-global names (netns "
        "vppt2-poda/b, veth vppt2-faba/b, /tmp/vppt2-run): run beside "
        "the reference's own copy under parallel workers, either would "
        "take the other's netns and links. Its port run, with those "
        "names rewritten, is tests/test_torch_two_node_e2e.py",
}

CASES = [(name, c, kw) for name, (m, *_) in SUITES.items()
         for c, kw in _cases(m)
         if (name, c) not in NOT_RUN and (name, c) not in SLOW]


def test_case_lists():
    """Every case of the nine suites is run here, listed in
    ``NOT_RUN`` with its reason, or slow-marked in the reference."""
    every = {(n, c) for n, (m, *_) in SUITES.items()
             for c, _ in _cases(m)}
    assert set(NOT_RUN) <= every
    ran = {(n, c) for n, c, _ in CASES}
    assert ran | set(NOT_RUN) | SLOW == every
    assert len(ran) == 67


@pytest.mark.parametrize(
    "case", CASES,
    ids=[f"{n}-{i}" for n, i in zip(
        [c[0] for c in CASES], _ids([(c, kw) for _, c, kw in CASES]))])
def test_reference_suite_cases(case, request):
    name, c, kw = case
    module, names, *fixtures = SUITES[name]
    run_case(module, c, request, fixtures=fixtures[0] if fixtures else None,
             names=names, params=kw)
