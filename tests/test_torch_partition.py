"""The partition layer: vpp_tpu_torch/parallel/partition.py and the
sharded stages against vpp_tpu's.

* Every case of ``tests/test_partition.py`` but the reference's own lint
  hook runs on the port, the two it marks slow included
  (``test_torch_hoststack.run_case``: the module's names and imports
  bound to the port, meshes on the CPU): the rule-matching
  units, the 2-way BV + ML + session mesh against a standalone
  ``Dataplane``, the cluster snapshot's round trip and its refusal on
  another geometry, the incremental per-shard upload and the CLI and
  gauges. ``NOT_RUN`` names the rest, with the reason.
* The spec manifest equals the reference's for every reference field
  (spec, rule and reason), and the port's five derived fields resolve
  to their own rules, ahead of the ``glb_`` / ``fib_`` families.
* The sharded stages against the reference's under ``shard_map`` on its
  virtual CPU mesh, at S = 2 and 4: the session lookup and insert, the
  NAT reverse and record, the MLP and forest partial scores, on the same
  NumPy-seeded state and packets (the reference's tables carried over
  with ``interop.tables_from_numpy``).

Every quantity compared is an integer or a string: the tolerance is
exact equality.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import test_partition as jpart_tests
from test_torch_agent import case_names
from test_torch_hoststack import run_case
from vpp_tpu.ml import train as jtrain
from vpp_tpu.ops import mlscore as jml
from vpp_tpu.ops import nat44 as jnat
from vpp_tpu.ops import session as jsess
from vpp_tpu.parallel import partition as jpt
from vpp_tpu.pipeline import dataplane as jdataplane
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch import interop
from vpp_tpu_torch.ops import mlscore as tml
from vpp_tpu_torch.ops import nat44 as tnat
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.parallel import partition as tpt
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

# --- the reference's suite on the port -----------------------------------


NOT_RUN = {
    "test_partitions_lint_pass_green":
        "runs the reference's tools/lint.py over vpp_tpu/ (its own "
        "tooling, which reads modules by their reference names); the "
        "port's partition_lint() is held to [] in "
        "test_manifest_is_the_references_for_every_reference_field",
}
PARTITION_CASES = [c for c in case_names(jpart_tests) if c not in NOT_RUN]


def test_case_list():
    """14 of the 15 cases run, the two the reference marks slow (its
    4-way and forest compiles) among them; NOT_RUN names the one left."""
    assert len(PARTITION_CASES) == 14 and len(NOT_RUN) == 1


@pytest.mark.parametrize("case", PARTITION_CASES)
def test_reference_partition_cases(case, request):
    # ``pt`` is the port's module itself (not its import alias), so a
    # case's monkeypatch of PARTITION_RULES reaches partition_lint
    run_case(jpart_tests, case, request, names={"pt": tpt})


# --- the manifest ----------------------------------------------------------

def test_manifest_is_the_references_for_every_reference_field():
    ref, port = jpt.spec_manifest(), tpt.spec_manifest()
    assert set(ref) <= set(port)
    for f, e in ref.items():
        p = port[f]
        assert (tuple(p.spec), p.pattern, p.reason) == (
            tuple(e.spec), e.pattern, e.reason), f
    assert tpt.partition_lint() == []
    assert set(port) - set(ref) == set(ttables.DERIVED_FIELDS)


def test_derived_fields_have_their_own_rules():
    """The LPM stack replicates along the rule axis, the MXU operand is
    rule-row sharded; each rule precedes the family rule the field
    would otherwise fall into, and lint flags neither."""
    m = tpt.spec_manifest()
    rules = [r.pattern for r in tpt.PARTITION_RULES]
    for f in ("fib_lpm_lens", "fib_lpm_stk_cnt", "fib_lpm_stk_pfx",
              "fib_lpm_stk_slot"):
        assert m[f].spec == (tpt.NODE_AXIS,)
        assert m[f].pattern == r"^fib_lpm_(lens|stk_cnt|stk_pfx|stk_slot)$"
    assert rules.index(m["fib_lpm_lens"].pattern) < rules.index(
        r"^fib_(lpm_|grp|ecmp_c)")
    assert m["glb_mxu_op"].spec == (tpt.NODE_AXIS, tpt.RULE_AXIS)
    assert rules.index(m["glb_mxu_op"].pattern) < rules.index(r"^glb_")
    assert tpt.rule_dim(m["glb_mxu_op"].spec) == 0
    assert tpt.rule_dim(m["glb_mxu_coeff"].spec) == 1
    assert tpt.rule_dim(m["fib_lpm_stk_pfx"].spec) is None
    # without their rules, the derived fields would fall into the
    # families (and the operand's rows would not be its own blocks)
    bare = tuple(r for r in tpt.PARTITION_RULES
                 if r.pattern not in (m["glb_mxu_op"].pattern,
                                      m["fib_lpm_lens"].pattern))
    assert tpt.match_partition_rules("glb_mxu_op", bare).pattern == r"^glb_"


# --- the sharded stages against the reference's under shard_map ------------

CFG = dict(max_tables=2, max_rules=8, max_global_rules=64, max_ifaces=8,
           fib_slots=16, sess_slots=256, nat_mappings=2, nat_backends=4,
           ml_stage="score", ml_hidden=8, ml_trees=4, ml_depth=2)
NOW = 40


def _packets(seed, n=32):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(dict(src=f"10.{int(rng.integers(0, 4))}.0.{i + 1}",
                        dst=f"10.9.{int(rng.integers(0, 2))}.1",
                        proto=int(rng.choice([6, 17])),
                        sport=int(rng.integers(1000, 1100)),
                        dport=int(rng.integers(80, 84)), rx_if=1))
    return out


def _reversed(pk):
    return [dict(p, src=p["dst"], dst=p["src"], sport=p["dport"],
                 dport=p["sport"]) for p in pk]


@functools.lru_cache(maxsize=None)
def _state(kind: str):
    """The reference's tables (a staged model of ``kind``) with sessions
    and NAT sessions installed by its unsharded ops, as NumPy."""
    model, _ = jtrain.train_and_pack(kind=kind, hidden=8, trees=4,
                                     depth=2, seed=11)
    dp = jdataplane.Dataplane(jtables.DataplaneConfig(**CFG))
    dp.builder.set_ml_model(model)
    dp.swap()
    t = dp.tables
    pk = jvector.make_packet_vector(_packets(1), n=32)
    want = np.arange(32) % 3 != 0
    t = jsess.session_insert(t, pk, want, np.int32(NOW - 5))[0]
    kind_bits = np.arange(32, dtype=np.int32) % 3 + 1
    t = jnat.nat44_record(t, pk, pk.dst_ip, pk.dport, pk.src_ip, pk.sport,
                          kind_bits, want, np.int32(NOW - 5))[0]
    return {f: np.asarray(getattr(t, f)) for f in t._fields}


def _ref_sharded(arrays, shards, fn, out_specs):
    """``fn(tables, shard)`` on the reference's tables under shard_map
    over ``shards`` rule shards: the session grids and the ML planes
    split as the partition layer says, the rest whole."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:shards]), (jpt.RULE_AXIS,))
    specs = {}
    for f, e in jpt.spec_manifest().items():
        split = f.startswith(("sess_", "natsess_", "glb_ml_"))
        specs[f] = P(*tuple(e.spec)[1:]) if split else P()
    t = jtables.DataplaneTables(**{f: jax.numpy.asarray(a)
                                   for f, a in arrays.items()})
    t_specs = jtables.DataplaneTables(**specs)
    body = jpt.shard_map(
        lambda tt: fn(tt, jpt.ShardCtx(jpt.RULE_AXIS, shards)), mesh=mesh,
        in_specs=(t_specs,), out_specs=out_specs, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(body)(t))


def _port_tables(arrays):
    return interop.tables_from_numpy(
        {f: a for f, a in arrays.items() if f in ttables.HOST_FIELDS
         or f in ttables.STATE_FIELDS}, "cpu")


def _bits(x):
    a = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_equal(ref, port):
    ref_l = [x for x in np.asarray(ref, dtype=object).ravel()] \
        if not isinstance(ref, (tuple, list)) else list(ref)
    assert len(ref_l) == len(port)
    for i, (a, b) in enumerate(zip(ref_l, port)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(i))


SESS_COLS = ("sess_src", "sess_dst", "sess_ports", "sess_proto",
             "sess_valid", "sess_time")
NAT_COLS = ("natsess_a", "natsess_b", "natsess_ports", "natsess_proto",
            "natsess_valid", "natsess_time", "natsess_orig_ip",
            "natsess_orig_port", "natsess_src_ip", "natsess_sport",
            "natsess_kind")


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_session_and_nat_ops_equal_the_references(shards):
    from jax.sharding import PartitionSpec as P

    arrays = _state("mlp")
    mix = _reversed(_packets(1))[:16] + _packets(2)[:16]
    jp = jvector.make_packet_vector(mix, n=32)
    tp = tvector.make_packet_vector(mix, n=32)
    want = np.arange(32) % 4 != 1
    kind_bits = np.arange(32, dtype=np.int32) % 3 + 1
    rows, rep = P(jpt.RULE_AXIS), P()

    # the reverse lookup: (found, the global slot; 0 on a miss)
    ref = _ref_sharded(arrays, shards, lambda t, s:
                       jsess.session_lookup_reverse_idx(t, jp, NOW, shard=s),
                       (rep, rep))
    t = _port_tables(arrays)
    port = tsess.session_lookup_reverse_idx(
        t, tp, NOW, shard=tpt.ShardCtx("rule", shards))
    _assert_equal(ref, port)
    assert ref[0].any() and not ref[0].all()

    # the insert: every outcome mask and the written columns
    def insert(t, s):
        t2, *masks = jsess.session_insert(t, jp, want, np.int32(NOW), shard=s)
        return tuple(getattr(t2, f) for f in SESS_COLS), tuple(masks)
    ref = _ref_sharded(arrays, shards, insert,
                       ((rows,) * len(SESS_COLS), (rep,) * 4))
    t = _port_tables(arrays)
    _, *masks = tsess.session_insert(t, tp, torch.from_numpy(want), NOW,
                                     shard=tpt.ShardCtx("rule", shards))
    _assert_equal(ref[0], [getattr(t, f) for f in SESS_COLS])
    _assert_equal(ref[1], masks)

    # the NAT reverse: the rewritten header, applied, the slot
    def reverse(t, s):
        out, applied, idx = jnat.nat44_reverse(t, jp, jp.valid == 1, NOW,
                                               shard=s)
        return tuple(out), applied, idx
    ref = _ref_sharded(arrays, shards, reverse,
                       ((rep,) * len(jp), rep, rep))
    t = _port_tables(arrays)
    out, applied, idx = tnat.nat44_reverse(
        t, tp, tp.valid, NOW, shard=tpt.ShardCtx("rule", shards))
    _assert_equal(ref[0], list(out))
    _assert_equal([ref[1], ref[2]], [applied, idx])

    # the NAT record
    def record(t, s):
        t2, *masks = jnat.nat44_record(t, jp, jp.dst_ip, jp.dport, jp.src_ip,
                                       jp.sport, kind_bits, want,
                                       np.int32(NOW), shard=s)
        return tuple(getattr(t2, f) for f in NAT_COLS), tuple(masks)
    ref = _ref_sharded(arrays, shards, record,
                       ((rows,) * len(NAT_COLS), (rep,) * 4))
    t = _port_tables(arrays)
    _, *masks = tnat.nat44_record(
        t, tp, tp.dst_ip, tp.dport, tp.src_ip, tp.sport,
        torch.from_numpy(kind_bits), torch.from_numpy(want), NOW,
        shard=tpt.ShardCtx("rule", shards))
    _assert_equal(ref[0], [getattr(t, f) for f in NAT_COLS])
    _assert_equal(ref[1], masks)


@pytest.mark.parametrize("kind", ["mlp", "forest"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_ml_scores_equal_the_references(kind, shards):
    """The hidden-axis (MLP) or tree-axis (forest) partial scores, summed
    over the shards, then the output bias."""
    from jax.sharding import PartitionSpec as P

    arrays = _state(kind)
    mix = _reversed(_packets(1))[:16] + _packets(3)[:16]
    jp = jvector.make_packet_vector(mix, n=32)
    tp = tvector.make_packet_vector(mix, n=32)
    est = np.arange(32) % 2 == 0
    age = (np.arange(32, dtype=np.int32) * 7) % 300
    ref = _ref_sharded(arrays, shards, lambda t, s: jml.ml_score(
        t, jp, est, age, kind=kind, shard=s), P())
    port = tml.ml_score(_port_tables(arrays), tp, torch.from_numpy(est),
                        torch.from_numpy(age), kind=kind,
                        shard=tpt.ShardCtx("rule", shards))
    np.testing.assert_array_equal(ref, port.numpy())
    # and the unsharded score is the same
    np.testing.assert_array_equal(ref, tml.ml_score(
        _port_tables(arrays), tp, torch.from_numpy(est),
        torch.from_numpy(age), kind=kind).numpy())
