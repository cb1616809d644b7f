"""The partition-rule layer: field name -> placement on the (node, rule) mesh.

The PyTorch counterpart of ``vpp_tpu/parallel/partition.py``. Every
``DataplaneTables`` field gets its placement from ONE ordered rule list
(first match wins); a field no rule matches is an error
(``PartitionError``), never a silent replicate. ``spec_manifest()`` names
every field's spec and the rule that assigned it; ``partition_lint()``
fails on an unmatched field, a stale rule, or a tenant or service plane
that resolves rule-sharded.

The rules' reasons are the reference's text: its ``pmin`` and ``psum``
over the rule axis are a min and a sum over a node's shards here. A
spec (``PartitionSpec``, a tuple of axis names) says, per dimension of
the node-stacked field, which mesh axis splits it: ``node`` the leading
node dimension, ``rule`` the dimension the rule shards split in blocks,
None a dimension every shard holds whole. There is no device sharding
here: the cluster holds each field node-stacked on its one device, and a
shard's block is a view (vpp_tpu_torch/parallel/cluster.py). The
shipped rules are the reference's, plus one each for the port's five
derived fields (``pipeline/tables.py`` ``DERIVED_FIELDS``): the LPM
stack, replicated along the rule axis like the planes it is built from,
and the MXU kernel operand ``glb_mxu_op``, rule-row sharded but built
per shard: shard s's rows come from ITS column block of
``glb_mxu_coeff`` / ``glb_mxu_k``, swizzled by shard-local row (the
swizzle is ``c ^ (r % 8)`` of the row in the operand a kernel launch
reads), so it is held ``[S, R'/S, PLANES]`` and is not a row slice of
the standalone operand.

The ladders (``select_impl``, ``select_fib_impl``,
``select_session_impl``) live in pipeline/selection.py and are re-exported
here, where the reference defines them; ``agree_ml``, ``ShardCtx``,
``validate_partitioning`` and ``bv_mesh_ok`` are the reference's.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

from vpp_tpu_torch.pipeline.selection import (
    select_fib_impl,
    select_impl,
    select_session_impl,
)
from vpp_tpu_torch.pipeline.tables import DataplaneTables, natsess_slots_of

__all__ = [
    "NODE_AXIS", "RULE_AXIS", "PartitionSpec", "P", "PartitionError",
    "PartitionRule", "SpecEntry", "PARTITION_RULES",
    "match_partition_rules", "spec_for", "spec_manifest", "table_specs",
    "rule_sharded_fields", "rule_dim", "partition_lint", "select_impl",
    "select_fib_impl", "select_session_impl", "agree_ml", "ShardCtx",
    "validate_partitioning", "bv_mesh_ok",
]

NODE_AXIS = "node"
RULE_AXIS = "rule"


class PartitionSpec(tuple):
    """The axis name (or None) of each dimension of a node-stacked
    field; trailing dimensions not named are whole. Equal to the
    reference's ``jax.sharding.PartitionSpec`` of the same axes."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self) -> str:
        return "P({})".format(", ".join(map(repr, self)))


P = PartitionSpec


class PartitionError(ValueError):
    """A DataplaneTables field resolved to no partition rule."""


class PartitionRule(NamedTuple):
    """One ordered rule: fields whose name ``re.search``-matches
    ``pattern`` take ``spec``; ``reason`` documents the axis choice."""

    pattern: str
    spec: tuple
    reason: str


class SpecEntry(NamedTuple):
    """One manifest row: the resolved placement of one field."""

    field: str
    spec: tuple
    pattern: str
    reason: str


# The ordered rule set. FIRST MATCH WINS: the boundary / count rules
# outrank the glb_bv_ bitmap rule, sess_max_age the bucket-grid rule,
# the derived fields' rules the glb_ / fib_ families they sit in.
PARTITION_RULES: Tuple[PartitionRule, ...] = (
    # --- BV interval-bitmap structure (ops/acl_bv.py) ---
    PartitionRule(r"^glb_bv_(bnd_|nbnd$)", P(NODE_AXIS),
                  "interval boundaries span ALL rules (segment space is "
                  "data-dependent): replicated along the rule axis"),
    PartitionRule(r"^glb_bv_proto$", P(NODE_AXIS, None, RULE_AXIS),
                  "[PR, W] direct proto plane: rule-WORD axis sharded"),
    PartitionRule(r"^glb_bv_", P(NODE_AXIS, None, RULE_AXIS),
                  "[I, W] segment->rule bitmaps: rule-WORD axis sharded "
                  "(per-shard word-AND + encoded pmin first-match)"),
    # --- per-packet ML model (ops/mlscore.py) ---
    PartitionRule(r"^glb_ml_w1$", P(NODE_AXIS, None, RULE_AXIS),
                  "[F, H] layer-1 weights: hidden axis sharded (partial "
                  "matmul + psum, bit-exact integer reduce)"),
    PartitionRule(r"^glb_ml_(b1|w2)$", P(NODE_AXIS, RULE_AXIS),
                  "[H] hidden-axis vectors follow the W1 column shards"),
    PartitionRule(r"^glb_ml_f_", P(NODE_AXIS, RULE_AXIS),
                  "[T, ...] forest planes: tree axis sharded (partial "
                  "vote sums + psum)"),
    PartitionRule(r"^glb_ml_", P(NODE_AXIS),
                  "model scalars (shift/bias/threshold/policy/version): "
                  "replicated along the rule axis"),
    # --- global ACL dense rows + MXU bit-planes (ops/acl.py, acl_mxu) --
    PartitionRule(r"^glb_nrules$", P(NODE_AXIS),
                  "rule-count scalar: replicated (the unmatched-default "
                  "fold needs the FULL count on every shard)"),
    PartitionRule(r"^glb_mxu_op$", P(NODE_AXIS, RULE_AXIS),
                  "[R', PLANES] int8 kernel operand (derived): rule-row "
                  "sharded, each shard's rows built from its own column "
                  "block of glb_mxu_coeff / glb_mxu_k and swizzled by "
                  "shard-local row (held [S, R'/S, PLANES])"),
    PartitionRule(r"^glb_mxu_coeff$", P(NODE_AXIS, None, RULE_AXIS),
                  "[PLANES, R'] bit-plane coeffs: rule-column sharded"),
    PartitionRule(r"^glb_", P(NODE_AXIS, RULE_AXIS),
                  "dense rule rows + MXU k/act: rule-row sharded "
                  "(per-shard first-match + encoded pmin)"),
    # --- session bucket grids (ops/session.py) ---
    PartitionRule(r"^sess_max_age$", P(NODE_AXIS),
                  "timeout scalar: replicated"),
    PartitionRule(r"^(sess|natsess)_sweep_cursor$", P(NODE_AXIS),
                  "sweep cursors: replicated — every shard's local ring "
                  "has identical geometry and advances identically"),
    PartitionRule(r"^(sess|natsess)_", P(NODE_AXIS, RULE_AXIS),
                  "[NB, W] bucket grids: bucket axis sharded (global "
                  "flow hash, contiguous bucket-range ownership; "
                  "lookup/insert/sweep/aging shard-local)"),
    # --- multi-tenant planes: replicated (partition_lint enforces it) --
    PartitionRule(r"^tnt_", P(NODE_AXIS),
                  "per-tenant vectors (prefix map, token buckets, "
                  "slice base/mask in GLOBAL bucket units, accounting "
                  "planes): replicated along the rule axis so tenant "
                  "slices compose with the bucket-axis session shards "
                  "bit-exactly"),
    # --- replicated-by-design ledger -------------------------------
    PartitionRule(r"^acl_", P(NODE_AXIS),
                  "per-interface local tables are small (max_rules "
                  "rows): replicated-by-design along the rule axis"),
    PartitionRule(r"^if_", P(NODE_AXIS),
                  "interface attributes: per-node config, "
                  "replicated-by-design"),
    PartitionRule(r"^fib_lpm_(lens|stk_cnt|stk_pfx|stk_slot)$",
                  P(NODE_AXIS),
                  "LPM stack (derived from the length planes each swap): "
                  "the populated lengths and their stacked prefix / slot "
                  "planes, replicated along the rule axis like the "
                  "planes themselves"),
    PartitionRule(r"^fib_(lpm_|grp|ecmp_c)", P(NODE_AXIS),
                  "LPM length planes / ECMP member tables / per-member "
                  "accounting: per-node routing state, replicated "
                  "along the rule axis (lookups are pure gathers — "
                  "every shard holds the whole FIB)"),
    PartitionRule(r"^fib_", P(NODE_AXIS),
                  "FIB slots: per-node routing config, "
                  "replicated-by-design"),
    PartitionRule(r"^(nat_|natb_)", P(NODE_AXIS),
                  "NAT mappings/backends: per-node service config, "
                  "replicated-by-design"),
    PartitionRule(r"^svc_", P(NODE_AXIS),
                  "service VIP rows + backend way tables: per-node "
                  "service config, replicated-by-design along the "
                  "rule axis (the backend pick gathers whole rows)"),
    PartitionRule(r"^ovl_", P(NODE_AXIS),
                  "overlay config scalars (local VTEP): per-node "
                  "tunnel config, replicated-by-design"),
    PartitionRule(r"^tel_", P(NODE_AXIS),
                  "telemetry planes: cluster node configs keep the "
                  "knob off (placeholder shapes), replicated-by-design"),
)


def match_partition_rules(
    name: str, rules: Tuple[PartitionRule, ...] = PARTITION_RULES,
) -> Optional[PartitionRule]:
    """First rule whose pattern matches ``name`` (None = unmatched)."""
    for rule in rules:
        if re.search(rule.pattern, name) is not None:
            return rule
    return None


def _unmatched(name: str) -> PartitionError:
    return PartitionError(
        f"DataplaneTables field {name!r} matches no partition rule "
        "(vpp_tpu_torch/parallel/partition.py PARTITION_RULES): add a "
        "sharding rule or a replicated-by-design entry")


def spec_for(name: str,
             rules: Tuple[PartitionRule, ...] = PARTITION_RULES) -> tuple:
    """The spec of one field; an unmatched field raises."""
    rule = match_partition_rules(name, rules)
    if rule is None:
        raise _unmatched(name)
    return rule.spec


def spec_manifest(rules: Tuple[PartitionRule, ...] = PARTITION_RULES
                  ) -> Dict[str, SpecEntry]:
    """Every DataplaneTables field's resolved placement, in field order;
    raises PartitionError on an unmatched field (building it IS the
    completeness check)."""
    out: Dict[str, SpecEntry] = {}
    for f in DataplaneTables._fields:
        rule = match_partition_rules(f, rules)
        if rule is None:
            raise _unmatched(f)
        out[f] = SpecEntry(field=f, spec=rule.spec, pattern=rule.pattern,
                           reason=rule.reason)
    return out


def table_specs() -> DataplaneTables:
    """The spec of every field as a DataplaneTables."""
    return DataplaneTables(**{f: e.spec
                              for f, e in spec_manifest().items()})


def rule_dim(spec) -> Optional[int]:
    """The dimension of a PER-NODE tensor (the node axis dropped) that
    the rule axis splits, or None when the field is replicated."""
    for i, ax in enumerate(tuple(spec)[1:]):
        if ax == RULE_AXIS:
            return i
    return None


def rule_sharded_fields() -> Tuple[str, ...]:
    """Fields whose spec names the rule axis."""
    return tuple(f for f, e in spec_manifest().items()
                 if RULE_AXIS in tuple(e.spec))


def partition_lint() -> List[str]:
    """Every field resolves to a rule, every rule matches a field, no
    tenant or service plane resolves rule-sharded, both axes are used.
    Returns problem strings."""
    problems: List[str] = []
    hit = [0] * len(PARTITION_RULES)
    for f in DataplaneTables._fields:
        for i, rule in enumerate(PARTITION_RULES):
            if re.search(rule.pattern, f) is not None:
                hit[i] += 1
                break
        else:
            problems.append(
                f"partitions: DataplaneTables field {f!r} matches no "
                "partition rule (add a sharding rule or a "
                "replicated-by-design entry)")
    for i, rule in enumerate(PARTITION_RULES):
        if not hit[i]:
            problems.append(
                f"partitions: rule {rule.pattern!r} matches no "
                "DataplaneTables field (stale rule?)")
    for f in DataplaneTables._fields:
        tenant = f.startswith("tnt_") or f.startswith("glb_ml_tnt_")
        if not (tenant or f.startswith("svc_")):
            continue
        rule = match_partition_rules(f)
        if rule is None or RULE_AXIS not in tuple(rule.spec):
            continue
        what = "tenant plane" if tenant else "service plane"
        problems.append(
            f"partitions: {what} {f!r} resolves rule-sharded "
            f"({rule.pattern!r}) — it must replicate along the rule axis")
    if not problems:
        entries = spec_manifest()
        for ax in (NODE_AXIS, RULE_AXIS):
            if not any(ax in tuple(e.spec) for e in entries.values()):
                problems.append(
                    f"partitions: mesh axis {ax!r} is named by no spec")
    return problems


def agree_ml(ml_stage: str, kinds) -> Tuple[str, str]:
    """The ML-stage agreement rule of a multi-node plane: ``kinds`` is
    the set of staged model kinds across nodes (0 none, -1 a node with
    internally mixed kinds); the stage engages only when every node
    staged a model of the SAME kind. Returns (ml_mode, ml_kind)."""
    kinds = set(int(k) for k in kinds)
    if ml_stage != "off" and len(kinds) == 1 and kinds not in ({0}, {-1}):
        return ml_stage, ("forest" if kinds == {2} else "mlp")
    return "off", "mlp"


class ShardCtx(NamedTuple):
    """The rule-shard context the sharded stages thread: the axis name
    and its size (None everywhere standalone)."""

    axis: str
    shards: int


def validate_partitioning(config, rule_shards: int) -> None:
    """Fail fast on a config whose sharded axes don't divide by
    ``rule_shards`` (session / NAT bucket grids; the ML hidden and tree
    axes with the stage on), and on an explicit ``pallas`` knob: the
    fused kernels do not shard (``auto`` stays legal and resolves the
    sharded rungs)."""
    if rule_shards <= 1:
        return
    for knob_name, sharded_rung in (("classifier", "bv"),
                                    ("fib_impl", "lpm"),
                                    ("session_impl", "gather")):
        if getattr(config, knob_name, None) == "pallas":
            raise ValueError(
                f"dataplane.{knob_name}: the pallas rung does not "
                f"shard across {rule_shards} rule shards — no "
                "PARTITION_RULES spec covers the fused kernels yet. "
                f"Use '{sharded_rung}' or 'auto' on a mesh (auto "
                "selects the sharded rungs)")
    ways = int(getattr(config, "sess_ways", 4))
    for name, slots in (("sess_slots", config.sess_slots),
                        ("natsess_slots", natsess_slots_of(config))):
        buckets = slots // ways
        if buckets % rule_shards:
            raise ValueError(
                f"dataplane.{name}: {buckets} buckets "
                f"({slots} slots / {ways} ways) not divisible by "
                f"{rule_shards} rule shards")
    if getattr(config, "ml_stage", "off") != "off":
        hidden = int(getattr(config, "ml_hidden", 16))
        trees = int(getattr(config, "ml_trees", 4))
        if hidden % rule_shards:
            raise ValueError(
                f"dataplane.ml_hidden {hidden} not divisible by "
                f"{rule_shards} rule shards")
        if trees % rule_shards:
            raise ValueError(
                f"dataplane.ml_trees {trees} not divisible by "
                f"{rule_shards} rule shards")


def bv_mesh_ok(config, rule_shards: int) -> bool:
    """Whether the BV structure can serve this mesh: the word axis and
    the dense action rows shard into aligned blocks, i.e.
    ``max_global_rules`` divisible by ``32 * shards``."""
    from vpp_tpu_torch.ops.acl_bv import bv_enabled_for

    if not bv_enabled_for(config):
        return False
    if rule_shards <= 1:
        return True
    return config.max_global_rules % (32 * rule_shards) == 0
