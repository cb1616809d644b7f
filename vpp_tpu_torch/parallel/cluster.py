"""The cluster step: N vswitch nodes on one (node, rule) mesh.

The PyTorch counterpart of ``vpp_tpu/parallel/cluster.py``. Each mesh
row runs the full single-node pipeline over its own tables, and
inter-node traffic crosses the fabric in one exchange per step; the
node-global ACL table, the ML planes and the session grids are split
over the rule shards (parallel/partition.py). A cluster step is: pass 1,
the ingress node's pipeline -> the packets with a REMOTE disposition
packed into budgeted per-destination rows -> the exchange -> pass 2, the
delivery pipeline at the destination (``rx_if`` the node's uplink, so
the global ACL applies, as to VXLAN-decapped traffic on the reference's
uplink). TTL drops once per pass: the two vswitch hops a packet crosses.

One device. The reference places one mesh position on each TPU chip and
runs the step under ``shard_map``; here a mesh lives on one device
(parallel/mesh.py) and its collectives are in-process tensor
operations:

* the tables are node-stacked (``[N, ...]`` per field) in the reference's
  global layout, so ``ClusterDataplane.tables`` reads as the reference's
  sharded arrays do; node ``i`` steps over the views ``[i]``, and rule
  shard ``s`` of a node is the block of its rule dimension that
  ``partition.rule_dim`` names (``shard_block``). The one exception is
  the derived MXU operand ``glb_mxu_op``, held ``[N, S, R'/S, PLANES]``:
  each shard's operand is built from its own column block;
* ``all_to_all`` over the node axis is a transpose of the ``[src, dst,
  B]`` rows; ``pmin`` / ``psum`` over the rule axis are a min or a sum
  over a node's per-shard results; ``axis_index`` is the loop's shard.

The pack is a scatter with a drop slot: each source node's kept packets
land at ``dest * B + pos`` (unique), everything else at the extra row
``N * B``, which is sliced off, so no result depends on the order of
duplicate writes.

The two-tier dispatcher runs per node, as in the reference. Its flags
are read to the host once per pass, as an ``[N]`` vector: every node's
prefix runs, then one read, then each node's chosen tier. On the card
each step variant is captured into CUDA graphs (``ClusterProgram``, on
``pipeline/capture.py``'s parts): the forced full chain is one graph a
step; the auto path a pass-1 prefix graph, one tier graph per node, a
graph of the exchange and the pass-2 prefixes, and one tier graph per
node again. Eager and captured steps agree bit for bit.

Rungs on the mesh are the reference's: ``pallas_ok`` stays False, so the
session probe is the gather rung, the FIB ``dense`` or ``lpm`` and the
classifier ``dense``, ``bv`` or ``mxu``; an explicit ``pallas`` knob is
refused by ``validate_partitioning``. The ``mxu`` rung launches
``mxu_first_match`` once per rule shard on that shard's operand.
"""

from __future__ import annotations

import functools
import threading
import time as _time
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vpp_tpu_torch.ops.acl import (
    ENC_NO_MATCH,
    AclVerdict,
    acl_classify_local,
    acl_encode_shard,
    assemble_global_verdict,
)
from vpp_tpu_torch.parallel.mesh import Mesh
from vpp_tpu_torch.parallel.partition import (
    NODE_AXIS,
    RULE_AXIS,
    ShardCtx,
    agree_ml,
    bv_mesh_ok,
    rule_dim,
    select_fib_impl,
    select_impl,
    table_specs,
    validate_partitioning,
)
from vpp_tpu_torch.pipeline import capture
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.graph import (
    SWEEP_STRIDE_DEFAULT,
    StepStats,
    _fib_fn,
    auto_fast,
    auto_full,
    auto_prefix,
    pipeline_step,
    result_fields,
    result_of,
)
from vpp_tpu_torch.pipeline.tables import (
    _UPLOAD_GROUPS,
    DERIVED_FIELDS,
    HOST_FIELDS,
    SESSION_FIELDS,
    STATE_FIELDS,
    DataplaneConfig,
    DataplaneTables,
    restored_sessions,
    state_shapes,
)
from vpp_tpu_torch.pipeline.vector import (
    FLAG_VALID,
    Disposition,
    PacketVector,
    make_packet_vector,
)

# every field a node builder uploads or derives, but the MXU operand,
# which the cluster builds per shard
_STACKED_FIELDS = tuple(f for f in HOST_FIELDS + DERIVED_FIELDS
                        if f != "glb_mxu_op")


@functools.lru_cache(maxsize=None)
def mesh_table_specs(bv_sharded: bool = True,
                     ml_sharded: bool = True) -> DataplaneTables:
    """The partition layer's specs adjusted for this mesh's degraded
    axes (the reference's): the ``glb_bv_*`` planes replicate when the
    word axis cannot shard (``bv_mesh_ok``), the ``glb_ml_*`` planes
    when the stage is off (placeholders)."""
    specs = table_specs()._asdict()
    for f in specs:
        if (f.startswith("glb_bv_") and not bv_sharded) or (
                f.startswith("glb_ml_") and not ml_sharded):
            specs[f] = (NODE_AXIS,)
    return DataplaneTables(**specs)


def shard_block(t: torch.Tensor, spec, s: int, shards: int) -> torch.Tensor:
    """Rule shard ``s``'s block of one node's tensor ``t`` (a view): the
    ``s``-th of ``shards`` equal blocks of the dimension ``spec`` splits,
    ``t`` itself when the field is replicated."""
    dim = rule_dim(spec)
    if dim is None:
        return t
    n = t.shape[dim] // shards
    return t.narrow(dim, s * n, n)


class NodeTx(NamedTuple):
    """One node's egress view after a pass, node-stacked: header fields
    and where each packet went. ``node_id`` >= 0 marks packets handed
    to the fabric."""

    pkts: PacketVector
    disp: torch.Tensor        # int32 Disposition
    tx_if: torch.Tensor       # int32 egress interface (-1 dropped)
    node_id: torch.Tensor     # int32 destination node, -1 local
    next_hop: torch.Tensor    # int32 VXLAN peer (uint32 bits; 0 none)
    drop_cause: torch.Tensor  # int32 DROP_* attribution (graph.py)


class ClusterStepResult(NamedTuple):
    local: NodeTx            # pass 1, at the ingress node [N, P]
    delivered: NodeTx        # pass 2, at the destination [N, N*B]
    tables: DataplaneTables  # the node-stacked live tables
    stats: StepStats         # per-node counters, both passes summed [N]
    fabric_overflow: torch.Tensor  # int32 [N]: dropped, budget full
    fabric_sent: torch.Tensor      # int32 [N]: handed to the fabric
    fastpath_pass1: torch.Tensor   # int32 [N]: pass 1 took the fast tier


# --- the rule-sharded global classify ------------------------------------


def sharded_global_classify(tables, pkts: PacketVector,
                            shard: ShardCtx) -> AclVerdict:
    """The ``dense`` rung with the rule rows split over the shards: each
    shard first-matches its rows (``acl_encode_shard``) and the min of
    the encodings is the cluster-wide first match."""
    rows = tables.glb_action.shape[0] // shard.shards
    encs = []
    for s in range(shard.shards):
        blk = slice(s * rows, (s + 1) * rows)
        encs.append(acl_encode_shard(
            pkts, tables.glb_src_net[blk], tables.glb_src_mask[blk],
            tables.glb_dst_net[blk], tables.glb_dst_mask[blk],
            tables.glb_proto[blk], tables.glb_sport_lo[blk],
            tables.glb_sport_hi[blk], tables.glb_dport_lo[blk],
            tables.glb_dport_hi[blk], tables.glb_action[blk], s * rows))
    return _assemble(tables, pkts, torch.stack(encs).amin(dim=0))


def sharded_global_classify_mxu(tables, pkts: PacketVector,
                                shard: ShardCtx) -> AclVerdict:
    """The ``mxu`` rung with the rule COLUMNS split over the shards:
    ``mxu_first_match`` once per shard on its operand
    (``glb_mxu_op[s]``), the deny bit from the shard's column-aligned
    ``glb_mxu_act`` block, the encodings min-combined."""
    from vpp_tpu_torch.ops.acl_mxu import ENC_MISS, mxu_first_match

    cols = tables.glb_mxu_op.shape[1]
    encs = []
    for s in range(shard.shards):
        col = mxu_first_match(pkts.src_ip, pkts.dst_ip, pkts.proto,
                              pkts.sport, pkts.dport, tables.glb_mxu_op[s])
        hit = col != int(ENC_MISS)
        act = tables.glb_mxu_act[s * cols:(s + 1) * cols]
        deny = act[torch.where(hit, col, 0).long()] != 1
        encs.append(torch.where(
            hit, ((col.to(torch.int64) + s * cols) << 1)
            | deny.to(torch.int64), ENC_NO_MATCH).to(torch.int32))
    return _assemble(tables, pkts, torch.stack(encs).amin(dim=0))


def sharded_global_classify_bv(tables, pkts: PacketVector,
                               shard: ShardCtx) -> AclVerdict:
    """The ``bv`` rung with the rule-WORD axis split over the shards:
    the boundaries are whole on every shard, each shard ANDs its word
    block and finds its lowest set bit, the deny bit comes from its
    action-row block (``bv_mesh_ok`` aligns the two), and the encodings
    min-combine."""
    from vpp_tpu_torch.ops.acl_bv import bv_first_match

    words = tables.glb_bv_src.shape[1] // shard.shards
    rows = words * 32
    planes = (tables.glb_bv_src, tables.glb_bv_dst, tables.glb_bv_sport,
              tables.glb_bv_dport, tables.glb_bv_proto)
    encs = []
    for s in range(shard.shards):
        matched, rule = bv_first_match(
            tables.glb_bv_bnd_src, tables.glb_bv_bnd_dst,
            tables.glb_bv_bnd_sport, tables.glb_bv_bnd_dport,
            tables.glb_bv_nbnd,
            *(p[:, s * words:(s + 1) * words] for p in planes), pkts)
        act = tables.glb_action[s * rows:(s + 1) * rows]
        safe = torch.clamp(torch.where(matched, rule, 0), 0,
                           act.shape[0] - 1)
        deny = act[safe.long()] != 1
        encs.append(torch.where(
            matched, ((rule.to(torch.int64) + s * rows) << 1)
            | deny.to(torch.int64), ENC_NO_MATCH).to(torch.int32))
    return _assemble(tables, pkts, torch.stack(encs).amin(dim=0))


def _assemble(tables, pkts: PacketVector, enc: torch.Tensor) -> AclVerdict:
    matched = enc != ENC_NO_MATCH
    return assemble_global_verdict(tables, pkts, matched, (enc & 1) == 0,
                                   enc >> 1)


# impl -> the rule-sharded global classify (graph._classifier_fns twin)
_SHARDED_GLOBAL_FNS = {
    "dense": sharded_global_classify,
    "mxu": sharded_global_classify_mxu,
    "bv": sharded_global_classify_bv,
}


# --- the step ------------------------------------------------------------


def _stack_pv(pvs: Sequence[PacketVector]) -> PacketVector:
    return PacketVector(*(torch.stack(f) for f in zip(*pvs)))


def _tx_of(results) -> NodeTx:
    """The node-stacked NodeTx of one pass's per-node StepResults."""
    return NodeTx(_stack_pv([r.pkts for r in results]),
                  *(torch.stack([getattr(r, f) for r in results])
                    for f in ("disp", "tx_if", "node_id", "next_hop",
                              "drop_cause")))


class Exchange(NamedTuple):
    """The fabric's output: each destination's received rows as one
    node-stacked vector, and the per-source counts."""

    pkts: PacketVector            # [N, N*B], rx_if the uplink
    overflow: torch.Tensor        # int32 [N]
    sent: torch.Tensor            # int32 [N]
    payload: Optional[torch.Tensor]  # uint8 [N, N*B, snap] or None


class ClusterStep:
    """One cluster-step variant (the reference's ``make_cluster_step``
    program): ``step(node_tables, pkts, now, uplinks[, payload])``
    with ``node_tables`` the nodes' DataplaneTables views, ``pkts`` the
    node-stacked ``[N, P]`` vector, ``now`` a 0-d int32 tensor and
    ``uplinks`` the ``[N]`` uplink interfaces; returns the per-node pass
    results and the exchange (``ClusterDataplane.step`` assembles the
    ClusterStepResult). Its parts (``pass1``, ``exchange``, ``pass2``,
    and on the auto path ``prefix`` / ``fast`` / ``slow`` per node) are
    what ``ClusterProgram`` captures."""

    def __init__(self, n_nodes: int, rule_shards: int, budget: int = 0,
                 with_payload: bool = False,
                 sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                 impl: str = "dense", fast: bool = False,
                 ml_mode: str = "off", ml_kind: str = "mlp",
                 bv_sharded: bool = False, fib: str = "dense"):
        if impl == "bv" and not bv_sharded:
            raise ValueError(
                "impl='bv' requires word-sharded BV planes (bv_sharded)")
        if fib not in ("dense", "lpm"):
            raise ValueError(f"fib rung {fib!r} does not run on a mesh")
        self.n_nodes, self.rule_shards = n_nodes, rule_shards
        self.budget, self.with_payload = int(budget), with_payload
        self.fast = fast
        shard = ShardCtx(RULE_AXIS, rule_shards)
        if impl == "bv":
            from vpp_tpu_torch.ops.acl_bv import acl_classify_local_bv
            local_fn = acl_classify_local_bv
        else:
            local_fn = acl_classify_local
        tier = dict(sweep_stride=sweep_stride, fib_fn=_fib_fn(fib),
                    ml_mode=ml_mode, ml_kind=ml_kind, shard=shard)
        chain = dict(tier, acl_global_fn=functools.partial(
            _SHARDED_GLOBAL_FNS[impl], shard=shard), acl_local_fn=local_fn)
        self.full = functools.partial(pipeline_step, **chain)
        if fast:
            self.prefix = functools.partial(auto_prefix, shard=shard)
            self.fast_tier = functools.partial(auto_fast, **tier)
            self.slow_tier = functools.partial(auto_full, **chain)
        self.__name__ = "cluster_step_{}x{}_{}{}{}{}{}{}{}".format(
            n_nodes, rule_shards, impl, "_auto" if fast else "",
            "" if ml_mode == "off" else f"_ml{ml_mode}"
            + ("_forest" if ml_kind == "forest" else ""),
            "" if fib == "dense" else f"_fib{fib}",
            f"_b{budget}" if budget else "",
            "_wire" if with_payload else "",
            "" if sweep_stride == SWEEP_STRIDE_DEFAULT
            else f"_sw{sweep_stride}")

    # the parts
    def prefixes(self, node_tables, pvs, now):
        """Every node's dispatch prefix and the ``[N]`` flag vector."""
        pres = [self.prefix(t, p, now) for t, p in zip(node_tables, pvs)]
        return pres, torch.stack([pre.ok for pre in pres])

    def tier(self, t, pre, now, fast: bool):
        return (self.fast_tier if fast else self.slow_tier)(t, pre, now)

    def run_pass(self, node_tables, pvs, now) -> list:
        """One pipeline pass over every node, eagerly: on the auto path
        the prefixes, ONE host read of the ``[N]`` flags, then each
        node's tier."""
        if not self.fast:
            return [self.full(t, p, now) for t, p in zip(node_tables, pvs)]
        pres, flags = self.prefixes(node_tables, pvs, now)
        flags = flags.tolist()  # the pass's one host sync
        return [self.tier(t, pre, now, f)
                for t, pre, f in zip(node_tables, pres, flags)]

    def exchange(self, local: NodeTx, uplinks: torch.Tensor,
                 payload: Optional[torch.Tensor] = None) -> Exchange:
        """Pack each source's REMOTE packets into ``B`` slots per
        destination (position = the running count; the overflow dropped
        and counted), swap the rows across the node axis, and hand each
        destination its ``N * B`` received packets on its uplink."""
        n = self.n_nodes
        rp = local.pkts
        p = rp.src_ip.shape[1]
        b = self.budget if self.budget > 0 else p
        dev = local.disp.device
        dests = torch.arange(n, dtype=torch.int32, device=dev)
        remote = local.disp == int(Disposition.REMOTE)
        # [src, dst, P]: packet p of src goes to dst
        dest_mask = remote[:, None, :] & (
            local.node_id[:, None, :] == dests[None, :, None])
        pos = torch.cumsum(dest_mask.to(torch.int32), dim=2) - 1
        keep = dest_mask & (pos < b)
        overflow = (dest_mask & (pos >= b)).sum(dim=(1, 2),
                                                dtype=torch.int32)
        sent = keep.sum(dim=(1, 2), dtype=torch.int32)
        # the drop slot n*b takes every other lane, then is sliced off
        idx = torch.where(keep, dests[None, :, None].to(torch.int64) * b
                          + pos, n * b).reshape(n, n * p)

        def pack(a):
            out = torch.zeros((n, n * b + 1), dtype=a.dtype, device=dev)
            src = a[:, None, :].expand(n, n, p).reshape(n, n * p)
            out.scatter_(1, idx, src)
            # [src, dst, B] -> [dst, src, B]: the all_to_all
            return out[:, :n * b].view(n, n, b).transpose(0, 1).reshape(
                n, n * b)

        valid = torch.full_like(rp.flags, FLAG_VALID)
        recv = PacketVector(
            src_ip=pack(rp.src_ip), dst_ip=pack(rp.dst_ip),
            proto=pack(rp.proto), sport=pack(rp.sport),
            dport=pack(rp.dport), ttl=pack(rp.ttl),
            pkt_len=pack(rp.pkt_len),
            # fabric traffic enters through the node's uplink
            rx_if=uplinks[:, None].expand(n, n * b).to(torch.int32)
            .contiguous(),
            flags=pack(valid))
        deliv_pay = None
        if payload is not None:
            snap = payload.shape[2]
            out = torch.zeros((n, n * b + 1, snap), dtype=payload.dtype,
                              device=dev)
            src = payload[:, None].expand(n, n, p, snap).reshape(
                n, n * p, snap)
            out.scatter_(1, idx[:, :, None].expand(n, n * p, snap), src)
            deliv_pay = out[:, :n * b].view(n, n, b, snap).transpose(
                0, 1).reshape(n, n * b, snap)
        return Exchange(recv, overflow, sent, deliv_pay)

    def __call__(self, node_tables, pkts: PacketVector, now, uplinks,
                 payload=None):
        """The eager step: (pass-1 results, exchange, pass-2 results)."""
        n = self.n_nodes
        res1 = self.run_pass(node_tables, [PacketVector(*(f[i] for f in pkts))
                                           for i in range(n)], now)
        ex = self.exchange(_tx_of(res1), uplinks, payload)
        res2 = self.run_pass(node_tables,
                             [PacketVector(*(f[i] for f in ex.pkts))
                              for i in range(n)], now)
        return res1, ex, res2


@functools.lru_cache(maxsize=None)
def make_cluster_step(n_nodes: int, rule_shards: int, budget: int = 0,
                      with_payload: bool = False,
                      sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                      impl: str = "dense", fast: bool = False,
                      ml_mode: str = "off", ml_kind: str = "mlp",
                      bv_sharded: bool = False,
                      fib: str = "dense") -> ClusterStep:
    """The cluster-step variant of these gates, one per process (the
    reference's memoized factory; its mesh key is the geometry here)."""
    return ClusterStep(n_nodes, rule_shards, budget, with_payload,
                       sweep_stride, impl, fast, ml_mode, ml_kind,
                       bv_sharded, fib)


def make_cluster_step_wire(n_nodes: int, rule_shards: int, budget: int = 0,
                           **gates) -> ClusterStep:
    """The step for real wire traffic: headers AND payload bytes cross
    the fabric (``payload`` [N, P, snap] uint8 in, the delivered rows'
    bytes [N, N*B, snap] out)."""
    return make_cluster_step(n_nodes, rule_shards, budget,
                             with_payload=True, **gates)


def cluster_step(mesh: Mesh) -> ClusterStep:
    """The default variant of a mesh (the reference's public name)."""
    return make_cluster_step(mesh.shape[NODE_AXIS], mesh.shape[RULE_AXIS])


def _result(step: ClusterStep, res1, ex: Exchange, res2,
            tables) -> ClusterStepResult:
    stats = StepStats(*(torch.stack([a + b for a, b in zip(f1, f2)])
                        for f1, f2 in zip(zip(*[r.stats for r in res1]),
                                          zip(*[r.stats for r in res2]))))
    return ClusterStepResult(
        local=_tx_of(res1), delivered=_tx_of(res2), tables=tables,
        stats=stats, fabric_overflow=ex.overflow, fabric_sent=ex.sent,
        fastpath_pass1=torch.stack([r.stats.fastpath for r in res1]))


# --- the captured step -----------------------------------------------------


class _Staged:
    """One node's pass result in a fixed buffer: either tier's graph
    writes it, the parts after read it (``capture.Packing``)."""

    def __init__(self):
        self.packing: Optional[capture.Packing] = None
        self.buf: Optional[torch.Tensor] = None

    def put(self, res) -> torch.Tensor:
        fields = result_fields(res)
        if self.packing is None:
            self.packing = capture.Packing(fields)
            self.buf = torch.empty(self.packing.nbytes, dtype=torch.uint8,
                                   device=fields[0].device)
        self.buf.copy_(self.packing.pack(fields))
        return self.buf

    def get(self, buf, tables):
        return result_of(self.packing.unpack(buf), tables)


class ClusterProgram:
    """One cluster-step variant over a cluster's live tables, captured
    into CUDA graphs part by part (``capture.Part``: the first call of a
    part runs eagerly and captures, later calls replay; on the CPU
    every call runs eagerly through the same buffers). Static inputs:
    ``x`` (the ``[N, 9, P]`` header columns), ``now``, ``uplinks`` and,
    for the wire form, ``pay`` (``[N, P, snap]`` uint8). Each node's
    pass results go into ``_Staged`` buffers; ``run`` returns the clone
    of every output, so a result never aliases graph memory."""

    def __init__(self, label: str, sig: tuple, step: ClusterStep,
                 node_tables, uplinks: torch.Tensor, shape, snap: int,
                 device: torch.device):
        n = step.n_nodes
        self.step, self.node_tables = step, node_tables
        self.tables = None  # set by the owner: what holds() compares
        cuda = device.type == "cuda"
        self.x = torch.zeros(shape, dtype=torch.int32, device=device)
        self.now = torch.zeros((), dtype=torch.int32, device=device)
        self.uplinks = uplinks
        self.pay = (torch.zeros((n, shape[2], snap), dtype=torch.uint8,
                                device=device)
                    if step.with_payload else None)
        self.stage1 = [_Staged() for _ in range(n)]
        self.stage2 = [_Staged() for _ in range(n)]
        self.host_reads = 0
        self.parts: List[capture.Part] = []

        def part(name, fn):
            p = capture.Part(f"{label}:{name}", sig, fn, cuda)
            self.parts.append(p)
            return p

        def rows(x):
            return [PacketVector(*x[i].unbind(0)) for i in range(n)]

        def exchange_rows(now):
            local = _tx_of([st.get(st.buf, t) for st, t in
                            zip(self.stage1, node_tables)])
            ex = step.exchange(local, self.uplinks, self.pay)
            return ex, [PacketVector(*(f[i] for f in ex.pkts))
                        for i in range(n)]

        if not step.fast:
            def whole(x, now):
                for st, r in zip(self.stage1, step.run_pass(
                        node_tables, rows(x), now)):
                    st.put(r)
                ex, pvs = exchange_rows(now)
                for st, r in zip(self.stage2, step.run_pass(
                        node_tables, pvs, now)):
                    st.put(r)
                return ex
            self.whole = part("step", whole)
            return

        def p1_prefix(x, now):
            return step.prefixes(node_tables, rows(x), now)

        def p2_prefix(now):
            ex, pvs = exchange_rows(now)
            pres, flags = step.prefixes(node_tables, pvs, now)
            return ex, pres, flags

        def tier_part(stage, i, fast):
            def fn(pre, now):
                return stage[i].put(step.tier(node_tables[i], pre, now,
                                              fast))
            return fn

        self.p1 = part("p1:prefix", p1_prefix)
        self.p2 = part("p2:prefix", p2_prefix)
        self.tiers = {
            (k, i, f): part(f"p{k}:{'fast' if f else 'full'}:{i}",
                            tier_part(stage, i, f))
            for k, stage in ((1, self.stage1), (2, self.stage2))
            for i in range(n) for f in (True, False)}

    def holds(self, tables) -> bool:
        return self.tables is not None and len(tables) == len(
            self.tables) and all(a is b for a, b in zip(tables, self.tables))

    def _tiers(self, k: int, part, out) -> None:
        pres, flags = out[-2:]
        static = part.out[-2] if part.out is not None else None
        flags = flags.tolist()  # the pass's one host sync
        self.host_reads += 1
        for i, f in enumerate(flags):
            self.tiers[(k, i, bool(f))](
                (pres[i], self.now),
                None if static is None else (static[i], self.now))

    def replay(self) -> Exchange:
        """Run the parts on the static inputs (graph memory once
        captured: the next replay overwrites it)."""
        if not self.step.fast:
            return self.whole((self.x, self.now))
        self._tiers(1, self.p1, self.p1((self.x, self.now)))
        out = self.p2((self.now,))
        self._tiers(2, self.p2, out)
        return out[0]

    def run(self, now: int, pkts: PacketVector, payload=None):
        """Copy in, run the parts, and return (pass-1 results, exchange,
        pass-2 results), every tensor a clone."""
        self.now.fill_(now)
        self.x.copy_(torch.stack(list(pkts), dim=1))
        if self.pay is not None:
            self.pay.copy_(torch.as_tensor(np.asarray(payload))
                           if not torch.is_tensor(payload) else payload)
        ex = self.replay()
        ex = Exchange(PacketVector(*(f.clone() for f in ex.pkts)),
                      ex.overflow.clone(), ex.sent.clone(),
                      None if ex.payload is None else ex.payload.clone())
        res = []
        for stage in (self.stage1, self.stage2):
            res.append([st.get(st.buf.clone(), t)
                        for st, t in zip(stage, self.node_tables)])
        return res[0], ex, res[1]


# --- the host handle -------------------------------------------------------


class ClusterDataplane:
    """Host-side handle on an N-node cluster data plane over one mesh.

    Per-node configuration is staged through each node's ``Dataplane``
    handle (``node(i)``, built with ``materialize=False``: the same
    interface, table, FIB and NAT mutators the renderers drive); a
    node's ``swap`` delegates here, and ``swap`` publishes one cluster
    epoch: each node builder uploads its dirty groups into its views of
    the node-stacked tensors (so the incremental upload of
    pipeline/tables.py serves the mesh unchanged), the MXU operand is
    rebuilt per shard for the nodes whose global table shipped, and the
    live session state carries over in place. ``graphs`` (default on)
    runs every step variant through a ``ClusterProgram``; ``graphs=False``
    steps eagerly."""

    def __init__(self, mesh: Mesh, config: Optional[DataplaneConfig] = None,
                 graphs: bool = True):
        from vpp_tpu_torch.ops.acl_mxu import mxu_rule_capacity

        self.mesh = mesh
        self.device = mesh.device
        self.graphs = bool(graphs)
        self.config = config or DataplaneConfig()
        self.n_nodes = mesh.shape[NODE_AXIS]
        rule_shards = mesh.shape[RULE_AXIS]
        self.rule_shards = rule_shards
        for name, dim in (
                ("max_global_rules", self.config.max_global_rules),
                ("MXU rule capacity",
                 mxu_rule_capacity(self.config.max_global_rules))):
            if dim % rule_shards:
                raise ValueError(
                    f"{name} {dim} not divisible by rule shards "
                    f"{rule_shards}")
        validate_partitioning(self.config, rule_shards)
        # the cluster step compiles the tenant stage out: refuse rather
        # than skip per-tenant limits and accounting silently
        if getattr(self.config, "tenancy", "off") != "off":
            raise ValueError(
                "dataplane.tenancy=on is not supported on the mesh "
                "yet: the cluster step would silently skip per-tenant "
                "rate limits and accounting — run tenancy on "
                "standalone dataplanes (docs/TENANCY.md)")
        self._bv_sharded = bv_mesh_ok(self.config, rule_shards)
        if (getattr(self.config, "classifier", "auto") == "bv"
                and rule_shards > 1 and not self._bv_sharded):
            raise ValueError(
                f"classifier=bv on a {rule_shards}-way rule-sharded mesh "
                f"requires max_global_rules ({self.config.max_global_rules})"
                f" divisible by {32 * rule_shards} (32·shards) so the "
                "bitmap word shards align with the action-row shards")
        self._ml_sharded = getattr(self.config, "ml_stage", "off") != "off"
        self._lock = threading.RLock()
        self.nodes: List[Dataplane] = [
            Dataplane(self.config, device=self.device, materialize=False)
            for _ in range(self.n_nodes)]
        for n in self.nodes:
            # node commits publish the cluster epoch and serialise on
            # the ONE cluster lock
            n._swap_delegate = self.swap
            n.commit_lock = self._lock
        self.tables: Optional[DataplaneTables] = None
        self._node_tables: List[DataplaneTables] = []
        self._programs: Dict[tuple, ClusterProgram] = {}
        self._owner = capture.new_owner()
        self.epoch = 0
        self._t0 = _time.monotonic()
        self._now = 0
        self._steps_since_expire = 0
        self._uplinks: Optional[torch.Tensor] = None
        self._sweep_stride = int(getattr(self.config, "sess_sweep_stride",
                                         SWEEP_STRIDE_DEFAULT))
        self._impl = "dense"
        self._use_mxu = False
        self._use_fast = False
        self._ml_mode = "off"
        self._ml_kind = "mlp"
        self._fib_impl = "dense"
        self.mxu_threshold = 512
        self.bv_min_rules = int(getattr(self.config,
                                        "classifier_bv_min_rules", 1024))
        self.fib_lpm_min_routes = int(getattr(self.config,
                                              "fib_lpm_min_routes", 256))
        self.upload_stats = {"fields_shipped": 0, "fields_reused": 0}
        self.specs = mesh_table_specs(self._bv_sharded, self._ml_sharded)

    def node(self, i: int) -> Dataplane:
        return self.nodes[i]

    @property
    def classifier_impl(self) -> str:
        """The rule-sharded global classify of the live epoch."""
        return self._impl

    @property
    def fastpath_selected(self) -> bool:
        return self._use_fast

    @property
    def fib_impl(self) -> str:
        return self._fib_impl

    @property
    def ml_selected(self) -> str:
        return self._ml_mode

    @property
    def session_impl(self) -> str:
        return "gather"

    def node_tables(self, i: int) -> DataplaneTables:
        """Node ``i``'s live tables (views of the node-stacked ones)."""
        return self._node_tables[i]

    def shard_sessions_resident(self) -> List[int]:
        """Live reflective sessions per rule shard, summed across nodes:
        each shard's block of every node's ``sess_valid``, reduced on the
        device (only ``[S]`` counts reach the host)."""
        with self._lock:
            if self.tables is None:
                return [0] * self.rule_shards
            v = self.tables.sess_valid
            per = v.view(v.shape[0], self.rule_shards, -1).sum(
                dim=(0, 2), dtype=torch.int64)
            return [int(x) for x in per.tolist()]

    def shard_rule_plane_bytes(self) -> List[int]:
        """Device bytes each rule shard holds of the rule-sharded
        classifier and ML planes, summed across nodes (each block's own
        size, read off the live tensors)."""
        with self._lock:
            if self.tables is None:
                return [0] * self.rule_shards
            out = [0] * self.rule_shards
            for f in self.tables._fields:
                if not f.startswith("glb_"):
                    continue
                t = getattr(self.tables, f)
                for s in range(self.rule_shards):
                    if f == "glb_mxu_op":
                        blk = t[:, s]
                    else:
                        spec = getattr(self.specs, f)
                        if rule_dim(spec) is None:
                            continue
                        blk = shard_block(t[0], spec, s, self.rule_shards)
                        blk = blk.expand(t.shape[0], *blk.shape)
                    out[s] += blk.numel() * blk.element_size()
            return out

    def _refresh_selection(self) -> None:
        """Re-gate every cluster-wide choice against the staged node
        builders (agreed across nodes: one step variant serves all):
        the classifier ladder (BV needs every node's structure and the
        word-shard alignment), the fast path against the LARGEST global
        table, the ML stage when every node staged one kind, the FIB
        ladder on collective bits. ``pallas_ok`` stays False."""
        c = self.config
        mxu_ok = all(n.builder.mxu_enabled and n.builder.glb_mxu.ok
                     for n in self.nodes)
        bv_ok = self._bv_sharded and all(n.builder.bv_ok()
                                         for n in self.nodes)
        nmax = max(n.builder.glb_nrules for n in self.nodes)
        self._impl = select_impl(getattr(c, "classifier", "auto"), bv_ok,
                                 mxu_ok, nmax, self.bv_min_rules,
                                 self.mxu_threshold)
        self._use_mxu = self._impl == "mxu"
        self._use_fast = bool(getattr(c, "fastpath", True)) and \
            nmax >= int(getattr(c, "fastpath_min_rules", 0))
        self._ml_mode, self._ml_kind = agree_ml(
            getattr(c, "ml_stage", "off"),
            {int(n.builder.ml_kind) for n in self.nodes})
        self._fib_impl = select_fib_impl(
            getattr(c, "fib_impl", "auto"),
            all(n.builder.lpm_ok() for n in self.nodes),
            max(n.builder.fib_route_count() for n in self.nodes),
            self.fib_lpm_min_routes, pallas_ok=False)

    def _get_step(self, with_payload: bool = False,
                  budget: int = 0) -> ClusterStep:
        return make_cluster_step(
            self.n_nodes, self.rule_shards, budget, with_payload,
            self._sweep_stride, self._impl, self._use_fast, self._ml_mode,
            self._ml_kind, self._bv_sharded, self._fib_impl)

    # --- epochs ---
    def _guard_uplinks(self) -> None:
        """A node that fabric routes point at must have an uplink, or its
        inbound traffic would arrive on the reserved interface 0."""
        for i, n in enumerate(self.nodes):
            b = n.builder
            targets = np.asarray(b.fib_node_id)[np.asarray(b.fib_plen) >= 0]
            for t in np.unique(targets[targets >= 0]):
                if self.nodes[int(t)].uplink_if is None:
                    raise ValueError(
                        f"node {i} routes to node {int(t)}, which has no "
                        "uplink interface (call add_uplink())")

    def _mxu_operand(self, i: int) -> None:
        """Node ``i``'s per-shard MXU operands from its column blocks."""
        from vpp_tpu_torch.ops.acl_mxu import mxu_operand

        coeff, k = self.tables.glb_mxu_coeff[i], self.tables.glb_mxu_k[i]
        cols = coeff.shape[1] // self.rule_shards
        for s in range(self.rule_shards):
            blk = slice(s * cols, (s + 1) * cols)
            self.tables.glb_mxu_op[i, s].copy_(mxu_operand(
                {"glb_mxu_coeff": coeff[:, blk],
                 "glb_mxu_k": k[blk]})["glb_mxu_op"])

    def swap(self) -> int:
        """Publish every node's staged configuration as one cluster
        epoch (class doc). Each node's lock is held while its builder
        uploads; the node commits hold the cluster lock around staging
        and swap, so no node publishes a peer's half-applied staging."""
        with self._lock:
            self._guard_uplinks()
            first = self.tables is None
            n, dev = self.n_nodes, self.device
            state = None
            if first:
                shapes = state_shapes(self.config)
                state = {f: torch.zeros((n,) + shapes[f], dtype=torch.int32,
                                        device=dev) for f in STATE_FIELDS}
                held = [SimpleNamespace(**{f: state[f][i] for f in state})
                        for i in range(n)]
            else:
                held = self._node_tables
            outs, shipped = [], set()
            for i, node in enumerate(self.nodes):
                with node._lock:
                    outs.append(node.builder.to_device(
                        sessions=held[i], into=None if first else held[i]))
                    for group, rec in node.builder.last_upload.items():
                        if rec["bytes"]:
                            shipped.update(rec["fields"] or ())
                            if "blob_bytes" in rec:
                                shipped.update(_UPLOAD_GROUPS[group])
            total = sum(len(v) for v in _UPLOAD_GROUPS.values())
            self.upload_stats["fields_shipped"] = len(shipped)
            self.upload_stats["fields_reused"] = total - len(shipped)
            self._publish(outs, state)
            self._refresh_selection()
            self._programs = {k: p for k, p in self._programs.items()
                              if p.holds(self.tables)}
            ups = [nd.uplink_if if nd.uplink_if is not None else 0
                   for nd in self.nodes]
            if self._uplinks is None:
                self._uplinks = torch.tensor(ups, dtype=torch.int32,
                                             device=dev)
            else:
                self._uplinks.copy_(torch.tensor(ups, dtype=torch.int32))
            self.epoch += 1
            # each node's journal records its ops under the CLUSTER epoch
            for node in self.nodes:
                if node.journal is not None:
                    with node._lock:
                        txn = node.builder.drain_recording()
                    if txn is not None:
                        node.journal.record(txn, self.epoch)
            return self.epoch

    def _publish(self, outs: List[DataplaneTables], state) -> None:
        """Stack the node builders' outputs: a field whose tensors are no
        longer the views of the stacked one (the first swap, or a shape
        that changed) is stacked afresh and every builder's cache is
        pointed at its view, so later uploads write into it in place.
        ``state``: the node-stacked zero state of the first swap."""
        n = self.n_nodes
        first = state is not None
        fields = dict(self.tables._asdict()) if not first else {}
        restacked = []
        for f in _STACKED_FIELDS:
            if not first and all(getattr(o, f) is getattr(v, f) for o, v in
                                 zip(outs, self._node_tables)):
                continue
            parts = [getattr(o, f) for o in outs]
            if len({tuple(p.shape) for p in parts}) != 1:
                raise ValueError(
                    f"cluster nodes staged {f} in different shapes "
                    f"{[tuple(p.shape) for p in parts]}")
            fields[f] = torch.stack(parts)
            restacked.append(f)
        if first:
            fields.update(state)
            cols = fields["glb_mxu_coeff"].shape[2]
            fields["glb_mxu_op"] = torch.zeros(
                (n, self.rule_shards, cols // self.rule_shards, 128),
                dtype=torch.int8, device=self.device)
        self.tables = DataplaneTables(**fields)
        if first or restacked:
            self._node_tables = [
                DataplaneTables(**{f: getattr(self.tables, f)[i]
                                   for f in self.tables._fields})
                for i in range(n)]
            for i, node in enumerate(self.nodes):
                cache = node.builder._dev_cache
                for f in restacked:
                    cache[f] = getattr(self._node_tables[i], f)
        for i, node in enumerate(self.nodes):
            if first or node.builder.last_upload["glb"]["bytes"]:
                self._mxu_operand(i)

    def make_frames(self, per_node_packets: Sequence[list],
                    n: int = 256) -> PacketVector:
        """Stack per-node packet lists into one node-stacked [N, P]
        vector on the mesh's device."""
        assert len(per_node_packets) == self.n_nodes
        vecs = [make_packet_vector(p, n=n) for p in per_node_packets]
        return PacketVector(*(torch.stack(f).to(self.device)
                              for f in zip(*vecs)))

    def clock_ticks(self) -> int:
        """Monotonic ticks since this cluster started."""
        return int((_time.monotonic() - self._t0) * Dataplane.TICKS_PER_SEC)

    def advance_clock(self, seconds: float) -> None:
        """Shift the time base forward (tests simulate idle periods)."""
        self._t0 -= seconds

    def expire_sessions(self, max_age: Optional[int] = None,
                        lazy: bool = False) -> int:
        """Bulk aging of every node's session tables (reflective + NAT);
        returns how many expired. ``lazy`` skips the bulk pass when the
        in-step sweep (two passes a step) has covered the ring since the
        last call. The valid columns are written in place, so the
        captured programs stay valid."""
        from vpp_tpu_torch.ops.session import session_expire, sweep_covered

        if max_age is None:
            max_age = self.config.sess_max_age
        with self._lock:
            if self.tables is None:
                return 0
            if lazy and max_age == self.config.sess_max_age:
                steps = self._steps_since_expire
                self._steps_since_expire = 0
                if sweep_covered(steps, self._sweep_stride, self.tables,
                                 bucket_axis=1, passes=2):
                    return 0
            self._now = max(self._now, self.clock_ticks())
            t = self.tables
            after = session_expire(t, self._now, max_age)
            expired = int((t.sess_valid - after.sess_valid).sum()
                          + (t.natsess_valid - after.natsess_valid).sum())
            if expired:
                t.sess_valid.copy_(after.sess_valid)
                t.natsess_valid.copy_(after.natsess_valid)
        return expired

    def _clock(self, now: Optional[int]) -> int:
        if self.tables is None:
            self.swap()
        if now is None:
            self._now = max(self._now, self.clock_ticks())
            now = self._now
        return int(now)

    def _program(self, step: ClusterStep, shape, snap: int) -> ClusterProgram:
        key = (step.__name__, tuple(shape), snap)
        prog = self._programs.get(key)
        if prog is None or not prog.holds(self.tables):
            sig = (self._owner, tuple(shape), snap,
                   capture.table_signature(self.tables))
            prog = ClusterProgram(step.__name__, sig, step,
                                  self._node_tables, self._uplinks, shape,
                                  snap, self.device)
            prog.tables = self.tables
            self._programs[key] = prog
        return prog

    def programs(self) -> List[ClusterProgram]:
        with self._lock:
            return list(self._programs.values())

    def _run(self, pkts: PacketVector, now, payload=None, budget: int = 0):
        with self._lock:
            now = self._clock(now)
            step = self._get_step(with_payload=payload is not None,
                                  budget=budget)
            self._steps_since_expire += 1
            if self.graphs:
                shape = (self.n_nodes, len(PacketVector._fields),
                         pkts.src_ip.shape[1])
                snap = 0 if payload is None else int(payload.shape[2])
                res1, ex, res2 = self._program(step, shape, snap).run(
                    now, pkts, payload)
            else:
                t_now = torch.tensor(now, dtype=torch.int32,
                                     device=self.device)
                pay = None
                if payload is not None:
                    pay = (payload if torch.is_tensor(payload)
                           else torch.from_numpy(np.asarray(payload)))
                    pay = pay.to(self.device)
                res1, ex, res2 = step(self._node_tables, pkts, t_now,
                                      self._uplinks, pay)
            return _result(step, res1, ex, res2, self.tables), ex.payload

    def step(self, pkts: PacketVector, now: Optional[int] = None,
             budget: int = 0) -> ClusterStepResult:
        """One cluster step over a node-stacked [N, P] vector.
        ``budget`` caps the fabric slots per (source, destination) pair
        (0: P, the dense layout)."""
        return self._run(pkts, now, budget=budget)[0]

    def step_wire(self, pkts: PacketVector, payload,
                  now: Optional[int] = None, budget: int = 0):
        """The wire step: ``payload`` is [N, P, snap] uint8 (each node's
        rx rows); returns (ClusterStepResult, the delivered rows' bytes
        [N, N*B, snap]) — the fabric carries headers AND bytes."""
        return self._run(pkts, now, payload=payload, budget=budget)

    def adopt_sessions(self, sessions) -> int:
        """Publish restored session state (``{field: node-stacked host
        array}`` of SESSION_FIELDS, the cluster snapshot's restore) into
        the live tensors in place; a shape off the mesh geometry
        raises."""
        with self._lock:
            if self.tables is None:
                self.swap()
            missing = set(SESSION_FIELDS) - set(sessions)
            if missing:
                raise ValueError(
                    f"restored session state missing fields: "
                    f"{sorted(missing)}")
            for f in SESSION_FIELDS:
                want = tuple(getattr(self.tables, f).shape)
                if tuple(np.shape(sessions[f])) != want:
                    raise ValueError(
                        f"restored session field {f!r} shape "
                        f"{tuple(np.shape(sessions[f]))} != mesh geometry "
                        f"{want}")
            per_node = [restored_sessions(self.config, {
                f: np.asarray(sessions[f])[i] for f in SESSION_FIELDS})
                for i in range(self.n_nodes)]
            for f in SESSION_FIELDS:
                a = np.stack([p[f] for p in per_node])
                a = a.view(np.int32) if a.dtype == np.uint32 else a
                getattr(self.tables, f).copy_(torch.from_numpy(
                    np.ascontiguousarray(a)))
            self.epoch += 1
            return self.epoch
