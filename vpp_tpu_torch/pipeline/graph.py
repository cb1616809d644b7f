"""The fused packet pipeline: one step over a packet vector.

The PyTorch counterpart of ``vpp_tpu/pipeline/graph.py``: [overlay
decap] -> ip4-input -> [tenant stage] -> reflective session lookup +
touch -> NAT44 reverse -> DNAT -> ACL classify (local + global) -> FIB
-> SNAT -> session insert + NAT record -> the shared tail ([overlay
encap], counters, drop attribution, session sweep, flow sketch,
per-tenant accounting), and the two-tier established-flow dispatcher
``pipeline_step_auto`` over it and the classify-free
``pipeline_step_fast``.

The ML stage (``ml_mode`` score | enforce, ``ml_kind`` mlp | forest;
ops/mlscore.py) scores the post-NAT-reverse header on both tiers, with
the session age read before the touch; enforce folds its drops in after
the ACL verdict (deny > ml-drop > permit). Telemetry ``full`` folds each
step into the flow sketch in the shared tail; the latency histogram is
the packed boundary's (``tel_observe``). Tenancy (``tnt_mode`` on)
derives each packet's tenant at ip4-input, runs the token buckets once
a step (over-quota packets leave ``alive``, attributed DROP_TENANT),
slices the session and NAT tables by the key's tenant, keys the ML
policy by tenant and counts per tenant in the tail. The overlay
(``overlay`` vxlan) decaps VTEP-addressed VXLAN frames ahead of
ip4-input from the host-parsed inner sidecar (a frame that cannot be
admitted fails closed, DROP_OVERLAY; a decapped packet's tenant is its
VNI's) and encaps REMOTE packets with a tunnel next hop in the tail,
resolving the outer header by a second walk over the same FIB planes.

On the mesh (``shard``, a ``parallel.partition.ShardCtx``; the cluster
step of parallel/cluster.py) the session and NAT tables are bucket-
sharded, the ML planes hidden- or tree-sharded and the global classify
rule-sharded: every stage that reads them takes ``shard`` and recombines
its shards' results in process (ops/session.py, ops/mlscore.py).

PyTorch runs eagerly, so the step is plain Python over tensors; the
full chain never synchronises with the device (every counter stays a
0-d tensor, and the clock ``now`` is a 0-d int32 tensor, as the
reference passes ``jnp.int32(now)``), and it updates the session/NAT
state and the ECMP accounting plane in place (ops/session.py module
doc): ``StepResult.tables`` is the tables object it was given. The auto
dispatcher reads its one predicate flag to the host per step (its
docstring says why). The tenancy planes (buckets and counters) are
written in place too.

Capture. Nothing in a step depends on the data or the clock on the
host: the op stream is the same for every batch of one shape and every
``now`` (tests/test_torch_capture.py records it), so
pipeline/capture.py can capture it in a CUDA graph. For that the auto
dispatcher comes in three parts a program captures one by one —
``auto_prefix`` (ending in the dispatch flag), ``auto_fast`` and the
full chain behind it — with the flag read between them; the prefix
runs the overlay decap and the tenant stage, so it writes the token
buckets, and both tiers take its ingress; ``result_fields`` /
``result_of`` and ``packed_vector`` / ``packed_fields`` are the
tensors a program copies in and out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from vpp_tpu_torch.ops.acl import acl_classify_global, acl_classify_local
from vpp_tpu_torch.ops.fib import fib_lookup_dense
from vpp_tpu_torch.ops.ip4 import ip4_input
from vpp_tpu_torch.ops.mlscore import ML_KINDS, ml_stage, ml_stage_sharded
from vpp_tpu_torch.ops.nat44 import (
    nat44_dnat,
    nat44_dnat_match,
    nat44_record,
    nat44_reverse,
    nat44_snat,
    nat44_touch,
)
from vpp_tpu_torch.ops.session import (
    _age,
    session_batch_summary,
    session_hit_age,
    session_insert,
    session_lookup_reverse_idx,
    session_sweep,
    session_touch,
)
from vpp_tpu_torch.ops.telemetry import (
    TEL_MODES,
    tel_flow_update,
    tel_latency_update,
)
from vpp_tpu_torch.ops.vxlan import (
    DEFAULT_VNI,
    vxlan_decap_step,
    vxlan_encap,
)
from vpp_tpu_torch.pipeline.vector import (
    Disposition,
    PacketVector,
    gather_index,
    scatter_index,
    to_i32,
    u32,
)
from vpp_tpu_torch.tenancy.derive import (
    tenant_ids,
    tenant_limit,
    tnt_account,
)


class StepStats(NamedTuple):
    """Per-step counters: 0-d int32 tensors, [I] for the per-interface
    ones (the reference's field set and meaning)."""

    rx: torch.Tensor
    tx: torch.Tensor
    drop_ip4: torch.Tensor
    drop_acl: torch.Tensor
    drop_no_route: torch.Tensor
    punt: torch.Tensor
    dnat: torch.Tensor
    snat: torch.Tensor
    nat_reversed: torch.Tensor
    drop_nat: torch.Tensor
    sess_insert_fail: torch.Tensor
    natsess_insert_fail: torch.Tensor
    sess_occupancy: torch.Tensor
    natsess_occupancy: torch.Tensor
    if_rx: torch.Tensor
    if_tx: torch.Tensor
    if_rx_bytes: torch.Tensor
    if_tx_bytes: torch.Tensor
    if_drops: torch.Tensor
    sess_hits: torch.Tensor
    fastpath: torch.Tensor
    sess_evict_expired: torch.Tensor
    sess_evict_victim: torch.Tensor
    natsess_evict_expired: torch.Tensor
    natsess_evict_victim: torch.Tensor
    ml_scored: torch.Tensor
    ml_flagged: torch.Tensor
    ml_drops: torch.Tensor
    tel_sketched: torch.Tensor
    tnt_limited: torch.Tensor
    tnt_qfail: torch.Tensor
    ovl_decap: torch.Tensor
    ovl_encap: torch.Tensor
    drop_overlay: torch.Tensor


# Per-packet drop attribution (the reference's codes).
DROP_NONE = 0
DROP_IP4 = 1        # ip4-input: TTL/length/bad interface
DROP_ACL = 2        # policy deny
DROP_NO_ROUTE = 3   # FIB miss
DROP_FIB = 4        # matched a drop route
DROP_NAT = 5        # NAT fail-closed (port collision / un-NATable proto)
DROP_ML = 6         # ML-stage enforce verdict
DROP_TENANT = 7     # tenant token-bucket quota exceeded
DROP_OVERLAY = 8    # overlay fail-closed: a VTEP-addressed frame with an
                    # unknown VNI or no valid inner header

# the packet tracer's and the collector's names of the codes
DROP_CAUSE_NAMES = {
    DROP_NONE: "none",
    DROP_IP4: "ip4-input",
    DROP_ACL: "acl-deny",
    DROP_NO_ROUTE: "no-route",
    DROP_FIB: "fib-drop",
    DROP_NAT: "nat-drop",
    DROP_ML: "ml-drop",
    DROP_TENANT: "tenant-quota",
    DROP_OVERLAY: "overlay-drop",
}


class StepResult(NamedTuple):
    pkts: PacketVector            # header fields after rewrites
    disp: torch.Tensor            # int32 [P] Disposition
    tx_if: torch.Tensor           # int32 [P] egress interface (-1 dropped)
    node_id: torch.Tensor         # int32 [P] destination node (-1 local)
    next_hop: torch.Tensor        # int32 [P] peer IP (uint32 bits)
    tables: object                # the tables, session state updated
    stats: StepStats
    drop_cause: torch.Tensor      # int32 [P] DROP_* (0 = none)
    established: torch.Tensor     # bool [P] admitted via a session
    dnat_applied: torch.Tensor    # bool [P]
    snat_applied: torch.Tensor    # bool [P]
    ml_flagged: torch.Tensor      # bool [P] (all False: stage off)
    ml_scores: torch.Tensor       # int32 [P] (all 0: stage off)
    # the overlay's outputs, None with ``overlay`` off: the outer header
    # (valid where encapped), the encapped mask and the wire VNI (-1
    # where not encapped)
    ovl_outer: Optional[PacketVector] = None
    ovl_encap: Optional[torch.Tensor] = None
    ovl_vni: Optional[torch.Tensor] = None


SWEEP_STRIDE_DEFAULT = 256


def _ingress(tables, pkts: PacketVector):
    """ip4-input plus the unconfigured-interface drop. Returns (pkts,
    drop_ip4, alive)."""
    pkts, drop_ip4 = ip4_input(pkts)
    n = tables.if_type.shape[0]
    bad_if = tables.if_type[gather_index(pkts.rx_if, n)] == 0
    drop_ip4 = drop_ip4 | (bad_if & pkts.valid)
    return pkts, drop_ip4, pkts.valid & ~drop_ip4


class Ingress(NamedTuple):
    """What the stages ahead of the session lookup hand the rest of a
    step (``_stage_in``); the tenancy and overlay fields are None with
    those stages off."""

    pkts: PacketVector                     # after decap and ip4-input
    drop_ip4: torch.Tensor
    alive: torch.Tensor                    # less the overlay and quota drops
    tid: Optional[torch.Tensor] = None     # int32 [P] billing tenant
    # int32 [P] the tenant of the header's address pair: the slice key
    # of the session lookup and the NAT reverse, whose keys are this
    # pair (never the VNI's tenant)
    kt: Optional[torch.Tensor] = None
    tnt_dropped: Optional[torch.Tensor] = None   # over the tenant's quota
    ovl_dropped: Optional[torch.Tensor] = None   # overlay fail-closed
    ovl_decapped: Optional[torch.Tensor] = None


def _tenant_eval(tables, pkts: PacketVector, alive, now, tnt_mode: str,
                 ovl_tid=None, ovl_decapped=None):
    """The tenant stage, run exactly once a step: each packet's tenant
    on the ingress header (a decapped packet's is its VNI's) and one
    token-bucket round, which writes the buckets. Returns (tid,
    dropped, kt) — ``kt`` the address-derived tenant before the VNI
    override — all None with the stage off."""
    if tnt_mode == "off":
        return None, None, None
    kt = tenant_ids(tables, pkts)
    tid = kt if ovl_tid is None else torch.where(ovl_decapped, ovl_tid, kt)
    return tid, tenant_limit(tables, tid, alive, now), kt


def _stage_in(tables, pkts: PacketVector, now, tnt_mode: str = "off",
              overlay: str = "off", ovl_inner=None, ovl_vni=None) -> Ingress:
    """Everything ahead of the session lookup: the overlay decap (its
    sidecar defaults to "no VXLAN framing": ``ovl_inner`` the outer
    header, ``ovl_vni`` all -1), ip4-input, the fail-closed overlay
    lanes leaving ``alive`` (ip4-input keeps its attribution), and the
    tenant stage, whose over-quota packets leave ``alive`` too."""
    ovl_bad = ovl_decapped = ovl_tid = None
    if overlay != "off":
        if ovl_inner is None:
            ovl_inner = pkts
        if ovl_vni is None:
            ovl_vni = torch.full_like(pkts.flags, -1)
        pkts, ovl_bad, ovl_decapped, ovl_tid = vxlan_decap_step(
            tables, pkts, ovl_inner, ovl_vni)
    pkts, drop_ip4, alive = _ingress(tables, pkts)
    ovl_dropped = None
    if ovl_bad is not None:
        ovl_dropped = ovl_bad & ~drop_ip4
        alive = alive & ~ovl_dropped
    tid, tnt_dropped, kt = _tenant_eval(tables, pkts, alive, now, tnt_mode,
                                        ovl_tid, ovl_decapped)
    if tnt_dropped is not None:
        alive = alive & ~tnt_dropped
    return Ingress(pkts, drop_ip4, alive, tid, kt, tnt_dropped, ovl_dropped,
                   ovl_decapped)


def _count(n: int, idx: torch.Tensor, mask: torch.Tensor,
           weight=None) -> torch.Tensor:
    """int32 [n] histogram of ``idx`` over the lanes of ``mask``
    (``weight`` per lane, default 1) — ``zeros.at[idx].add(w,
    mode="drop")`` of the reference. Integer index_add_ is exact in any
    order."""
    keep, i = scatter_index(idx, mask, n)
    w = keep.to(torch.int32) if weight is None else \
        torch.where(keep, weight, 0).to(torch.int32)
    return torch.zeros(n, dtype=torch.int32, device=idx.device) \
        .index_add_(0, i, w)


def _sum(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


class MlEval(NamedTuple):
    """The ML stage's masks of one step (``_ml_eval``); it scores every
    alive packet."""

    flagged: torch.Tensor        # bool [P]
    drop_wanted: torch.Tensor    # bool [P]: all False under "score"
    scores: torch.Tensor         # int32 [P]


def _ml_eval(tables, pkts: PacketVector, alive, established, sess_age,
             ml_mode: str, ml_kind: str, tid=None,
             shard=None) -> Optional[MlEval]:
    """The one ML-stage evaluation both tiers share: the post-NAT-reverse
    header and the session hit and its pre-touch age through
    ``ml_stage`` (one kernel launch on the card), per tenant with
    ``tid``. None when the stage is off; under "score" the policy's drop
    requests are dropped here (the compiled mode is every tenant's
    ceiling). With ``shard`` the partial scores of the sharded planes
    sum (plain PyTorch, as the reference's mesh stage is plain)."""
    if ml_mode == "off":
        return None
    if shard is not None:
        scores, flagged, drop_wanted = ml_stage_sharded(
            tables, pkts, alive, established, sess_age, kind=ml_kind,
            shard=shard, tid=tid)
    else:
        scores, flagged, drop_wanted = ml_stage(
            tables, pkts, alive, established, sess_age, kind=ml_kind,
            tid=tid)
    if ml_mode != "enforce":
        drop_wanted = torch.zeros_like(alive)
    return MlEval(flagged, drop_wanted, scores)


def _finish_step(tables, pkts: PacketVector, now, alive, drop_ip4,
                 drop_acl, permit, fib, forwarded, disp, tx_if,
                 established, nat_reversed, dnat_applied, snat_applied,
                 dropped_nat, sess_fail, natsess_fail, sess_evict_expired,
                 sess_evict_victim, natsess_evict_expired,
                 natsess_evict_victim, sweep_stride: int = 0,
                 fastpath: int = 0, ml: Optional[MlEval] = None,
                 ml_dropped=None, tel_mode: str = "off", tid=None,
                 tnt_dropped=None, tnt_qfail=None, overlay: str = "off",
                 fib_fn=fib_lookup_dense, ovl_dropped=None,
                 ovl_decapped=None, shard=None) -> StepResult:
    """Shared tail: the overlay encap, session sweep, ECMP member
    accounting, the flow sketch (``tel_mode`` full), the per-tenant
    accounting, drop attribution, counters and the StepResult.
    ``fastpath`` is the tier that ran (1 = the classify-free fast tier);
    ``ml`` the ML stage's evaluation and ``ml_dropped`` its enforced
    drops (already masked to permitted alive packets); ``tid`` /
    ``tnt_dropped`` / ``tnt_qfail`` the tenant stage's (None: off);
    ``ovl_dropped`` / ``ovl_decapped`` the decap's.

    The encap (``overlay`` vxlan): REMOTE-disposed packets with a tunnel
    next hop get an outer header resolved by a second walk over the
    same FIB planes (``fib_fn`` on the outer vector); an unroutable
    endpoint is a no-route drop. The outer walk is not counted in the
    ECMP plane: the inner walk already counted the packet's member."""
    zero = torch.zeros((), dtype=torch.int32, device=alive.device)
    ovl_outer = ovl_encap = ovl_vni = ovl_miss = None
    if overlay != "off":
        ovl_need = (forwarded & (disp == int(Disposition.REMOTE))
                    & (fib.next_hop != 0))
        outer = vxlan_encap(pkts, ovl_need, tables.ovl_vtep_ip,
                            fib.next_hop)
        ofib = fib_fn(tables, outer)
        ofib_ok = ofib.matched & (ofib.disp != int(Disposition.DROP))
        ovl_miss = ovl_need & ~ofib_ok
        forwarded = forwarded & ~ovl_miss
        disp = torch.where(ovl_miss, int(Disposition.DROP),
                           disp).to(torch.int32)
        ovl_encap = ovl_need & ofib_ok
        tx_if = torch.where(ovl_encap, ofib.tx_if,
                            torch.where(ovl_miss, -1, tx_if)).to(torch.int32)
        ovl_outer = outer._replace(
            flags=torch.where(ovl_encap, outer.flags, 0).to(torch.int32))
        # the tenant's VNI on the wire (tenancy off: slot 0, the
        # default), the default VNI where a tenant has none
        vni = (tables.tnt_vni[tid.long()] if tid is not None
               else tables.tnt_vni[:1].expand(alive.shape))
        vni = torch.where(vni >= 0, vni, DEFAULT_VNI)
        ovl_vni = torch.where(ovl_encap, vni, -1).to(torch.int32)
    session_sweep(tables, now, sweep_stride, shard)
    # per-member ECMP accounting into the carried [G, W] plane
    n_grp, n_way = tables.fib_ecmp_c.shape
    sel = forwarded & (fib.grp >= 0)
    gw = torch.where(sel, fib.grp * n_way + fib.way, 0).long()
    tables.fib_ecmp_c.view(-1).index_add_(0, gw, sel.to(torch.int32))
    tel_sketched = (tel_flow_update(tables, pkts, alive)[1]
                    if tel_mode == "full" else zero)
    # rate-limited and fail-closed overlay lanes left ``alive`` early but
    # were received: they count in rx and the per-interface counters
    alive_all = alive
    for m in (tnt_dropped, ovl_dropped):
        if m is not None:
            alive_all = alive_all | m
    if tid is not None:
        tnt_account(tables, tid, alive_all, forwarded, tnt_dropped,
                    torch.zeros_like(alive) if tnt_qfail is None
                    else tnt_qfail)

    n_ifaces = tables.if_type.shape[0]
    max_age = tables.sess_max_age

    def occupancy(valid, time):
        return _sum((valid == 1) & (_age(now, time) <= max_age))

    def count(m):
        return zero if m is None else _sum(m)

    # ml-drop wins attribution over the FIB outcomes (the packet never
    # reached forwarding) and loses to an ACL deny (ml_dropped is
    # masked to permitted traffic)
    drop_no_route = alive & permit & ~fib.matched
    fib_dropped = alive & permit & fib.matched & (
        fib.disp == int(Disposition.DROP))
    if ml_dropped is not None:
        drop_no_route = drop_no_route & ~ml_dropped
        fib_dropped = fib_dropped & ~ml_dropped
    if ovl_miss is not None:
        drop_no_route = drop_no_route | ovl_miss
    dropped = ((pkts.valid & (drop_ip4 | drop_acl | drop_no_route))
               | fib_dropped | dropped_nat)
    for m in (ml_dropped, tnt_dropped, ovl_dropped):
        if m is not None:
            dropped = dropped | m
    stats = StepStats(
        rx=_sum(alive_all),
        tx=_sum(forwarded),
        drop_ip4=_sum(drop_ip4),
        drop_acl=_sum(drop_acl),
        drop_no_route=_sum(drop_no_route),
        punt=_sum(forwarded & (disp == int(Disposition.HOST))),
        dnat=_sum(dnat_applied & forwarded),
        snat=_sum(snat_applied & forwarded),
        nat_reversed=_sum(nat_reversed & forwarded),
        drop_nat=_sum(dropped_nat),
        sess_insert_fail=_sum(sess_fail),
        natsess_insert_fail=_sum(natsess_fail),
        sess_occupancy=occupancy(tables.sess_valid, tables.sess_time),
        natsess_occupancy=occupancy(tables.natsess_valid,
                                    tables.natsess_time),
        if_rx=_count(n_ifaces, pkts.rx_if, alive_all),
        if_tx=_count(n_ifaces, tx_if, forwarded),
        if_rx_bytes=_count(n_ifaces, pkts.rx_if, alive_all, pkts.pkt_len),
        if_tx_bytes=_count(n_ifaces, tx_if, forwarded, pkts.pkt_len),
        if_drops=_count(n_ifaces, pkts.rx_if, dropped),
        sess_hits=_sum(established),
        fastpath=(torch.ones((), dtype=torch.int32, device=alive.device)
                  if fastpath else zero),
        sess_evict_expired=_sum(sess_evict_expired),
        sess_evict_victim=_sum(sess_evict_victim),
        natsess_evict_expired=_sum(natsess_evict_expired),
        natsess_evict_victim=_sum(natsess_evict_victim),
        ml_scored=zero if ml is None else _sum(alive),
        ml_flagged=zero if ml is None else _sum(ml.flagged),
        ml_drops=count(ml_dropped),
        tel_sketched=tel_sketched,
        tnt_limited=count(tnt_dropped),
        tnt_qfail=count(tnt_qfail),
        ovl_decap=count(ovl_decapped),
        ovl_encap=count(ovl_encap),
        drop_overlay=count(ovl_dropped),
    )
    # attribution stays exclusive: the quota and overlay drops left
    # ``alive`` before every other cause mask was derived from it
    drop_cause = (torch.where(pkts.valid & drop_ip4, DROP_IP4, 0)
                  + torch.where(drop_acl, DROP_ACL, 0)
                  + torch.where(drop_no_route, DROP_NO_ROUTE, 0)
                  + torch.where(fib_dropped, DROP_FIB, 0)
                  + torch.where(dropped_nat, DROP_NAT, 0))
    for m, cause in ((ml_dropped, DROP_ML), (tnt_dropped, DROP_TENANT),
                     (ovl_dropped, DROP_OVERLAY)):
        if m is not None:
            drop_cause = drop_cause + torch.where(m, cause, 0)
    drop_cause = drop_cause.to(torch.int32)
    return StepResult(
        pkts=pkts,
        disp=disp,
        tx_if=tx_if,
        node_id=torch.where(forwarded, fib.node_id, -1).to(torch.int32),
        next_hop=torch.where(forwarded, fib.next_hop, 0).to(torch.int32),
        tables=tables,
        stats=stats,
        drop_cause=drop_cause,
        established=established,
        dnat_applied=dnat_applied,
        snat_applied=snat_applied,
        ml_flagged=torch.zeros_like(alive) if ml is None else ml.flagged,
        ml_scores=(torch.zeros(alive.shape, dtype=torch.int32,
                               device=alive.device)
                   if ml is None else ml.scores),
        ovl_outer=ovl_outer,
        ovl_encap=ovl_encap,
        ovl_vni=ovl_vni,
    )


def pipeline_step(tables, pkts: PacketVector, now,
                  acl_global_fn=acl_classify_global,
                  acl_local_fn=acl_classify_local,
                  sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                  fib_fn=fib_lookup_dense, sess_impl: str = "gather",
                  sess_hash: str = "fwd", ml_mode: str = "off",
                  ml_kind: str = "mlp", tel_mode: str = "off",
                  tnt_mode: str = "off", overlay: str = "off",
                  ovl_inner=None, ovl_vni=None,
                  ingress: Optional[Ingress] = None,
                  shard=None) -> StepResult:
    """Process one packet vector through the full forwarding chain.
    ``now`` is the session clock in ticks: a 0-d int32 tensor on the
    tables' device (an int still works, for direct callers).
    ``ovl_inner`` / ``ovl_vni`` are the overlay's inner-header sidecar
    (``overlay`` vxlan). ``ingress``: the stages ahead of the session
    lookup already ran (the two-tier dispatcher's prefix): the chain
    takes their result, so the tokens are spent once; ``pkts`` and the
    sidecar are then unused. ``shard``: the mesh form (module doc)."""
    sym = sess_hash == "sym"
    ing = ingress if ingress is not None else _stage_in(
        tables, pkts, now, tnt_mode, overlay, ovl_inner, ovl_vni)
    pkts, drop_ip4, alive, tid = ing.pkts, ing.drop_ip4, ing.alive, ing.tid
    tnt = tid is not None

    # reflective session bypass, looked up on the raw (pre-NAT) header
    established, sess_hit_idx = session_lookup_reverse_idx(
        tables, pkts, now, shard=shard, tnt=tnt, impl=sess_impl, sym=sym,
        kt=ing.kt)
    established = established & alive
    # the ML age feature: the touch below rewrites the time in place,
    # so the age is read before it, in stream order
    sess_age = (session_hit_age(tables, sess_hit_idx, established, now,
                                shard=shard)
                if ml_mode != "off" else None)
    session_touch(tables, sess_hit_idx, established, now, shard=shard)

    # NAT44: reverse-translate return traffic, then DNAT new flows
    pkts, nat_reversed, nat_hit_idx = nat44_reverse(
        tables, pkts, alive, now, shard=shard, tnt=tnt, kt=ing.kt)
    nat44_touch(tables, nat_hit_idx, nat_reversed, now, shard=shard)
    # the ML stage scores the post-reverse header, as the fast tier does
    ml = _ml_eval(tables, pkts, alive, established, sess_age, ml_mode,
                  ml_kind, tid, shard)
    orig_dst, orig_dport = pkts.dst_ip, pkts.dport
    pkts, dnat_applied, dnat_self_snat = nat44_dnat(
        tables, pkts, alive & ~nat_reversed)

    # ACL classify (per-interface local table + node-global table)
    local_v = acl_local_fn(tables, pkts)
    glob_v = acl_global_fn(tables, pkts)
    permit = (local_v.permit & glob_v.permit) | established
    drop_acl = alive & ~permit
    # the enforced ML verdict, after the ACL's: deny > ml-drop > permit
    ml_dropped = None if ml is None else ml.drop_wanted & permit & alive

    # ip4-lookup on the possibly DNAT-rewritten destination
    fib = fib_fn(tables, pkts)
    forwarded = (alive & permit & fib.matched
                 & (fib.disp != int(Disposition.DROP)))
    if ml_dropped is not None:
        forwarded = forwarded & ~ml_dropped
    disp = torch.where(forwarded, fib.disp,
                       int(Disposition.DROP)).to(torch.int32)
    tx_if = torch.where(forwarded, fib.tx_if, -1).to(torch.int32)

    # SNAT for cluster-egress routes and self-snat DNAT mappings, new
    # outbound flows only
    is_l4 = (pkts.proto == 6) | (pkts.proto == 17)
    nat_capable = is_l4 | (pkts.proto == 1)
    fresh = ~nat_reversed & ~established
    orig_src, orig_sport = pkts.src_ip, pkts.sport
    want_snat = forwarded & fresh & nat_capable & (fib.snat | dnat_self_snat)
    pkts, snat_applied = nat44_snat(tables, pkts, want_snat)
    nat_unsupported = (forwarded & fresh & ~nat_capable & fib.snat
                       & (tables.nat_snat_ip != 0))

    # session install for newly permitted flows (post-NAT keys; with
    # tenancy in the slice of the key's tenant, not the billing tenant)
    want_sess = forwarded & ~established & nat_capable & ~nat_unsupported
    _, _, sess_fail, sess_ev_exp, sess_ev_vic = session_insert(
        tables, pkts, want_sess, now, shard=shard, tnt=tnt, sym=sym)
    nat_kind = (torch.where(dnat_applied, 1, 0)
                + torch.where(snat_applied, 2, 0)).to(torch.int32)
    _, nat_conflict, natsess_fail, nat_ev_exp, nat_ev_vic = nat44_record(
        tables, pkts, orig_dst, orig_dport, orig_src, orig_sport,
        nat_kind, (dnat_applied | snat_applied) & forwarded, now,
        shard=shard, tnt=tnt)
    # fail closed on reply-key collisions
    dropped_nat = nat_conflict | nat_unsupported
    forwarded = forwarded & ~dropped_nat
    disp = torch.where(dropped_nat, int(Disposition.DROP),
                       disp).to(torch.int32)
    tx_if = torch.where(dropped_nat, -1, tx_if).to(torch.int32)

    return _finish_step(
        tables, pkts, now, alive, drop_ip4, drop_acl, permit, fib,
        forwarded, disp, tx_if, established, nat_reversed, dnat_applied,
        snat_applied, dropped_nat, sess_fail, natsess_fail,
        sess_ev_exp, sess_ev_vic, nat_ev_exp, nat_ev_vic,
        sweep_stride=sweep_stride, ml=ml, ml_dropped=ml_dropped,
        tel_mode=tel_mode, tid=tid, tnt_dropped=ing.tnt_dropped,
        # the per-tenant congestion signal: slice insert failures
        tnt_qfail=(sess_fail | natsess_fail) if tnt else None,
        overlay=overlay, fib_fn=fib_fn, ovl_dropped=ing.ovl_dropped,
        ovl_decapped=ing.ovl_decapped, shard=shard)


# --- two-tier established-flow fast path ----------------------------
#
# Steady-state traffic is return flows the reflective session table
# already admits. The dispatch granularity is the batch: when EVERY
# alive packet hits a live session and none would DNAT-match after
# un-NAT, the classify-free tier below runs for the whole vector; any
# other batch takes the full chain unchanged.


def _pipeline_fast_finish(tables, ing: Ingress, pkts: PacketVector, now,
                          established, sess_hit_idx, nat_reversed,
                          nat_hit_idx,
                          sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                          fib_fn=fib_lookup_dense, ml_mode: str = "off",
                          ml_kind: str = "mlp", tel_mode: str = "off",
                          overlay: str = "off", shard=None) -> StepResult:
    """Tail of the classify-free tier, from the post-reverse header
    ``pkts`` on (``ing``: the step's ingress). Valid ONLY under the
    dispatch invariant (every alive packet is established, none
    DNAT-matches): ``permit`` collapses to ``established``, and SNAT,
    session insert and NAT record are statically empty (each needs a
    fresh flow or a DNAT hit), so they are elided — that elision is the
    tier's purpose. The ML stage is not elided: the fast tier scores
    (and enforces) as the full chain does, with the age read before the
    touch at the same point."""
    alive = ing.alive
    sess_age = (session_hit_age(tables, sess_hit_idx, established, now,
                                shard=shard)
                if ml_mode != "off" else None)
    session_touch(tables, sess_hit_idx, established, now, shard=shard)
    nat44_touch(tables, nat_hit_idx, nat_reversed, now, shard=shard)
    permit = established
    drop_acl = alive & ~permit
    ml = _ml_eval(tables, pkts, alive, established, sess_age, ml_mode,
                  ml_kind, ing.tid, shard)
    ml_dropped = None if ml is None else ml.drop_wanted & permit & alive
    fib = fib_fn(tables, pkts)
    forwarded = (alive & permit & fib.matched
                 & (fib.disp != int(Disposition.DROP)))
    if ml_dropped is not None:
        forwarded = forwarded & ~ml_dropped
    disp = torch.where(forwarded, fib.disp,
                       int(Disposition.DROP)).to(torch.int32)
    tx_if = torch.where(forwarded, fib.tx_if, -1).to(torch.int32)
    false_p = torch.zeros_like(alive)
    return _finish_step(
        tables, pkts, now, alive, ing.drop_ip4, drop_acl, permit, fib,
        forwarded, disp, tx_if, established, nat_reversed, false_p,
        false_p, false_p, false_p, false_p, false_p, false_p, false_p,
        false_p, sweep_stride=sweep_stride, fastpath=1, ml=ml,
        ml_dropped=ml_dropped, tel_mode=tel_mode, tid=ing.tid,
        # the fast tier inserts nothing: no slice insert fails
        tnt_dropped=ing.tnt_dropped, tnt_qfail=None, overlay=overlay,
        fib_fn=fib_fn, ovl_dropped=ing.ovl_dropped,
        ovl_decapped=ing.ovl_decapped, shard=shard)


def pipeline_step_fast(tables, pkts: PacketVector, now,
                       sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                       fib_fn=fib_lookup_dense, sess_impl: str = "gather",
                       sess_hash: str = "fwd", ml_mode: str = "off",
                       ml_kind: str = "mlp", tel_mode: str = "off",
                       tnt_mode: str = "off", overlay: str = "off",
                       ovl_inner=None, ovl_vni=None,
                       shard=None) -> StepResult:
    """The classify-free tier on its own: [overlay decap] -> ip4-input
    -> [tenant stage] -> session lookup/touch -> NAT reverse/touch ->
    FIB -> tx [-> overlay encap]. Equal to ``pipeline_step`` ONLY under
    the dispatch invariant that ``pipeline_step_auto`` checks."""
    ing = _stage_in(tables, pkts, now, tnt_mode, overlay, ovl_inner,
                    ovl_vni)
    tnt = ing.tid is not None
    established, sess_hit_idx = session_lookup_reverse_idx(
        tables, ing.pkts, now, shard=shard, tnt=tnt, impl=sess_impl,
        sym=sess_hash == "sym", kt=ing.kt)
    established = established & ing.alive
    rpkts, nat_reversed, nat_hit_idx = nat44_reverse(
        tables, ing.pkts, ing.alive, now, shard=shard, tnt=tnt, kt=ing.kt)
    return _pipeline_fast_finish(
        tables, ing, rpkts, now, established, sess_hit_idx, nat_reversed,
        nat_hit_idx, sweep_stride=sweep_stride, fib_fn=fib_fn,
        ml_mode=ml_mode, ml_kind=ml_kind, tel_mode=tel_mode,
        overlay=overlay, shard=shard)


class AutoPrefix(NamedTuple):
    """What the dispatch prefix hands either tier, and the flag. The
    prefix has run the tenant stage (its buckets are spent): both tiers
    take ``ingress`` and never run it again."""

    ingress: Ingress             # the stages ahead of the session lookup
    pkts: PacketVector           # the header after NAT reverse
    hits: torch.Tensor           # alive and admitted by a session
    sess_hit_idx: torch.Tensor
    nat_reversed: torch.Tensor
    nat_hit_idx: torch.Tensor
    ok: torch.Tensor             # 0-d bool: the fast tier may serve


def auto_prefix(tables, pkts: PacketVector, now, sess_impl: str = "gather",
                sess_hash: str = "fwd", tnt_mode: str = "off",
                overlay: str = "off", ovl_inner=None,
                ovl_vni=None, shard=None) -> AutoPrefix:
    """The dispatch prefix: the overlay decap, ip4-input, the tenant
    stage (which WRITES the token buckets: the one state this prefix
    moves), the session summary, NAT reverse and the DNAT probe;
    ``ok = all_hit & ~any(dnat_would)`` over the post-limit alive set,
    exactly as the reference computes its ``lax.cond`` predicate. With
    ``shard`` the reference also min-reduces the flag over the rule
    shards; here the node's one recombined summary is every shard's
    view, so the min of its shards' equal flags is the flag itself."""
    ing = _stage_in(tables, pkts, now, tnt_mode, overlay, ovl_inner,
                    ovl_vni)
    tnt = ing.tid is not None
    hits, sess_hit_idx, all_hit = session_batch_summary(
        tables, ing.pkts, ing.alive, now, shard=shard, tnt=tnt,
        impl=sess_impl, sym=sess_hash == "sym", kt=ing.kt)
    # NAT reverse runs before the DNAT probe: the un-NAT'd header is
    # what the full chain would hand nat44_dnat
    rpkts, nat_reversed, nat_hit_idx = nat44_reverse(
        tables, ing.pkts, ing.alive, now, shard=shard, tnt=tnt, kt=ing.kt)
    dnat_would = nat44_dnat_match(tables, rpkts, ing.alive & ~nat_reversed)
    return AutoPrefix(ing, rpkts, hits, sess_hit_idx, nat_reversed,
                      nat_hit_idx, all_hit & ~dnat_would.any())


def auto_fast(tables, pre: AutoPrefix, now,
              sweep_stride: int = SWEEP_STRIDE_DEFAULT,
              fib_fn=fib_lookup_dense, ml_mode: str = "off",
              ml_kind: str = "mlp", tel_mode: str = "off",
              overlay: str = "off", shard=None) -> StepResult:
    """The fast tier behind the prefix: it reuses the prefix's lookups
    (valid only where ``pre.ok`` holds)."""
    return _pipeline_fast_finish(
        tables, pre.ingress, pre.pkts, now, pre.hits, pre.sess_hit_idx,
        pre.nat_reversed, pre.nat_hit_idx, sweep_stride=sweep_stride,
        fib_fn=fib_fn, ml_mode=ml_mode, ml_kind=ml_kind, tel_mode=tel_mode,
        overlay=overlay, shard=shard)


def auto_full(tables, pre: AutoPrefix, now, **gates) -> StepResult:
    """The full chain behind the prefix: from the prefix's ingress on
    (the decapped header, the masks, the tenant trio), so the tokens
    are spent once whichever tier runs, as the reference hands its
    full branch ``_tnt_pre``; ``gates``: ``pipeline_step``'s."""
    return pipeline_step(tables, None, now, ingress=pre.ingress, **gates)


def pipeline_step_auto(tables, pkts: PacketVector, now,
                       acl_global_fn=acl_classify_global,
                       acl_local_fn=acl_classify_local,
                       sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                       fib_fn=fib_lookup_dense, sess_impl: str = "gather",
                       sess_hash: str = "fwd", ml_mode: str = "off",
                       ml_kind: str = "mlp", tel_mode: str = "off",
                       tnt_mode: str = "off", overlay: str = "off",
                       ovl_inner=None, ovl_vni=None,
                       shard=None) -> StepResult:
    """Two-tier dispatch: the fast tier when the whole batch rides
    established sessions, the full chain otherwise.

    ``auto_prefix`` computes the dispatch flag on the device exactly as
    the reference computes it, and then it is read to the host: the ONE
    host sync of this step. The reference branches on the device with
    ``lax.cond``; eager PyTorch cannot branch on a device value without
    reading it, and running both tiers to select with ``torch.where``
    would elide nothing, which is the tier's only purpose. So exactly
    one tier runs: the fast tier reuses the prefix's lookups, the full
    chain its ingress (the overlay decap and the tenant stage ran once,
    in the prefix)."""
    pre = auto_prefix(tables, pkts, now, sess_impl=sess_impl,
                      sess_hash=sess_hash, tnt_mode=tnt_mode,
                      overlay=overlay, ovl_inner=ovl_inner, ovl_vni=ovl_vni,
                      shard=shard)
    gates = dict(sweep_stride=sweep_stride, fib_fn=fib_fn, ml_mode=ml_mode,
                 ml_kind=ml_kind, tel_mode=tel_mode, overlay=overlay,
                 shard=shard)
    if bool(pre.ok):  # the step's one host sync (docstring)
        return auto_fast(tables, pre, now, **gates)
    return auto_full(tables, pre, now, acl_global_fn=acl_global_fn,
                     acl_local_fn=acl_local_fn, sess_impl=sess_impl,
                     sess_hash=sess_hash, **gates)


# --- what a step program copies in and out ----------------------------

_RESULT_FIELDS = ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
                  "established", "dnat_applied", "snat_applied",
                  "ml_flagged", "ml_scores")


def result_fields(res: StepResult) -> list:
    """Every tensor of a StepResult but the tables, in a fixed order:
    the header, the per-packet fields, the counters, then (overlay on)
    the outer header, the encapped mask and the wire VNI."""
    ovl = ([] if res.ovl_outer is None
           else list(res.ovl_outer) + [res.ovl_encap, res.ovl_vni])
    return (list(res.pkts) + [getattr(res, f) for f in _RESULT_FIELDS]
            + list(res.stats) + ovl)


def result_of(fields, tables) -> StepResult:
    """The inverse of ``result_fields`` over ``tables``."""
    n_pk, n_res = len(PacketVector._fields), len(_RESULT_FIELDS)
    n_st = n_pk + n_res + len(StepStats._fields)
    res = dict(zip(_RESULT_FIELDS, fields[n_pk:n_pk + n_res]))
    ovl = fields[n_st:]
    if ovl:
        res.update(ovl_outer=PacketVector(*ovl[:n_pk]), ovl_encap=ovl[n_pk],
                   ovl_vni=ovl[n_pk + 1])
    return StepResult(pkts=PacketVector(*fields[:n_pk]), tables=tables,
                      stats=StepStats(*fields[n_pk + n_res:n_st]), **res)


def packed_vector(flat: torch.Tensor) -> PacketVector:
    """Decode a ``[5, B]`` bit-packed int32 batch (the reference's
    ``_packed_call`` input rows: src_ip, dst_ip, sport<<16 | dport,
    pkt_len<<16 | proto<<8 | ttl, rx_if<<8 | flags) on the device. The
    address columns are views of its rows."""
    def field(row, shift, mask):
        return (flat[row] >> shift) & mask  # the mask drops the sign

    return PacketVector(
        src_ip=flat[0], dst_ip=flat[1], proto=field(3, 8, 0xFF),
        sport=field(2, 16, 0xFFFF), dport=field(2, 0, 0xFFFF),
        ttl=field(3, 0, 0xFF), pkt_len=field(3, 16, 0xFFFF),
        rx_if=field(4, 8, 0xFFFFFF), flags=field(4, 0, 0xFF))


def tel_observe(tables, res: StepResult, stamp, now_us) -> torch.Tensor:
    """The packed boundary's wire-latency observation (the reference's
    ``_packed_call`` with telemetry on), after the step: every valid
    packet of a stamped batch (``stamp`` > 0) whose latency ``now_us -
    stamp`` (int32, wrapping) is not negative goes into the histogram.
    ``stamp`` and ``now_us`` are 0-d int32 tensors (a captured program
    copies each run's values into them). Returns the count observed."""
    lat = to_i32(now_us.to(torch.int64) - stamp.to(torch.int64))
    observe = res.pkts.valid & (stamp > 0) & (lat >= 0)
    return tel_latency_update(tables, observe, lat.expand(
        observe.shape))[1]


def packed_fields(res: StepResult, tel_observed=None) -> list:
    """The reference's ``_packed_call`` output (``with_aux``): the five
    [B] rows of the packed result — src_ip, dst_ip, sport<<16 | dport,
    drop_cause<<28 | disp<<24 | ttl<<16 | tx_if (0xFFFF: none), next_hop
    — and the twelve 0-d aux rows of ``PACKED_AUX_SCHEMA``;
    ``tel_observed`` is ``tel_observe``'s count (0 with telemetry
    off)."""
    p, s = res.pkts, res.stats
    row2 = (u32(p.sport) << 16) | (u32(p.dport) & 0xFFFF)
    row3 = (((u32(res.drop_cause) & 0xF) << 28)
            | ((u32(res.disp) & 0xF) << 24)
            | ((u32(p.ttl) & 0xFF) << 16) | (u32(res.tx_if) & 0xFFFF))
    rows = [p.src_ip, p.dst_ip, to_i32(row2), to_i32(row3), res.next_hop]
    aux = [s.fastpath, s.rx, s.sess_hits,
           s.sess_insert_fail + s.natsess_insert_fail,
           (s.sess_evict_expired + s.sess_evict_victim
            + s.natsess_evict_expired + s.natsess_evict_victim),
           s.ml_scored, s.ml_flagged, s.ml_drops,
           torch.zeros_like(s.rx) if tel_observed is None else tel_observed,
           s.tel_sketched, s.tnt_limited, s.tnt_qfail]
    return rows + aux


def _classifier_fns(impl: str):
    """(global, local) classify functions of one classifier rung. Only
    BV swaps the local classify too: the MXU rung reformulates the
    global table alone, so ``mxu`` keeps the dense local classify."""
    if impl == "mxu":
        from vpp_tpu_torch.ops.acl_mxu import acl_classify_global_mxu

        return acl_classify_global_mxu, acl_classify_local
    if impl == "bv":
        from vpp_tpu_torch.ops.acl_bv import (
            acl_classify_global_bv,
            acl_classify_local_bv,
        )

        return acl_classify_global_bv, acl_classify_local_bv
    if impl == "pallas":
        from vpp_tpu_torch.ops.acl_bv import (
            acl_classify_global_pallas,
            acl_classify_local_pallas,
        )

        return acl_classify_global_pallas, acl_classify_local_pallas
    if impl != "dense":
        raise ValueError(f"unknown classifier impl {impl!r}")
    return acl_classify_global, acl_classify_local


def _fib_fn(fib_impl: str):
    """The ip4-lookup of one FIB rung."""
    if fib_impl == "lpm":
        from vpp_tpu_torch.ops.lpm import fib_lookup_lpm

        return fib_lookup_lpm
    if fib_impl == "pallas":
        from vpp_tpu_torch.ops.lpm import fib_lookup_lpm_fused

        return fib_lookup_lpm_fused
    if fib_impl != "dense":
        raise ValueError(f"unknown fib impl {fib_impl!r}")
    return fib_lookup_dense


@functools.lru_cache(maxsize=None)
def make_pipeline_step(impl: str = "dense", skip_local: bool = False,
                       fast: bool = False,
                       sweep_stride: int = SWEEP_STRIDE_DEFAULT,
                       ml_mode: str = "off", ml_kind: str = "mlp",
                       tel_mode: str = "off", tnt_mode: str = "off",
                       fib_impl: str = "dense", sess_impl: str = "gather",
                       sess_hash: str = "fwd", overlay: str = "off"):
    """Compose one step callable ``step(tables, pkts, now)`` from the
    epoch's gates (the reference's factory and key): ``fast`` builds
    the two-tier ``pipeline_step_auto``, else the full chain. Its parts
    ride along as attributes: ``step.full(tables, pkts, now)`` and, with
    ``fast``, ``step.prefix(tables, pkts, now)``, ``step.fast(tables,
    prefix, now)`` and ``step.slow(tables, prefix, now)`` (the full
    chain behind the prefix); ``step.tel_mode`` is the telemetry gate
    the packed boundary reads (``tel_observe``), ``step.overlay`` the
    overlay gate. With ``overlay`` vxlan the step and the full chain and
    the prefix take the inner-header sidecar too: ``step(tables, pkts,
    now, ovl_inner, ovl_vni)``."""
    from vpp_tpu_torch.ops.acl import acl_local_none

    if ml_mode not in ("off", "score", "enforce"):
        raise ValueError(f"unknown ml_mode {ml_mode!r}")
    if ml_kind not in ML_KINDS:
        raise ValueError(f"unknown ml_kind {ml_kind!r}")
    if tel_mode not in TEL_MODES:
        raise ValueError(f"unknown tel_mode {tel_mode!r}")
    if tnt_mode not in ("off", "on"):
        raise ValueError(f"unknown tnt_mode {tnt_mode!r}")
    if overlay not in ("off", "vxlan"):
        raise ValueError(f"unknown overlay {overlay!r}")
    if sess_impl not in ("gather", "pallas"):
        raise ValueError(f"unknown sess_impl {sess_impl!r}")
    if sess_hash not in ("fwd", "sym"):
        raise ValueError(f"unknown sess_hash {sess_hash!r}")
    acl_global_fn, acl_local_fn = _classifier_fns(impl)
    fib_fn = _fib_fn(fib_impl)
    if skip_local:
        acl_local_fn = acl_local_none
    base = pipeline_step_auto if fast else pipeline_step
    tier_gates = dict(sweep_stride=sweep_stride, fib_fn=fib_fn,
                      ml_mode=ml_mode, ml_kind=ml_kind, tel_mode=tel_mode,
                      overlay=overlay)
    chain_gates = dict(tier_gates, acl_global_fn=acl_global_fn,
                       acl_local_fn=acl_local_fn, sess_impl=sess_impl,
                       sess_hash=sess_hash)

    def step(tables, pkts: PacketVector, now, ovl_inner=None,
             ovl_vni=None) -> StepResult:
        return base(tables, pkts, now, tnt_mode=tnt_mode,
                    ovl_inner=ovl_inner, ovl_vni=ovl_vni, **chain_gates)

    # the parts a step program captures one by one
    step.full = functools.partial(pipeline_step, tnt_mode=tnt_mode,
                                  **chain_gates)
    if fast:
        step.prefix = functools.partial(
            auto_prefix, sess_impl=sess_impl, sess_hash=sess_hash,
            tnt_mode=tnt_mode, overlay=overlay)
        step.fast = functools.partial(auto_fast, **tier_gates)
        step.slow = functools.partial(auto_full, **chain_gates)
    step.tel_mode = tel_mode
    step.overlay = overlay

    step.__name__ = "pipeline_step_{}{}{}{}{}{}{}{}{}{}".format(
        impl, "_nolocal" if skip_local else "", "_auto" if fast else "",
        "" if ml_mode == "off" else f"_ml{ml_mode}"
        + ("_forest" if ml_kind == "forest" else ""),
        "" if tel_mode == "off" else f"_tel{tel_mode}",
        "" if tnt_mode == "off" else "_tenancy",
        "" if fib_impl == "dense" else f"_fib{fib_impl}",
        "" if sess_impl == "gather" else f"_sess{sess_impl}",
        "" if sess_hash == "fwd" else f"_h{sess_hash}",
        "" if overlay == "off" else f"_o{overlay}")
    return step
