"""Reflective-flow session table: a W-way set-associative hash map.

The PyTorch counterpart of ``vpp_tpu/ops/session.py``: every session
column is a ``[n_buckets, W]`` tensor, a flow hashes to ONE bucket, a
lookup fetches the bucket's W ways, and a batch insert resolves in one
election round (the reference's module doc explains the rep / leader /
rank scheme; only its ``sort`` election — the ``auto`` choice — is
ported). With tenancy on (``tnt=True``) a key's bucket lies in its
tenant's slice: ``tenant_bucket``, ``base[kt] + (mix & mask[kt])`` with
``kt`` the tenant of the key's address pair.

The mesh form (``shard``, a ``parallel.partition.ShardCtx``): the bucket
axis is split over the rule shards in blocks, shard ``s`` owning global
buckets ``[s * NB/S, (s + 1) * NB/S)``. A node's session columns keep
the global ``[NB, W]`` layout, so shard ``s``'s columns are the
contiguous row block ``shard_view(col, shard)[s]``. The flow hash is
taken over the node's whole (global) bucket count, the reference's
``global_buckets``, so a flow lands in the bucket it would have
standalone and exactly one shard owns it (``shard_buckets``): a
lookup's gather at the global bucket is the
owning shard's probe, and the owner's values are what the reference's
psum of owner-masked values gives (a miss reads slot 0, as there).
Inserts elect per shard, each over the packets whose bucket it owns (a
bucket's contenders all live on its owner), and ``shard_combine_mask``
folds the [S, P] per-shard outcomes; the in-step sweep ages the same
stride of every shard's block from the one replicated cursor.

In place. JAX arrays are immutable, so the reference returns new
columns; here the touch, insert and sweep scatters write the session
tensors IN PLACE (the table is the largest state on the card, and a
copy per step would move it whole). The returned ``tables`` is the
same NamedTuple. Callers that need a side-effect-free step clone the
state first (``Dataplane.probe``).

Scatters without ``mode="drop"``. The reference sends masked lanes to an
out-of-range index that is dropped. ``_scatter_set`` instead redirects
every masked lane to the slot of the first writing lane, carrying that
lane's value (or, when no lane writes, to slot 0 carrying slot 0's own
value), so each slot receives only identical values: deterministic on
CUDA without a host sync, O(P) work.

The session lookup — kernel 1 — is ``sess_probe_ways``: the CUDA kernel
of csrc/sess_probe.cu for CUDA tensors, which takes the header columns
and forms the reversed key, the bucket hash and the flat slot itself
(the reference computes them around its TPU kernel), and its plain
version ``sess_probe_reverse_plain`` for CPU tensors. The reference
gates its TPU kernel on a VMEM budget (``session_pallas_fits``); the
Hopper kernel reads the columns from device memory, so there is no such
budget and no such gate.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from vpp_tpu_torch.ops import _cuda
from vpp_tpu_torch.ops.acl import first_true
from vpp_tpu_torch.pipeline.vector import PacketVector, to_i32, u32

_BIG = 0x7FFFFFFF
_M32 = 0xFFFFFFFF


# --- bucket-axis sharding (module doc) ---------------------------------


def shard_buckets(h_global: torch.Tensor, n_local: int, shard):
    """(owner [P] int32, local bucket [P] int32) of globally hashed
    buckets: blocked ownership, so the owner is the high bits and the
    local row the low bits (``n_local`` is a power of two)."""
    del shard  # the geometry is n_local's
    return ((h_global // n_local).to(torch.int32),
            (h_global & (n_local - 1)).to(torch.int32))


def shard_view(col: torch.Tensor, shard) -> torch.Tensor:
    """``[S, NB/S, ...]``: shard s's block of a node's bucket grid at
    ``[s]`` (a view)."""
    return col.view(shard.shards, col.shape[0] // shard.shards,
                    *col.shape[1:])


def shard_combine_mask(masks: torch.Tensor, shard) -> torch.Tensor:
    """Recombine per-shard ownership-masked bool masks ``[S, P]``: at
    most one shard asserts a packet, so the sum of the int forms is
    0 or 1 (the reference's psum)."""
    if shard is None:
        return masks
    return masks.to(torch.int32).sum(dim=0) > 0


def _owned_idx(found: torch.Tensor, hit_idx: torch.Tensor) -> torch.Tensor:
    """The psum of the owner's masked slot: the slot where found, 0
    elsewhere (the reference's sharded ``hit_idx``)."""
    return torch.where(found, hit_idx, 0).to(torch.int32)


def _insert_sharded(valid, time, keys, key_vals, extras, extra_vals, h,
                    want, now, max_age, shard) -> tuple:
    """``hashmap_insert`` on a bucket-sharded grid: each shard elects
    over its own block the packets whose global bucket ``h`` it owns,
    and the five [S, P] outcome masks recombine."""
    owner, hl = shard_buckets(h, valid.shape[0] // shard.shards, shard)
    outs = []
    for s in range(shard.shards):
        outs.append(hashmap_insert(
            shard_view(valid, shard)[s], shard_view(time, shard)[s],
            tuple(shard_view(a, shard)[s] for a in keys), key_vals,
            tuple(shard_view(a, shard)[s] for a in extras), extra_vals,
            hl, want & (owner == s), now, max_age=max_age))
    return tuple(shard_combine_mask(torch.stack(m), shard)
                 for m in zip(*outs))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) without int64
    overflow: split the constant into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_mix(src, dst, ports, proto) -> torch.Tensor:
    """Full 32-bit multiplicative xor mix of the 5-tuple; int32-bit
    inputs, returns the uint32 value as int64."""
    h = _mul32(u32(src), 0x9E3779B1)
    h ^= _mul32(u32(dst), 0x85EBCA77)
    h ^= _mul32(u32(ports), 0xC2B2AE3D)
    h ^= _mul32(u32(proto), 0x27D4EB2F)
    h ^= h >> 15
    h = _mul32(h, 0x2545F491)
    h ^= h >> 13
    return h


def _bucket(mix: torch.Tensor, n_buckets: int) -> torch.Tensor:
    return (mix & (n_buckets - 1)).to(torch.int32)


def tenant_bucket(tables, key_a, key_b, mix: torch.Tensor, base, mask
                  ) -> torch.Tensor:
    """The tenant-sliced bucket of a hashed key: the tenant of the key's
    ADDRESS PAIR (symmetric, so a forward insert and its reply's lookup
    agree) picks the range ``[base[kt], base[kt] + mask[kt] + 1)`` and
    the hash lands inside it (int32 [P]). With the default staging
    (base 0, the full-table mask) it is the unsliced bucket."""
    from vpp_tpu_torch.tenancy.derive import key_tenant

    return _slice_bucket(mix, key_tenant(tables, key_a, key_b), base, mask)


def _slice_bucket(mix: torch.Tensor, kt, base, mask) -> torch.Tensor:
    """``base[kt] + (mix & mask[kt])`` in uint32, as int32."""
    k = kt.long()
    return to_i32(u32(base[k]) + (mix & u32(mask[k])))


def _pack_ports(sport, dport) -> torch.Tensor:
    """sport << 16 | dport as a uint32 bit pattern (int32 tensor)."""
    return to_i32((u32(sport) << 16) | u32(dport))


def canon_mix(src, dst, sport, dport, proto) -> torch.Tensor:
    """Direction-invariant 5-tuple mix (the ``sess_hash: sym`` bucket
    family): endpoints ordered by unsigned address, ports following
    their endpoints, before the same ``_hash_mix``."""
    swap = (u32(src) > u32(dst)) | ((src == dst) & (sport > dport))
    a = torch.where(swap, dst, src)
    b = torch.where(swap, src, dst)
    ports = torch.where(swap, _pack_ports(dport, sport),
                        _pack_ports(sport, dport))
    return _hash_mix(a, b, ports, proto)


def _age(now, time: torch.Tensor) -> torch.Tensor:
    """now - time in int32 with wraparound (JAX's int32 arithmetic).
    ``now`` is an int or a 0-d int32 tensor (the step's clock: read on
    the device, so a captured step bakes no clock in)."""
    return to_i32(now - time.to(torch.int64))


def _scatter_set(flat: torch.Tensor, idx: torch.Tensor,
                 mask: torch.Tensor, vals) -> None:
    """``flat[idx[i]] = vals[i]`` for the lanes of ``mask``, in place,
    deterministically (module doc). ``vals`` is [P], a 0-d tensor (the
    step's clock) or an int; the written slots of distinct masked lanes
    must agree on their value."""
    if torch.is_tensor(vals):
        vals = vals.to(flat.dtype).expand(mask.shape)
    else:  # a fill on the device, not a host-to-device copy
        vals = torch.full(mask.shape, int(vals), dtype=flat.dtype,
                          device=flat.device)
    # a [1] index, not a 0-d one: indexing with a 0-d tensor reads it
    # back to the host
    first = first_true(mask).view(1)
    safe = torch.where(mask, idx.to(torch.int64), 0)
    fill = torch.where(mask.any(), vals[first], flat[:1])
    flat.index_put_((torch.where(mask, safe, safe[first]),),
                    torch.where(mask, vals, fill))


# --- kernel 1: the fused session lookup ---------------------------------


def sess_probe_ways_plain(b, key_src, key_dst, key_ports, key_proto, valid,
                          src, dst, ports, proto, time, now, max_age):
    """The bucket probe of the gather rung on the reference kernel's
    signature: ``b`` [P] home buckets, ``key_*`` [P] the key, the six
    [NB, W] columns. Returns (found [P] bool, first [P] int32 — the
    lowest matching way, 0 on a miss)."""
    bl = b.long()
    match = ((valid[bl] == 1)
             & (src[bl] == key_src[:, None])
             & (dst[bl] == key_dst[:, None])
             & (ports[bl] == key_ports[:, None])
             & (proto[bl] == key_proto[:, None])
             & (_age(now, time[bl]) <= max_age))
    return match.any(dim=1), first_true(match).to(torch.int32)


def _reverse_keys(src_ip, dst_ip, proto, sport, dport):
    """The key a packet's reply looks up: the forward 5-tuple its
    session was stored under."""
    return dst_ip, src_ip, _pack_ports(dport, sport), proto


def _reverse_bucket(src_ip, dst_ip, proto, sport, dport, keys,
                    n_buckets: int, sym: bool, tnt=None):
    if sym:
        mix = canon_mix(src_ip, dst_ip, sport, dport, proto)
    else:
        mix = _hash_mix(*keys)
    if tnt is not None:
        return _slice_bucket(mix, *tnt)
    return _bucket(mix, n_buckets)


def sess_probe_reverse_plain(src_ip, dst_ip, proto, sport, dport, valid, src,
                             dst, ports, sess_proto, time, now, max_age,
                             sym: bool = False, tnt=None):
    """The plain PyTorch version of ``sess_probe_ways``: the reversed
    key, the bucket (in the key tenant's slice with ``tnt`` = (kt [P],
    base [T], mask [T])), ``sess_probe_ways_plain`` and the flat
    slot."""
    n_buckets, ways = valid.shape
    hdr = (src_ip, dst_ip, proto, sport, dport)
    keys = _reverse_keys(*hdr)
    b = _reverse_bucket(*hdr, keys, n_buckets, sym, tnt)
    found, first = sess_probe_ways_plain(b, *keys, valid, src, dst, ports,
                                         sess_proto, time, now, max_age)
    return found, b * ways + first


# the C entry's argument types (kernels.cuh), the stream last
SESS_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int32]
                 + [ctypes.c_void_p] * 9 + [ctypes.c_int32] * 4
                 + [ctypes.c_void_p, ctypes.c_int32] * 2
                 + [ctypes.c_void_p] * 3)


def _scalar_arg(v, name: str, dev):
    """(device pointer, value) of a scalar argument of the C entry: a
    0-d int32 tensor is read by the kernel through its pointer (a CUDA
    graph replays it with the value of the day), an int goes by value
    (wrapped to int32, as the reference's ``jnp.int32``)."""
    if torch.is_tensor(v):
        _cuda.require(v, name, ndim=0, device=dev)
        return _cuda.ptr(v), 0
    v = int(v) & _M32
    return None, v - (1 << 32) if v >= (1 << 31) else v


def sess_launch_args(src_ip, dst_ip, proto, sport, dport, valid, src, dst,
                     ports, sess_proto, time, now, max_age, sym=False,
                     tnt=None):
    """The checked arguments of csrc/sess_probe.cu's C entry but the
    stream, and the outputs (found, slot) they point at. ``tnt`` (kt
    [P], base [T], mask [T]) goes by pointer; None passes three nulls
    (the unsliced bucket)."""
    hdr = (src_ip, dst_ip, proto, sport, dport)
    cols = (valid, src, dst, ports, sess_proto, time)
    dev = valid.device
    nb, ways = valid.shape
    p = src_ip.shape[0]
    for c in cols:
        _cuda.require(c, "sess_probe_ways.column", ndim=2, device=dev)
        if tuple(c.shape) != (nb, ways):
            raise ValueError("sess_probe_ways: column shape mismatch")
    for v in hdr:
        _cuda.require(v, "sess_probe_ways.header", ndim=1, device=dev)
        if v.shape[0] != p:
            raise ValueError("sess_probe_ways: header length mismatch")
    if nb & (nb - 1):
        raise ValueError(f"sess_probe_ways: {nb} buckets, not a power of 2")
    if tnt is None:
        tnt_args = (None, None, None)
    else:
        kt, base, mask = tnt
        _cuda.require(kt, "sess_probe_ways.kt", ndim=1, device=dev)
        for v in (base, mask):
            _cuda.require(v, "sess_probe_ways.tnt_plane", ndim=1, device=dev)
        if kt.shape[0] != p or base.shape != mask.shape:
            raise ValueError("sess_probe_ways: tenant slice shape mismatch")
        tnt_args = tuple(_cuda.ptr(x) for x in tnt)
    now_arg = _scalar_arg(now, "sess_probe_ways.now", dev)
    age_arg = _scalar_arg(max_age, "sess_probe_ways.max_age", dev)
    vec4 = ways == 4 and all(c.data_ptr() % 16 == 0 for c in cols)
    found = torch.empty(p, dtype=torch.bool, device=dev)
    slot = torch.empty(p, dtype=torch.int32, device=dev)
    args = (*(_cuda.ptr(x) for x in hdr), int(sym), *tnt_args,
            *(_cuda.ptr(x) for x in cols), p, nb, ways, int(vec4), *now_arg,
            *age_arg, _cuda.ptr(found), _cuda.ptr(slot))
    return args, (found, slot)


def sess_probe_ways(src_ip, dst_ip, proto, sport, dport, valid, src, dst,
                    ports, sess_proto, time, now, max_age, sym: bool = False,
                    tnt=None):
    """The reflective-session lookup of a packet vector: the kernel of
    csrc/sess_probe.cu on CUDA tensors (reversed key, bucket hash —
    ``canon_mix`` with ``sym``, in the key tenant's slice with ``tnt`` —
    W-way probe and slot in one launch), the plain version on CPU
    tensors. Header columns [P] int32, the six [NB, W] session columns,
    ``now`` and ``max_age`` each an int or a 0-d int32 tensor (which the
    kernel reads on the device), ``tnt`` None or (kt [P], base [T], mask
    [T]) int32. Returns (found [P] bool, slot [P] int32 = bucket·W + the
    lowest matching way, bucket·W on a miss)."""
    cols = (src_ip, dst_ip, proto, sport, dport, valid, src, dst, ports,
            sess_proto, time)
    if not _cuda.use_kernels(valid):
        return sess_probe_reverse_plain(*cols, now, max_age, sym=sym,
                                        tnt=tnt)
    args, out = sess_launch_args(*cols, now, max_age, sym, tnt)
    fn = _cuda.library("sess_probe").sess_probe_ways
    fn.argtypes = SESS_ARGTYPES
    fn.restype = ctypes.c_int
    _cuda.check(fn(*args, _cuda.stream()), "sess_probe_ways")
    sess_probe_ways.launches += 1
    return out


sess_probe_ways.launches = 0


# --- lookup / touch ----------------------------------------------------


def _columns(tables):
    return (tables.sess_valid, tables.sess_src, tables.sess_dst,
            tables.sess_ports, tables.sess_proto, tables.sess_time)


def session_lookup_reverse(tables, pkts: PacketVector, now=None,
                           impl: str = "gather", sym: bool = False,
                           tnt: bool = False) -> torch.Tensor:
    """Is each packet the return traffic of an established session?
    Bool [P]; with ``now``, entries idle past ``sess_max_age`` are dead
    (without it the (0, _BIG) no-age convention applies)."""
    t_now, max_age = ((now, tables.sess_max_age) if now is not None
                      else (0, _BIG))
    probe = sess_probe_ways if impl == "pallas" else sess_probe_reverse_plain
    found, _ = probe(*pkts.five_tuple, *_columns(tables), t_now, max_age,
                     sym=sym, tnt=_probe_slice(tables, pkts, tnt))
    return found


def _probe_slice(tables, pkts: PacketVector, tnt: bool, kt=None):
    """The probe's ``tnt`` argument: the reply key's tenant slice, or
    None (unsliced). ``kt``: the key tenants where the caller has them
    (the tenant of the packet's address pair, which the reply key
    shares)."""
    if not tnt:
        return None
    if kt is None:
        from vpp_tpu_torch.tenancy.derive import key_tenant

        kt = key_tenant(tables, pkts.dst_ip, pkts.src_ip)
    return kt, tables.tnt_sess_base, tables.tnt_sess_mask


def session_lookup_reverse_idx(tables, pkts: PacketVector, now,
                               shard=None, tnt: bool = False,
                               impl: str = "gather", sym: bool = False,
                               kt=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found [P] bool, flat matched slot [P] int32 = bucket·W + way)
    of the reversed 5-tuple. ``impl`` is the session ladder's rung:
    ``pallas`` looks up through ``sess_probe_ways``, ``gather`` through
    its plain version. With ``tnt`` the bucket lies in the slice of the
    key's tenant (``tenant_bucket``); ``kt``, where given, is that
    tenant (the pipeline derives it once a step). With ``shard`` a miss
    reads slot 0 (module doc); ``validate_partitioning`` keeps the
    ``pallas`` rung off a mesh."""
    probe = sess_probe_ways if impl == "pallas" else sess_probe_reverse_plain
    found, hit_idx = probe(*pkts.five_tuple, *_columns(tables), now,
                           tables.sess_max_age, sym=sym,
                           tnt=_probe_slice(tables, pkts, tnt, kt))
    if shard is not None:
        hit_idx = _owned_idx(found, hit_idx)
    return found, hit_idx


def session_batch_summary(tables, pkts: PacketVector, alive, now,
                          shard=None, tnt: bool = False,
                          impl: str = "gather", sym: bool = False, kt=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Batched hit summary for the two-tier dispatch (pipeline/graph.py
    ``pipeline_step_auto``): ``(hits, hit_idx, all_hit)`` — ``hits``
    masks alive packets admitted by a live reflective session,
    ``hit_idx`` their matched slots, ``all_hit`` the 0-d bool that
    EVERY alive packet rides a session (vacuously true for a batch
    with none alive)."""
    found, hit_idx = session_lookup_reverse_idx(tables, pkts, now,
                                                shard=shard, tnt=tnt,
                                                impl=impl, sym=sym, kt=kt)
    hits = found & alive
    return hits, hit_idx, (hits == alive).all()


def session_hit_age(tables, hit_idx, mask, now, shard=None) -> torch.Tensor:
    """Ticks since the matched session's last hit (int32 [P]; 0 where
    ``mask`` is False). Read before ``session_touch``. ``hit_idx`` is the
    global flat slot in both modes: with ``shard`` its gather is the
    owning shard's (module doc)."""
    n = tables.sess_time.numel()
    t = tables.sess_time.reshape(-1)[torch.clamp(hit_idx, 0, n - 1).long()]
    return torch.where(mask, _age(now, t), 0).to(torch.int32)


def session_touch(tables, hit_idx, mask, now, shard=None):
    """Refresh sess_time of matched sessions (in place); with ``shard``
    each write lands in the owning shard's block at its global slot."""
    _scatter_set(tables.sess_time.view(-1), hit_idx, mask, now)
    return tables


# --- insert: one sort-based election round -----------------------------


def _bucket_reps(h: torch.Tensor, pending: torch.Tensor,
                 ways: int) -> torch.Tensor:
    """Per packet, the packet indices of the first ``ways`` pending
    packets of its bucket in packet order — [B, ways] int64, sentinel B
    where the bucket has fewer (the reference's sort election: one
    stable sort of (not-pending, bucket), runs in packet order)."""
    batch = pending.shape[0]
    dev = h.device
    key = ((~pending).to(torch.int64) << 40) | h.to(torch.int64)
    runid, order = torch.sort(key, stable=True)
    pos = torch.arange(batch, device=dev)
    run_start = torch.ones(batch, dtype=torch.bool, device=dev)
    run_start[1:] = runid[1:] != runid[:-1]
    start_pos = torch.cummax(torch.where(run_start, pos, 0), dim=0).values
    rp = start_pos[:, None] + torch.arange(ways, device=dev)[None, :]
    rp_c = torch.clamp(rp, max=batch - 1)
    ok = (rp < batch) & (runid[rp_c] == runid[:, None])
    rep_s = torch.where(ok, order[rp_c], batch)
    out = torch.empty_like(rep_s)
    out[order] = rep_s  # order is a permutation: each row written once
    return out


def hashmap_insert(valid, time, keys, key_vals, extras,
                   extra_vals: Sequence[torch.Tensor], h, want, now,
                   max_age=None) -> tuple:
    """Generic W-way set-associative batch insert, IN PLACE on the
    columns (the reference's ``hashmap_insert`` semantics: idempotent
    refresh, fail-closed payload conflicts, expired/victim reclaim,
    one election round). Returns (inserted, conflict, failed,
    evict_expired, evict_victim) masks [P]."""
    n_buckets, ways = valid.shape
    batch = want.shape[0]
    dev = valid.device
    hl = h.to(torch.int64)
    vw = valid[hl]
    tw = time[hl]
    live = vw == 1
    if max_age is not None:
        live = live & (_age(now, tw) <= max_age)
    key_match = live
    for arr, val in zip(keys, key_vals):
        key_match = key_match & (arr[hl] == val[:, None])
    exists = key_match.any(dim=1)
    exist_way = first_true(key_match)
    pay_same = torch.ones_like(exists)
    for arr, val in zip(extras, extra_vals):
        pay_same = pay_same & (arr[hl, exist_way] == val)
    conflict = want & exists & ~pay_same
    refresh = want & exists & pay_same
    pending = want & ~exists
    inserted = refresh
    # the refresh lands before the election so victim priorities see
    # this batch's refreshes (the reference's ordering)
    _scatter_set(time.view(-1), hl * ways + exist_way, refresh, now)
    tw = time[hl]

    p_idx = torch.arange(batch, device=dev)
    reps = _bucket_reps(h, pending, ways)
    kmat = torch.stack([u32(v) for v in key_vals], dim=1)
    rep_c = torch.clamp(reps, max=batch - 1)
    rk = kmat[rep_c]                                     # [B, W, K]
    ok_rep = reps < batch
    same = ok_rep & (rk == kmat[:, None, :]).all(dim=2)
    found = same.any(dim=1)
    lead_slot = first_true(same)
    leader = torch.gather(rep_c, 1, lead_slot[:, None])[:, 0]
    winner = pending & found & (leader == p_idx)
    follower = pending & found & (leader != p_idx)
    tril = torch.tril(torch.ones(ways, ways, dtype=torch.bool, device=dev),
                      diagonal=-1)
    rep_dup = ((rk[:, :, None, :] == rk[:, None, :, :]).all(dim=3)
               & tril[None] & ok_rep[:, :, None]
               & ok_rep[:, None, :]).any(dim=2)
    rep_new = (ok_rep & ~rep_dup).to(torch.int64)
    distinct_before = torch.cumsum(rep_new, dim=1) - rep_new
    rank = torch.gather(distinct_before, 1, lead_slot[:, None])[:, 0]

    # way priority: free ways first (by way index), then live ways
    # oldest-time first (victims)
    wid = torch.arange(ways, device=dev)
    way_pri = torch.where(live, tw.to(torch.int64),
                          -(1 << 30) + wid[None, :])
    ahead = (way_pri[:, :, None] > way_pri[:, None, :]) | (
        (way_pri[:, :, None] == way_pri[:, None, :])
        & (wid[None, :, None] > wid[None, None, :]))
    pos = ahead.sum(dim=2)
    way = first_true(pos == rank[:, None])
    pri_way = torch.gather(way_pri, 1, way[:, None])[:, 0]
    was_live = pri_way >= 0
    was_valid = torch.gather(vw, 1, way[:, None])[:, 0] == 1
    evict_expired = winner & was_valid & ~was_live
    evict_victim = winner & was_live

    slot = hl * ways + way
    for arr, val in zip(tuple(keys) + tuple(extras),
                        tuple(key_vals) + tuple(extra_vals)):
        _scatter_set(arr.view(-1), slot, winner, val)
    _scatter_set(valid.view(-1), slot, winner, 1)
    _scatter_set(time.view(-1), slot, winner, now)

    if extra_vals:
        emat = torch.stack([u32(v) for v in extra_vals], dim=1)
        f_pay = (emat[leader] == emat).all(dim=1)
    else:
        f_pay = torch.ones_like(follower)
    conflict = conflict | (follower & ~f_pay)
    inserted = inserted | winner | (follower & f_pay)
    failed = pending & ~found
    return inserted, conflict, failed, evict_expired, evict_victim


def session_insert(tables, pkts: PacketVector, want, now, shard=None,
                   tnt: bool = False, sym: bool = False) -> tuple:
    """Insert the forward 5-tuples of ``want`` packets (in place);
    returns (tables, inserted, failed, evict_expired, evict_victim).
    With ``tnt`` the key's bucket lies in its tenant's slice; with
    ``shard`` each shard elects the packets it owns (module doc)."""
    key_vals = (pkts.src_ip, pkts.dst_ip,
                _pack_ports(pkts.sport, pkts.dport), pkts.proto)
    if sym:
        mix = canon_mix(pkts.src_ip, pkts.dst_ip, pkts.sport, pkts.dport,
                        pkts.proto)
    else:
        mix = _hash_mix(*key_vals)
    if tnt:
        h = tenant_bucket(tables, key_vals[0], key_vals[1], mix,
                          tables.tnt_sess_base, tables.tnt_sess_mask)
    else:
        h = _bucket(mix, tables.sess_valid.shape[0])
    insert = (hashmap_insert if shard is None
              else functools.partial(_insert_sharded, shard=shard))
    inserted, _, failed, ev_exp, ev_vic = insert(
        tables.sess_valid, tables.sess_time,
        (tables.sess_src, tables.sess_dst, tables.sess_ports,
         tables.sess_proto),
        key_vals, (), (), h, want, now, max_age=tables.sess_max_age)
    return tables, inserted, failed, ev_exp, ev_vic


# --- aging ---------------------------------------------------------------


def _sweep_one(valid, time, cursor, now, max_age, stride: int,
               shard=None) -> None:
    """Age ONE stride of buckets from ``cursor`` and advance it, in
    place (the cursor stays on the device: no host sync). The start
    clamps to ``n_buckets - s`` as ``lax.dynamic_slice`` clamps it.
    With ``shard`` every shard ages the same local rows of its own
    block (its ring is the block; the cursor is replicated)."""
    if shard is not None:
        valid, time = shard_view(valid, shard), shard_view(time, shard)
    else:
        valid, time = valid[None], time[None]
    n_buckets = valid.shape[1]
    s = min(int(stride), n_buckets)
    start = torch.clamp(cursor.to(torch.int64), 0, n_buckets - s)
    rows = start + torch.arange(s, device=valid.device)
    v = valid[:, rows]
    stale = (v == 1) & (_age(now, time[:, rows]) > max_age)
    valid.index_copy_(1, rows, torch.where(stale, 0, v))
    cursor.copy_((cursor + s) % n_buckets)


def session_sweep(tables, now, stride: int, shard=None):
    """Amortized aging inside the step: clear idle-expired entries in
    one stride of buckets per table (reflective + NAT) and advance the
    sweep cursors. ``stride`` 0 disables."""
    if not stride:
        return tables
    _sweep_one(tables.sess_valid, tables.sess_time,
               tables.sess_sweep_cursor, now, tables.sess_max_age, stride,
               shard)
    _sweep_one(tables.natsess_valid, tables.natsess_time,
               tables.natsess_sweep_cursor, now, tables.sess_max_age,
               stride, shard)
    return tables


def sweep_covered(steps: int, stride: int, tables, bucket_axis: int = 0,
                  passes: int = 1) -> bool:
    """True when ``steps`` steps of ``passes`` pipeline passes, each
    sweeping ``stride`` buckets, have cycled the whole ring of both
    session tables (a cluster steps two passes and stacks its nodes
    ahead of the bucket axis)."""
    if not stride:
        return False
    n = max(tables.sess_valid.shape[bucket_axis],
            tables.natsess_valid.shape[bucket_axis])
    return steps * passes * stride >= n


def session_expire(tables, now, max_age):
    """On-demand bulk reclaim of both session tables. Returns NEW valid
    columns (not in place), like the reference."""
    stale = (tables.sess_valid == 1) & (_age(now, tables.sess_time) > max_age)
    nat_stale = (tables.natsess_valid == 1) & (
        _age(now, tables.natsess_time) > max_age)
    return tables._replace(
        sess_valid=torch.where(stale, 0, tables.sess_valid),
        natsess_valid=torch.where(nat_stale, 0, tables.natsess_valid))
