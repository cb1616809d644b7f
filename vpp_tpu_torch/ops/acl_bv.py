"""Bit-vector (BV) ACL classify: interval bitmaps + word-AND first match.

The PyTorch counterpart of ``vpp_tpu/ops/acl_bv.py``. Commit time (host,
numpy — copied from the reference): every rule constrains each header
dimension to an interval, the distinct interval boundaries split each
dimension into at most 2R+1 segments, and every segment carries the
bitmap of rules covering it (``ceil(R/32)`` uint32 words); protocol gets
a direct [256, W] plane. Device time, per packet: 4 sorted searches for
the segment rows, the row AND and the first set bit — ``bv_first_set``,
one CUDA kernel on the card (csrc/bv_first_set.cu) that takes the header
columns and the table (for a local classify also ``rx_if`` and
``if_local_table``), with its plain PyTorch version
``bv_search_first_set_plain`` beside it (``torch.searchsorted``, then
``bv_first_set_plain``, the reference kernel's row-AND step).

Rungs: ``bv`` runs the plain version everywhere; ``pallas`` (the
reference's name for the fused-kernel rung, kept so one config means
the same in both packages) calls ``bv_first_set``, which launches the
kernel for CUDA tensors and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vpp_tpu_torch.ops import _cuda
from vpp_tpu_torch.ops.acl import (
    AclVerdict,
    acl_unmatched_default,
    assemble_global_verdict,
)
from vpp_tpu_torch.pipeline.vector import PacketVector, gather_index, u32

# Direct-table rows of the protocol plane (8-bit IANA proto space).
PROTO_ROWS = 256

# Interval dimensions in (name, boundary dtype, max value) order; the
# proto plane is direct-indexed and handled separately.
_ADDR_MAX = (1 << 32) - 1
_PORT_MAX = 65535
DIMS: Tuple[str, ...] = ("src", "dst", "sport", "dport")
_DIM_MAX = {"src": _ADDR_MAX, "dst": _ADDR_MAX,
            "sport": _PORT_MAX, "dport": _PORT_MAX}
# boundary-array pad values (>= every real value, so searchsorted of a
# real value never lands past the live prefix before the clip)
_DIM_PAD = {"src": _ADDR_MAX, "dst": _ADDR_MAX,
            "sport": 0x7FFFFFFF, "dport": 0x7FFFFFFF}
_DIM_DTYPE = {"src": np.uint32, "dst": np.uint32,
              "sport": np.int32, "dport": np.int32}


def bv_capacity(max_rules: int, enabled: bool = True) -> Tuple[int, int, int]:
    """(interval rows, bitmap words, proto rows) for a table of
    ``max_rules``. Shapes are compile-time (epoch-invariant), so a
    disabled classifier collapses to minimal placeholder shapes — the
    BV kernels are then never selected, only the pytree fields exist."""
    if not enabled:
        return 2, 1, 2
    return 2 * max_rules + 2, max(1, (max_rules + 31) // 32), PROTO_ROWS


def bv_global_bytes(max_rules: int) -> int:
    """Device bytes of one fully-enabled BV structure: 4 interval
    bitmap matrices + the proto plane + the boundary/count arrays —
    the memory formula ``classifier: auto``'s cap gates on."""
    ib, w, pr = bv_capacity(max_rules, True)
    return ib * w * 4 * 4 + pr * w * 4 + ib * 4 * 4 + 4 * 4


def bv_enabled_for(config) -> bool:
    """Whether this config allocates (and commit-time builds) the BV
    structure: explicit ``classifier: bv`` always (``pallas`` rides
    the SAME planes); ``auto`` only when the worst-case
    structure fits the ``classifier_bv_mem_mb`` cap."""
    knob = getattr(config, "classifier", "auto")
    if knob in ("bv", "pallas"):
        return True
    if knob != "auto":
        return False
    cap_mb = int(getattr(config, "classifier_bv_mem_mb", 256))
    return bv_global_bytes(config.max_global_rules) <= cap_mb * (1 << 20)


class BvTable(NamedTuple):
    """Host-compiled interval-bitmap form of one rule table."""

    bnd_src: np.ndarray    # uint32 [I] segment start points (pad: max)
    bnd_dst: np.ndarray    # uint32 [I]
    bnd_sport: np.ndarray  # int32 [I]
    bnd_dport: np.ndarray  # int32 [I]
    nbnd: np.ndarray       # int32 [4] live boundary count per dimension
    bm_src: np.ndarray     # uint32 [I, W] segment -> rule bitmap
    bm_dst: np.ndarray     # uint32 [I, W]
    bm_sport: np.ndarray   # uint32 [I, W]
    bm_dport: np.ndarray   # uint32 [I, W]
    bm_proto: np.ndarray   # uint32 [PR, W] direct proto plane
    ok: bool               # False => a live rule has a non-prefix mask
    #                        (inexpressible as one interval); use the
    #                        dense path. Like MXU's ok=False, the bad
    #                        rule is excluded from the bitmaps, so a
    #                        caller that ignores ok misses the rule
    #                        rather than mismatching.
    build_ms: float        # host build cost of the LAST compile (only
    #                        the rebuilt dimension planes are paid)


def empty_bv(max_rules: int, enabled: bool = True) -> BvTable:
    """The compiled form of an empty table: one all-covering segment
    per dimension with no rule bit set — nothing ever matches."""
    ib, w, pr = bv_capacity(max_rules, enabled)
    out = {}
    for dim in DIMS:
        bnd = np.full(ib, _DIM_PAD[dim], _DIM_DTYPE[dim])
        bnd[0] = 0
        out[f"bnd_{dim}"] = bnd
        out[f"bm_{dim}"] = np.zeros((ib, w), np.uint32)
    return BvTable(
        nbnd=np.ones(4, np.int32),
        bm_proto=np.zeros((pr, w), np.uint32),
        ok=True, build_ms=0.0, **out,
    )


def _dim_columns(packed: Dict[str, np.ndarray], dim: str):
    """Per-rule (lo, hi, use, bad) interval columns of one dimension.

    ``use`` marks rules contributing an interval (live, non-empty);
    ``bad`` marks live rules whose constraint is NOT one interval (a
    non-prefix address mask) — they poison ``ok`` and are excluded.
    A pre-masked net with bits outside the mask can never match in the
    dense kernel either, so it is an EMPTY interval, not a bad one."""
    live = packed["action"] != -1
    if dim in ("src", "dst"):
        net = packed[f"{dim}_net"].astype(np.int64)
        mask = packed[f"{dim}_mask"].astype(np.int64)
        inv = (~mask) & _ADDR_MAX
        prefix_ok = ((inv + 1) & inv) == 0
        aligned = (net & mask) == net
        lo = net
        hi = net | inv
        bad = live & ~prefix_ok
        use = live & prefix_ok & aligned
    else:
        lo = np.clip(packed[f"{dim}_lo"].astype(np.int64), 0, _PORT_MAX)
        hi = np.clip(packed[f"{dim}_hi"].astype(np.int64), -1, _PORT_MAX)
        bad = np.zeros(len(lo), bool)
        use = live & (lo <= hi)
    return lo, hi, use, bad


def _build_plane(lo: np.ndarray, hi: np.ndarray, use: np.ndarray,
                 dim: str, cap_i: int, cap_w: int):
    """One dimension's (boundaries, live count, [I, W] bitmap)."""
    vmax = _DIM_MAX[dim]
    pts = np.concatenate([np.asarray([0], np.int64), lo[use], hi[use] + 1])
    pts = np.unique(pts[(pts >= 0) & (pts <= vmax)])
    n = len(pts)
    bnd = np.full(cap_i, _DIM_PAD[dim], _DIM_DTYPE[dim])
    bnd[:n] = pts.astype(bnd.dtype)
    bm = np.zeros((cap_i, cap_w), np.uint32)
    if use.any():
        # rule r covers segment rows [j0, j1): its interval contains
        # every boundary point in [lo, hi]
        j0 = np.searchsorted(pts, lo, side="left")
        j1 = np.searchsorted(pts, hi, side="right")
        nrules = len(lo)
        rows = np.arange(n)[:, None]
        for w in range(cap_w):
            r0, r1 = w * 32, min((w + 1) * 32, nrules)
            if r0 >= nrules or not use[r0:r1].any():
                continue
            cover = (use[None, r0:r1]
                     & (rows >= j0[None, r0:r1])
                     & (rows < j1[None, r0:r1]))
            bits = np.uint32(1) << np.arange(r1 - r0, dtype=np.uint32)
            bm[:n, w] = np.bitwise_or.reduce(
                np.where(cover, bits[None, :], np.uint32(0)), axis=1
            )
    return bnd, n, bm


def _build_proto_plane(proto: np.ndarray, live: np.ndarray,
                       cap_pr: int, cap_w: int) -> np.ndarray:
    """Direct [PR, W] proto plane with wildcard (-1) rules folded into
    every row. Padding rows (proto -2, action -1) set no bit."""
    bm = np.zeros((cap_pr, cap_w), np.uint32)
    nrules = len(proto)
    rows = np.arange(cap_pr)[:, None]
    for w in range(cap_w):
        r0, r1 = w * 32, min((w + 1) * 32, nrules)
        if r0 >= nrules or not live[r0:r1].any():
            continue
        p = proto[r0:r1].astype(np.int64)
        cover = live[None, r0:r1] & ((p[None, :] == -1) | (rows == p[None, :]))
        bits = np.uint32(1) << np.arange(r1 - r0, dtype=np.uint32)
        bm[:, w] = np.bitwise_or.reduce(
            np.where(cover, bits[None, :], np.uint32(0)), axis=1
        )
    return bm


def compile_bv(
    packed: Dict[str, np.ndarray],
    max_rules: int,
    prev: Optional[BvTable] = None,
    prev_cols: Optional[dict] = None,
) -> Tuple[BvTable, dict, Tuple[str, ...]]:
    """Compile pack_rules() output into the interval-bitmap structure.

    Incremental per DIMENSION plane: ``prev_cols`` caches every rule's
    interval columns from the last compile, so a commit that only
    churns ports (the gen-policy shape) rebuilds the sport/dport
    planes and carries src/dst/proto over untouched — composing with
    the identity-diff pack, which already made producing ``packed``
    cheap. A single boundary can shift every segment row, so a touched
    dimension rebuilds from scratch; untouched dimensions are free.

    Returns ``(table, cols, rebuilt)``: ``cols`` is the cache for the
    next call, ``rebuilt`` the dimension names recompiled this time
    (tests + ``show acl`` observability).
    """
    t0 = time.perf_counter()
    cap_i, cap_w, cap_pr = bv_capacity(max_rules, True)
    cols: dict = {}
    rebuilt = []
    out: dict = {}
    nbnd = np.ones(4, np.int32)
    bad_any = False
    for k, dim in enumerate(DIMS):
        lo, hi, use, bad = _dim_columns(packed, dim)
        bad_any = bad_any or bool(bad.any())
        cols[dim] = (lo, hi, use)
        reuse = (
            prev is not None and prev_cols is not None and dim in prev_cols
            and all(np.array_equal(a, b)
                    for a, b in zip(prev_cols[dim], cols[dim]))
        )
        if reuse:
            out[f"bnd_{dim}"] = getattr(prev, f"bnd_{dim}")
            out[f"bm_{dim}"] = getattr(prev, f"bm_{dim}")
            nbnd[k] = prev.nbnd[k]
        else:
            bnd, n, bm = _build_plane(lo, hi, use, dim, cap_i, cap_w)
            out[f"bnd_{dim}"] = bnd
            out[f"bm_{dim}"] = bm
            nbnd[k] = n
            rebuilt.append(dim)
    live = packed["action"] != -1
    cols["proto"] = (packed["proto"].copy(), live)
    if (prev is not None and prev_cols is not None and "proto" in prev_cols
            and all(np.array_equal(a, b)
                    for a, b in zip(prev_cols["proto"], cols["proto"]))):
        bm_proto = prev.bm_proto
    else:
        bm_proto = _build_proto_plane(packed["proto"], live, cap_pr, cap_w)
        rebuilt.append("proto")
    table = BvTable(
        nbnd=nbnd, bm_proto=bm_proto, ok=not bad_any,
        build_ms=(time.perf_counter() - t0) * 1e3, **out,
    )
    return table, cols, tuple(rebuilt)



# --- device side --------------------------------------------------------

# Encoded "no rule matched" of the fused first-set (every rule index is
# < 32 * W <= 2**20 at the supported table sizes).
BV_ENC_MISS = 0x7FFFFFF

# 2^k mod 37 is distinct for k in 0..31: a bit index from an isolated
# power of two without a popcount instruction.
_MOD37_BIT = np.full(37, -1, np.int64)
for _k in range(32):
    _MOD37_BIT[(1 << _k) % 37] = _k


def _segment_of(bnd: torch.Tensor, vals: torch.Tensor, n,
                unsigned: bool) -> torch.Tensor:
    """Segment row of each value: the boundary at-or-below it, clipped
    to the live count ``n``. ``bnd`` is [I] (one table) or [P, I] (each
    packet's own table rows); address dimensions compare unsigned."""
    if unsigned:
        bnd, vals = u32(bnd), u32(vals)
    else:
        bnd, vals = bnd.to(torch.int64), vals.to(torch.int64)
    if bnd.dim() == 1:
        i = torch.searchsorted(bnd, vals, right=True)
    else:
        i = torch.searchsorted(bnd.contiguous(), vals[:, None],
                               right=True)[:, 0]
    i = torch.clamp(i - 1, min=0)
    return torch.minimum(i, n.to(torch.int64) - 1).to(torch.int32)


_LUTS: Dict[torch.device, torch.Tensor] = {}


def _mod37_lut(device: torch.device) -> torch.Tensor:
    """The mod-37 bit-index table on ``device``, uploaded once (a copy
    from the host inside a step would break its CUDA-graph capture:
    the mesh captures this plain version on the card)."""
    lut = _LUTS.get(device)
    if lut is None:
        lut = _LUTS[device] = torch.as_tensor(_MOD37_BIT, device=device)
    return lut


def bv_first_set_plain(bm_src, bm_dst, bm_sport, bm_dport, bm_proto,
                       row_src, row_dst, row_sport, row_dport, row_proto,
                       table=None) -> torch.Tensor:
    """The plain PyTorch version of ``bv_first_set``: gather the five
    rows, AND them, and encode the lowest surviving bit
    (word * 32 + bit), ``BV_ENC_MISS`` when none survives."""
    if bm_src.dim() == 2:
        words = (bm_src[row_src.long()] & bm_dst[row_dst.long()]
                 & bm_sport[row_sport.long()] & bm_dport[row_dport.long()]
                 & bm_proto[row_proto.long()])
    else:
        t = (torch.zeros_like(row_src) if table is None else table).long()
        words = (bm_src[t, row_src.long()] & bm_dst[t, row_dst.long()]
                 & bm_sport[t, row_sport.long()]
                 & bm_dport[t, row_dport.long()]
                 & bm_proto[t, row_proto.long()])
    w = u32(words)
    low = w & (-w)                       # isolated lowest set bit
    bit = _mod37_lut(w.device)[low % 37]
    col = torch.arange(w.shape[1], device=w.device, dtype=torch.int64)
    cand = torch.where(w != 0, col[None, :] * 32 + bit, BV_ENC_MISS)
    if cand.shape[1] == 0:
        return torch.full((w.shape[0],), BV_ENC_MISS, dtype=torch.int32,
                          device=w.device)
    return cand.min(dim=1).values.to(torch.int32)


def _global_rows(src_ip, dst_ip, proto, sport, dport, bnd_src, bnd_dst,
                 bnd_sport, bnd_dport, nbnd, n_proto: int):
    """The five row indices of each packet in one table: its segment
    rows (src, dst, sport, dport) and its clamped protocol."""
    si = _segment_of(bnd_src, src_ip, nbnd[0], True)
    di = _segment_of(bnd_dst, dst_ip, nbnd[1], True)
    pi = _segment_of(bnd_sport, sport, nbnd[2], False)
    qi = _segment_of(bnd_dport, dport, nbnd[3], False)
    return si, di, pi, qi, torch.clamp(proto, 0, n_proto - 1)


def _local_rows(src_ip, dst_ip, proto, sport, dport, rx_if, if_local_table,
                bnd_src, bnd_dst, bnd_sport, bnd_dport, nbnd, n_proto: int):
    """(tid [P], table [P], rows): each packet's local table (-1: none;
    the rows then index table 0) and its five row indices there, each
    packet searching its own table's [I] boundary rows."""
    tid = if_local_table[gather_index(rx_if, if_local_table.shape[0])]
    t = torch.clamp(tid, min=0)
    tl = t.long()
    nb = nbnd[tl]  # [P, 4]
    si = _segment_of(bnd_src[tl], src_ip, nb[:, 0], True)
    di = _segment_of(bnd_dst[tl], dst_ip, nb[:, 1], True)
    pi = _segment_of(bnd_sport[tl], sport, nb[:, 2], False)
    qi = _segment_of(bnd_dport[tl], dport, nb[:, 3], False)
    return tid, t, (si, di, pi, qi, torch.clamp(proto, 0, n_proto - 1))


def bv_search_first_set_plain(src_ip, dst_ip, proto, sport, dport, bnd_src,
                              bnd_dst, bnd_sport, bnd_dport, nbnd, bm_src,
                              bm_dst, bm_sport, bm_dport, bm_proto,
                              rx_if=None, if_local_table=None):
    """The plain PyTorch version of ``bv_first_set``: ``_global_rows``
    (or ``_local_rows``) and ``bv_first_set_plain``."""
    hdr = (src_ip, dst_ip, proto, sport, dport)
    bnd = (bnd_src, bnd_dst, bnd_sport, bnd_dport, nbnd)
    planes = (bm_src, bm_dst, bm_sport, bm_dport, bm_proto)
    if if_local_table is None:
        rows = _global_rows(*hdr, *bnd, bm_proto.shape[0])
        return bv_first_set_plain(*planes, *rows)
    tid, t, rows = _local_rows(*hdr, rx_if, if_local_table, *bnd,
                               bm_proto.shape[1])
    return tid, bv_first_set_plain(*planes, *rows, table=t)


# the C entry's argument types (kernels.cuh), the stream last
BV_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int32] * 7 \
    + [ctypes.c_void_p] * 3


def bv_launch_args(src_ip, dst_ip, proto, sport, dport, bnd_src, bnd_dst,
                   bnd_sport, bnd_dport, nbnd, bm_src, bm_dst, bm_sport,
                   bm_dport, bm_proto, rx_if=None, if_local_table=None):
    """The checked arguments of csrc/bv_first_set.cu's C entry but the
    stream, and the outputs (enc, or (tid, enc) for the local form)."""
    hdr = [src_ip, dst_ip, proto, sport, dport]
    bnds = [bnd_src, bnd_dst, bnd_sport, bnd_dport]
    planes = [bm_src, bm_dst, bm_sport, bm_dport, bm_proto]
    local = if_local_table is not None
    if not local:
        bnds = [b[None] for b in bnds]
        planes = [pl[None] for pl in planes]
        nbnd = nbnd[None]
    dev = bm_src.device
    n_tables, n_int, words = planes[0].shape
    n_proto = planes[4].shape[1]
    p = src_ip.shape[0]
    for name, pl in zip(DIMS + ("proto",), planes):
        _cuda.require(pl, f"bv_first_set.bm_{name}", ndim=3, device=dev)
        rows = n_proto if name == "proto" else n_int
        if tuple(pl.shape) != (n_tables, rows, words):
            raise ValueError(f"bv_first_set: plane {name} has shape "
                             f"{tuple(pl.shape)}")
    for name, b in zip(DIMS, bnds):
        _cuda.require(b, f"bv_first_set.bnd_{name}", ndim=2, device=dev)
        if tuple(b.shape) != (n_tables, n_int):
            raise ValueError(f"bv_first_set: bnd_{name} has shape "
                             f"{tuple(b.shape)}")
    _cuda.require(nbnd, "bv_first_set.nbnd", ndim=2, device=dev)
    if tuple(nbnd.shape) != (n_tables, 4):
        raise ValueError(f"bv_first_set: nbnd has shape {tuple(nbnd.shape)}")
    for c in hdr + ([rx_if] if local else []):
        _cuda.require(c, "bv_first_set.header", ndim=1, device=dev)
        if c.shape[0] != p:
            raise ValueError("bv_first_set: header length mismatch")
    if local:
        _cuda.require(if_local_table, "bv_first_set.if_local_table", ndim=1,
                      device=dev)
    vec4 = words % 4 == 0 and all(pl.data_ptr() % 16 == 0 for pl in planes)
    enc = torch.empty(p, dtype=torch.int32, device=dev)
    tid = torch.empty(p, dtype=torch.int32, device=dev) if local else None
    args = (*(_cuda.ptr(x) for x in hdr + bnds + [nbnd] + planes),
            _cuda.ptr(rx_if) if local else None,
            _cuda.ptr(if_local_table) if local else None, p, n_tables, n_int,
            n_proto, words, if_local_table.shape[0] if local else 0,
            int(vec4), _cuda.ptr(enc), _cuda.ptr(tid) if local else None)
    return args, ((tid, enc) if local else enc)


def bv_first_set(src_ip, dst_ip, proto, sport, dport, bnd_src, bnd_dst,
                 bnd_sport, bnd_dport, nbnd, bm_src, bm_dst, bm_sport,
                 bm_dport, bm_proto, rx_if=None, if_local_table=None):
    """The BV first match of a packet vector: the kernel of
    csrc/bv_first_set.cu on CUDA tensors (segment searches, table
    lookup, row AND and first set bit in one launch), the plain version
    on CPU tensors. Header columns [P] int32; one table's boundaries
    [I], live counts ``nbnd`` [4] and planes [I, W] / [PR, W] — or,
    with ``rx_if`` and ``if_local_table``, the per-interface tables'
    [T, I], [T, 4] and [T, I, W] / [T, PR, W]. Returns enc [P] int32
    (rule index, ``BV_ENC_MISS`` on a miss); the local form returns
    (tid [P] int32, enc), ``tid`` = -1 where the interface has no
    table."""
    args = (src_ip, dst_ip, proto, sport, dport, bnd_src, bnd_dst,
            bnd_sport, bnd_dport, nbnd, bm_src, bm_dst, bm_sport, bm_dport,
            bm_proto, rx_if, if_local_table)
    if not _cuda.use_kernels(bm_src):
        return bv_search_first_set_plain(*args)
    c_args, out = bv_launch_args(*args)
    fn = _cuda.library("bv_first_set").bv_first_set
    fn.argtypes = BV_ARGTYPES
    fn.restype = ctypes.c_int
    _cuda.check(fn(*c_args, _cuda.stream()), "bv_first_set")
    bv_first_set.launches += 1
    return out


bv_first_set.launches = 0



def _glb_args(tables):
    """The global table's boundaries, live counts and planes, in the
    order ``bv_first_set`` takes them."""
    return (tables.glb_bv_bnd_src, tables.glb_bv_bnd_dst,
            tables.glb_bv_bnd_sport, tables.glb_bv_bnd_dport,
            tables.glb_bv_nbnd, tables.glb_bv_src, tables.glb_bv_dst,
            tables.glb_bv_sport, tables.glb_bv_dport, tables.glb_bv_proto)


def _acl_args(tables):
    """The per-interface tables' boundaries, counts and planes."""
    return (tables.acl_bv_bnd_src, tables.acl_bv_bnd_dst,
            tables.acl_bv_bnd_sport, tables.acl_bv_bnd_dport,
            tables.acl_bv_nbnd, tables.acl_bv_src, tables.acl_bv_dst,
            tables.acl_bv_sport, tables.acl_bv_dport, tables.acl_bv_proto)


def _global_verdict(tables, pkts, enc) -> AclVerdict:
    matched = enc != BV_ENC_MISS
    rule = torch.where(matched, enc, -1)
    act = tables.glb_action[torch.where(matched, enc, 0).long()]
    return assemble_global_verdict(tables, pkts, matched, act == 1, rule)


def _local_verdict(tables, pkts, tid, enc) -> AclVerdict:
    t = torch.clamp(tid, min=0).long()
    has_table = tid >= 0
    matched = enc != BV_ENC_MISS
    rule = torch.where(matched, enc, -1)
    act = tables.acl_action[t, torch.where(matched, enc, 0).long()]
    permit = torch.where(matched, act == 1,
                         acl_unmatched_default(pkts, tables.acl_nrules[t]))
    return AclVerdict(permit=torch.where(has_table, permit, True),
                      rule_idx=torch.where(has_table & matched, rule, -1)
                      .to(torch.int32))


def bv_first_match(bnd_src, bnd_dst, bnd_sport, bnd_dport, nbnd,
                   bm_src, bm_dst, bm_sport, bm_dport, bm_proto,
                   pkts: PacketVector) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matched [P] bool, rule_idx [P] int32, -1 = miss) over one BV
    table, plain PyTorch throughout."""
    enc = bv_search_first_set_plain(
        *pkts.five_tuple, bnd_src, bnd_dst, bnd_sport, bnd_dport, nbnd,
        bm_src, bm_dst, bm_sport, bm_dport, bm_proto)
    matched = enc != BV_ENC_MISS
    return matched, torch.where(matched, enc, -1)


def acl_classify_global_bv(tables, pkts: PacketVector) -> AclVerdict:
    """The ``bv`` rung, global table (plain PyTorch)."""
    enc = bv_search_first_set_plain(*pkts.five_tuple, *_glb_args(tables))
    return _global_verdict(tables, pkts, enc)


def acl_classify_local_bv(tables, pkts: PacketVector) -> AclVerdict:
    """The ``bv`` rung, per-interface local tables (plain PyTorch)."""
    tid, enc = bv_search_first_set_plain(*pkts.five_tuple, *_acl_args(tables),
                                         pkts.rx_if, tables.if_local_table)
    return _local_verdict(tables, pkts, tid, enc)


def acl_classify_global_pallas(tables, pkts: PacketVector) -> AclVerdict:
    """The fused-kernel rung, global table: ``bv_first_set`` over the
    global table."""
    enc = bv_first_set(*pkts.five_tuple, *_glb_args(tables))
    return _global_verdict(tables, pkts, enc)


def acl_classify_local_pallas(tables, pkts: PacketVector) -> AclVerdict:
    """The fused-kernel rung, local tables: ``bv_first_set`` looks up
    each packet's table from its receiving interface."""
    tid, enc = bv_first_set(*pkts.five_tuple, *_acl_args(tables), pkts.rx_if,
                            tables.if_local_table)
    return _local_verdict(tables, pkts, tid, enc)
