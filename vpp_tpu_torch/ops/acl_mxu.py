"""MXU bit-plane ACL classify: 5-tuple first match as an int8 matrix product.

The PyTorch counterpart of ``vpp_tpu/ops/acl_mxu.py``. For one header
bit ``b`` and a rule with mask bit ``m`` and value bit ``v`` the
masked-equality mismatch ``m * (b XOR v)`` linearises to
``b * m(1-2v) + m*v``; summed over the 104 header bit-planes (src 32,
dst 32, proto 8, sport 16, dport 16, zero-padded to 128):

    mismatches(p, r) = bits[p, :] @ coeff[:, r] + k[r]

with ``coeff`` in {-1, 0, 1} and ``k[r] = sum(m*v)``. A rule matches iff
its mismatch count is exactly 0; first match wins, so the classify is a
min over the matching rule columns (``ENC_MISS`` when none matches).
Sums stay within +-(128 + k), so every product is exact.

Commit time (host, NumPy — copied from the reference): the bit-plane
compile, its incremental update and the fail-closed handling of
range-port rules (``ok=False``: their column can never match).

Device time: ``mxu_first_match`` takes the five header columns and the
operand ``glb_mxu_op`` that ``mxu_operand`` derives once per swap: the
coefficients as rule-major int8 ``[R', 128]`` with ``k`` (0..104) in
the first zero-pad plane (``_K_PLANE``; the kernel sets that plane's
bit to 1 for every packet, so the product is the mismatch count) and
each row's 16-byte chunks in the 128-byte-swizzled order the tensor
cores read. On a CUDA tensor it launches csrc/mxu_first_match.cu, which
explodes the headers into bit-planes in shared memory, multiplies on
the int8 tensor cores and keeps the first matching column, never
writing the ``[P, 128]`` bits or the ``[P, R']`` mismatch matrix. On a
CPU tensor it takes ``mxu_first_match_plain``: ``packet_bit_planes``'s
explode, the operand unpacked (``mxu_operand_rows``) and the chunked
float32 first match ``bitplane_first_match``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from vpp_tpu_torch.ops import _cuda
from vpp_tpu_torch.ops.acl import AclVerdict, assemble_global_verdict
from vpp_tpu_torch.pipeline.vector import PacketVector, u32

# Bit-plane layout: [src 0:32 | dst 32:64 | proto 64:72 | sport 72:88 |
# dport 88:104 | zero-pad 104:128].
PLANES = 128
_SRC0, _DST0, _PROTO0, _SPORT0, _DPORT0 = 0, 32, 64, 72, 88

# Encoded "no rule matched" (any valid index is < R <= 2**20): 27 bits.
ENC_MISS = np.int32(0x7FFFFFF)

# The reference's rule tile: it sets the padded rule count R', and the
# plain version's column chunk.
_RT = 1024


class MxuTable(NamedTuple):
    """Host-compiled bit-plane form of one rule table."""

    coeff: np.ndarray  # [PLANES, R'] float32 in {-1, 0, 1}
    k: np.ndarray      # [R'] float32, per-rule mismatch constant
    act: np.ndarray    # [R'] int32 action per COLUMN (-1 padding)
    ok: bool           # False => table has range rules; use dense path


def mxu_rule_capacity(max_rules: int) -> int:
    """Padded rule count R' for a table of ``max_rules``: a multiple of
    the rule tile above one tile."""
    if max_rules <= _RT:
        return max_rules
    return ((max_rules + _RT - 1) // _RT) * _RT


def empty_bitplanes(max_rules: int) -> MxuTable:
    """The compiled form of an empty table: no plane can ever match."""
    r_cap = mxu_rule_capacity(max_rules)
    return MxuTable(
        coeff=np.zeros((PLANES, r_cap), np.float32),
        k=np.ones(r_cap, np.float32),
        act=np.full(r_cap, -1, np.int32),
        ok=True,
    )


def _compile_columns(packed: dict, n: int):
    """The bit-plane math for ``n`` rule rows (any subset): returns
    (coeff [PLANES, n], k [n], bad [n]). Live-ness comes from
    action != -1, so padding rows compile to never-match columns."""
    coeff = np.zeros((PLANES, n), np.float32)
    k = np.ones(n, np.float32)  # default: never matches
    live = packed["action"] != -1

    def put_field(base: int, nbits: int, value, mask):
        shifts = np.arange(nbits, dtype=np.uint32)[:, None]
        m = ((mask[None, :] >> shifts) & 1).astype(np.float32)
        v = ((value[None, :] >> shifts) & 1).astype(np.float32)
        coeff[base:base + nbits, :] = np.where(
            live[None, :], m * (1.0 - 2.0 * v), 0.0)
        k[:] += np.where(live[None, :], m * v, 0.0).sum(axis=0)

    k[:] = np.where(live, 0.0, 1.0)
    put_field(_SRC0, 32, packed["src_net"].astype(np.uint32),
              packed["src_mask"].astype(np.uint32))
    put_field(_DST0, 32, packed["dst_net"].astype(np.uint32),
              packed["dst_mask"].astype(np.uint32))

    proto = packed["proto"]
    proto_any = proto < 0  # -1 any (padding rows are dead via k=1 anyway)
    put_field(
        _PROTO0, 8,
        np.where(proto_any, 0, proto).astype(np.uint32),
        np.where(proto_any, 0, 0xFF).astype(np.uint32),
    )

    bad_rows = np.zeros(n, bool)
    for base, lo_key, hi_key in (
        (_SPORT0, "sport_lo", "sport_hi"),
        (_DPORT0, "dport_lo", "dport_hi"),
    ):
        lo, hi = packed[lo_key], packed[hi_key]
        exact = lo == hi
        anyp = (lo == 0) & (hi == 65535)
        bad_rows |= live & ~exact & ~anyp
        put_field(
            base, 16,
            np.where(exact, lo, 0).astype(np.uint32),
            np.where(exact, 0xFFFF, 0).astype(np.uint32),
        )
    # Fail closed: a range-port rule can never match in the bit-planes —
    # its coefficient column is zeroed AND k pinned to 1, so a caller
    # that ignores ok=False misses the rule rather than wildcarding its
    # ports.
    coeff[:, :] = np.where(bad_rows[None, :], 0.0, coeff)
    k[:] = np.where(bad_rows, 1.0, k)
    return coeff, k, bad_rows


def compile_bitplanes_full(packed: dict, max_rules: int):
    """Compile ``pack_rules`` output into bit-plane coefficients.
    Returns (MxuTable, bad [R]) — ``bad`` is the per-row non-compilable
    mask the incremental update carries forward."""
    r_cap = mxu_rule_capacity(max_rules)
    n = len(packed["action"])
    cblock, kblock, bad = _compile_columns(packed, n)
    coeff = np.zeros((PLANES, r_cap), np.float32)
    k = np.ones(r_cap, np.float32)
    coeff[:, :n] = cblock
    k[:n] = kblock
    act = np.full(r_cap, -1, np.int32)
    act[:n] = packed["action"]
    return MxuTable(coeff=coeff, k=k, act=act, ok=not bad.any()), bad


def compile_bitplanes(packed: dict, max_rules: int) -> MxuTable:
    return compile_bitplanes_full(packed, max_rules)[0]


def compile_bitplanes_update(packed: dict, max_rules: int,
                             prev: MxuTable, prev_bad: np.ndarray,
                             changed: np.ndarray):
    """Incremental recompile: only the ``changed`` rule columns are
    recomputed, every other column is carried over from ``prev``.
    Returns (MxuTable, bad) exactly as ``compile_bitplanes_full`` would
    from scratch."""
    coeff = prev.coeff.copy()
    k = prev.k.copy()
    act = prev.act.copy()
    bad = prev_bad.copy()
    if len(changed):
        sub = {key: arr[changed] for key, arr in packed.items()}
        cblock, kblock, bsub = _compile_columns(sub, len(changed))
        coeff[:, changed] = cblock
        k[changed] = kblock
        act[changed] = packed["action"][changed]
        bad[changed] = bsub
    return MxuTable(coeff=coeff, k=k, act=act, ok=not bad.any()), bad


# The first zero-pad plane: it carries k in the kernel operand.
_K_PLANE = _DPORT0 + 16


def _swizzle_rows(rows: torch.Tensor, r0: int = 0) -> torch.Tensor:
    """Permute the eight 16-byte chunks of each 128-byte row by
    ``c -> c ^ (r % 8)``, ``r`` the row's index in the whole operand
    (``r0`` that of ``rows[0]``: a block of rows swizzles by its absolute
    rows); its own inverse."""
    r = rows.shape[0]
    dev = rows.device
    chunk = (torch.arange(8, device=dev)[None, :]
             ^ ((torch.arange(r, device=dev)[:, None] + r0) % 8))
    idx = (chunk[:, :, None] * 16
           + torch.arange(16, device=dev)).reshape(r, PLANES)
    return torch.gather(rows, 1, idx)


def mxu_operand(host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The derived kernel operand of the staged float32 ``glb_mxu_coeff``
    [PLANES, R'] and ``glb_mxu_k`` [R']: rule-major int8 [R', PLANES]
    with k in plane ``_K_PLANE`` (exact: coefficients are -1, 0, 1 and
    0 <= k <= 104), rows in the 128-byte-swizzled chunk order. Built
    once per swap."""
    rows = host["glb_mxu_coeff"].t().to(torch.int8, copy=True)
    rows[:, _K_PLANE] = host["glb_mxu_k"].to(torch.int8)
    return {"glb_mxu_op": _swizzle_rows(rows)}


def mxu_operand_block(coeff: torch.Tensor, k: torch.Tensor,
                      lo: int) -> torch.Tensor:
    """Rows ``[lo, lo + w)`` of ``mxu_operand``'s operand from the
    coefficient columns ``coeff`` [PLANES, w] and ``k`` [w] of those
    rules: the block path of an incremental commit rebuilds only these
    rows of ``glb_mxu_op``. ``lo`` need not be a multiple of 8: each row
    swizzles by its absolute index."""
    rows = coeff.t().to(torch.int8, copy=True)
    rows[:, _K_PLANE] = k.to(torch.int8)
    return _swizzle_rows(rows, lo)


def mxu_operand_rows(op: torch.Tensor):
    """The inverse of ``mxu_operand``: (coeff_t [R', PLANES] int8, the
    k plane cleared; k [R'] int32)."""
    rows = _swizzle_rows(op)
    k = rows[:, _K_PLANE].to(torch.int32)
    rows[:, _K_PLANE] = 0
    return rows, k


def header_bit_planes(src_ip, dst_ip, proto, sport, dport) -> torch.Tensor:
    """Explode header columns into the [P, PLANES] bf16 bit matrix."""
    dev = src_ip.device
    cols = []
    for field, nbits in ((src_ip, 32), (dst_ip, 32), (proto, 8),
                         (sport, 16), (dport, 16)):
        shifts = torch.arange(nbits, dtype=torch.int64, device=dev)
        cols.append((u32(field)[:, None] >> shifts[None, :]) & 1)
    p = src_ip.shape[0]
    cols.append(torch.zeros((p, PLANES - _DPORT0 - 16), dtype=torch.int64,
                            device=dev))
    return torch.cat(cols, dim=1).to(torch.bfloat16)


def packet_bit_planes(pkts: PacketVector) -> torch.Tensor:
    """Explode packet headers into the [P, PLANES] bf16 bit matrix."""
    return header_bit_planes(pkts.src_ip, pkts.dst_ip, pkts.proto,
                             pkts.sport, pkts.dport)


def bitplane_first_match(bits: torch.Tensor, coeff_t: torch.Tensor,
                         k: torch.Tensor) -> torch.Tensor:
    """The first match over exploded bits: float32 products, ``+ k``,
    ``where(== 0, col, ENC_MISS)`` and a min, over rule chunks of
    ``_RT`` columns with a running min, so a large table never
    materialises the whole [P, R'] mismatch matrix. ``bits`` [P, PLANES]
    in {0, 1}, ``coeff_t`` [R', PLANES] in {-1, 0, 1}, ``k`` [R']."""
    p, r = bits.shape[0], coeff_t.shape[0]
    dev = bits.device
    enc = torch.full((p,), int(ENC_MISS), dtype=torch.int32, device=dev)
    b = bits.to(torch.float32)
    kf = k.to(torch.float32)
    for c0 in range(0, r, _RT):
        c1 = min(c0 + _RT, r)
        mism = b @ coeff_t[c0:c1].to(torch.float32).t() + kf[c0:c1]
        col = torch.arange(c0, c1, dtype=torch.int32, device=dev)
        cand = torch.where(mism == 0.0, col, int(ENC_MISS)).amin(dim=1)
        enc = torch.minimum(enc, cand.to(torch.int32))
    return enc


# --- kernel 4: the fused explode + first match ---------------------------


def mxu_first_match_plain(src_ip, dst_ip, proto, sport, dport,
                          op: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``mxu_first_match``: the header
    explode, the operand unpacked, the chunked float32 first match."""
    return bitplane_first_match(
        header_bit_planes(src_ip, dst_ip, proto, sport, dport),
        *mxu_operand_rows(op))


def mxu_first_match(src_ip, dst_ip, proto, sport, dport,
                    op: torch.Tensor) -> torch.Tensor:
    """Encoded first match of each packet over the bit-plane table:
    the header columns [P] int32 (uint32 bits) and the ``mxu_operand``
    ``op`` [R', PLANES] int8 -> enc [P] int32, the lowest matching rule
    column or ``ENC_MISS``. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    cols = (src_ip, dst_ip, proto, sport, dport)
    if not _cuda.use_kernels(op):
        return mxu_first_match_plain(*cols, op)
    dev = op.device
    _cuda.require(op, "mxu_first_match.op", dtype=torch.int8, ndim=2)
    p, r = src_ip.shape[0], op.shape[0]
    for name, t in zip(("src_ip", "dst_ip", "proto", "sport", "dport"),
                       cols):
        _cuda.require(t, f"mxu_first_match.{name}", ndim=1, device=dev)
        if t.shape[0] != p:
            raise ValueError(f"mxu_first_match: {name} has {t.shape[0]} "
                             f"packets, src_ip {p}")
    if op.shape[1] != PLANES:
        raise ValueError(f"mxu_first_match: {op.shape[1]} planes, "
                         f"expected {PLANES}")
    if op.data_ptr() % 16:
        raise ValueError("mxu_first_match.op: not 16-byte aligned")
    # the kernel lowers each packet's entry with atomicMin
    enc = torch.full((p,), int(ENC_MISS), dtype=torch.int32, device=dev)
    fn = _cuda.library("mxu_first_match").mxu_first_match
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int32] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = fn(*(_cuda.ptr(t) for t in cols), _cuda.ptr(op), p, r,
             _cuda.ptr(enc), _cuda.stream())
    _cuda.check(err, "mxu_first_match")
    mxu_first_match.launches += 1
    return enc


mxu_first_match.launches = 0


def mxu_classify_columns(tables, pkts: PacketVector) -> torch.Tensor:
    """First-match COLUMN index of each packet against the bit-plane
    table (``ENC_MISS`` = no match): ``mxu_first_match`` on the header
    columns and the derived operand."""
    return mxu_first_match(pkts.src_ip, pkts.dst_ip, pkts.proto,
                           pkts.sport, pkts.dport, tables.glb_mxu_op)


def acl_classify_global_mxu(tables, pkts: PacketVector) -> AclVerdict:
    """The ``mxu`` rung, global table; the action is looked up in row
    space (``glb_action``) as the reference does."""
    enc = mxu_classify_columns(tables, pkts)
    matched = enc != int(ENC_MISS)
    act = tables.glb_action[torch.where(matched, enc, 0).long()]
    return assemble_global_verdict(tables, pkts, matched, act == 1, enc)
