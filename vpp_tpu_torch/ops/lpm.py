"""Longest-prefix match over per-prefix-length sorted planes.

The PyTorch counterpart of ``vpp_tpu/ops/lpm.py``. The FIB compiles
into one sorted prefix plane per prefix length (``fib_lpm_p{L}``: row
0 the masked prefixes, pad 0xFFFFFFFF; row 1 the owning FIB slot), and
a lookup bisects each populated length's plane, longest first; the
first hit is the longest match. Both rungs resolve the slot through the
one shared ``ops.fib.resolve_fib_slot``.

Host layout helpers (capacities, hint layout, enable gate) are copied
from the reference so the port stages byte-identical planes.

Derived planes. ``build_lpm_stack`` stacks the populated planes into
one ``[L, Npad]`` matrix of sign-biased prefixes (``vector.bias``: the
reference's ``_lpm_bias``) and one of slots, longest length first,
ONCE per table swap (``TableBuilder.to_device``). The reference builds
the same stack inside every traced step; on the GPU that would be L
pad/stack launches per step.

Rungs. ``lpm`` walks the stack with ``lpm_fused_lookup_plain`` (plain
PyTorch, one batched ``torch.searchsorted``); ``pallas`` (the
reference's name for the fused-kernel rung) calls
``lpm_fused_lookup``, which launches csrc/lpm_lookup.cu on CUDA
tensors and takes the plain version on CPU tensors. The kernel stages
the stack's live prefixes in shared memory when they fit
``LPM_SMEM_ENTRIES`` (each length's count rounded up to 4) and searches
them there; it decides that on the device from ``fib_lpm_stk_cnt``, so
the host never reads the counts, and searches device memory otherwise.
The stride hint table (``fib_lpm_hint``) is staged for layout parity,
but neither rung reads it: a hinted bisection and a flat one find the
same prefix when it is present and both miss when it is not, so
``(found, slot)`` are identical.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import torch

from vpp_tpu_torch.ops import _cuda
from vpp_tpu_torch.ops.acl import first_true
from vpp_tpu_torch.pipeline.vector import bias, to_i32, u32

# IPv4 prefix lengths /0 .. /32 — one plane each.
LPM_LENGTHS = 33

_ADDR_MAX = (1 << 32) - 1
LPM_MASKS: Tuple[int, ...] = tuple(
    (_ADDR_MAX ^ ((1 << (32 - L)) - 1)) if L else 0
    for L in range(LPM_LENGTHS)
)

# plane pad value: sorts at/after every real prefix
LPM_PAD = _ADDR_MAX
# its biased form (int32 max)
_PAD_BIASED = 0x7FFFFFFF

# shared memory of one lpm_fused_lookup block, in stacked prefix
# entries (64 KB): a live set up to this size is searched there
LPM_SMEM_ENTRIES = 16384

# stride-hint layout constants (vpp_tpu/ops/lpm.py)
LPM_HINT_BITS = 16
LPM_HINT_MIN = 8192


def lpm_hint_min() -> int:
    """The hint-engage threshold (``VPPT_LPM_HINT_MIN`` overrides it,
    as in the reference, so both packages stage the same layout)."""
    try:
        return int(os.environ.get("VPPT_LPM_HINT_MIN", LPM_HINT_MIN))
    except ValueError:
        return LPM_HINT_MIN


def lpm_hint_layout(caps, hint_min=None):
    """((b_bits, hint_offset, search_steps) per length, total hint
    rows) — a pure function of the capacity vector."""
    if hint_min is None:
        hint_min = lpm_hint_min()
    rows = []
    off = 0
    for length in range(LPM_LENGTHS):
        cap = caps[length]
        if cap < hint_min or length == 0:
            rows.append((0, -1, 0))
            continue
        b = min(length, LPM_HINT_BITS, max(1, (cap - 1).bit_length()))
        bucket = min(cap, 1 << (length - b))
        rows.append((b, off, (bucket - 1).bit_length()))
        off += (1 << b) + 1
    return tuple(rows), off


def lpm_field(length: int) -> str:
    """DataplaneTables field name of one length's prefix plane."""
    return f"fib_lpm_p{length}"


LPM_FIELDS: Tuple[str, ...] = tuple(lpm_field(L) for L in range(LPM_LENGTHS))


def _raw_len_caps(config) -> Tuple[int, ...]:
    caps = tuple(getattr(config, "fib_lpm_plen_caps", ()) or ())
    if caps:
        caps = tuple(int(c) for c in caps)[:LPM_LENGTHS]
        return caps + (0,) * (LPM_LENGTHS - len(caps))
    return (int(config.fib_slots),) * LPM_LENGTHS


def lpm_plane_bytes(config) -> int:
    """Device bytes of the full LPM structure under this config."""
    caps = _raw_len_caps(config)
    _rows, hint = lpm_hint_layout(caps)
    return sum(2 * 4 * c for c in caps) + 4 * hint + 4 * LPM_LENGTHS


def lpm_enabled_for(config) -> bool:
    """Whether this config allocates the LPM planes (explicit ``lpm``
    or ``pallas`` always; ``auto`` when they fit ``fib_lpm_mem_mb``)."""
    knob = getattr(config, "fib_impl", "auto")
    if knob in ("lpm", "pallas"):
        return True
    if knob != "auto":
        return False
    cap_mb = int(getattr(config, "fib_lpm_mem_mb", 256))
    return lpm_plane_bytes(config) <= cap_mb * (1 << 20)


def lpm_len_caps(config) -> Tuple[int, ...]:
    """Per-length plane capacities [33]; all zero when disabled."""
    if not lpm_enabled_for(config):
        return (0,) * LPM_LENGTHS
    return _raw_len_caps(config)


def populated_lengths(config) -> Tuple[int, ...]:
    """The config-static populated lengths, longest first."""
    caps = lpm_len_caps(config)
    return tuple(L for L in range(LPM_LENGTHS - 1, -1, -1) if caps[L] > 0)


def ecmp_capacity(config) -> Tuple[int, int]:
    """(groups G, ways W) of the ECMP member tables ([1, 1] when off)."""
    g = int(getattr(config, "fib_ecmp_groups", 0))
    if g <= 0:
        return 1, 1
    return g, int(getattr(config, "fib_ecmp_ways", 8))


# --- the derived stack (built once per swap) ---------------------------


def build_lpm_stack(fields: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The derived LPM tensors of one table epoch, from its plane and
    count tensors: ``fib_lpm_lens`` [L] the populated lengths longest
    first, ``fib_lpm_stk_cnt`` [L] their live counts, and the
    ``[L, Npad]`` biased-prefix and slot stacks (pad: int32 max / 0;
    Npad = the widest populated plane)."""
    planes = {L: fields[lpm_field(L)] for L in range(LPM_LENGTHS)}
    dev = planes[0].device
    lens = [L for L in range(LPM_LENGTHS - 1, -1, -1)
            if planes[L].shape[1] > 0]
    npad = max([planes[L].shape[1] for L in lens], default=1)
    pfx = torch.full((len(lens), npad), _PAD_BIASED, dtype=torch.int32,
                     device=dev)
    slot = torch.zeros((len(lens), npad), dtype=torch.int32, device=dev)
    for r, L in enumerate(lens):
        w = planes[L].shape[1]
        pfx[r, :w] = bias(planes[L][0])
        slot[r, :w] = planes[L][1]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    cnt = fields["fib_lpm_cnt"][lens_t.long()].to(torch.int32)
    return {"fib_lpm_lens": lens_t, "fib_lpm_stk_cnt": cnt.contiguous(),
            "fib_lpm_stk_pfx": pfx, "fib_lpm_stk_slot": slot}


def update_lpm_stack(stack: Dict[str, torch.Tensor],
                     fields: Dict[str, torch.Tensor], lengths,
                     counts: bool) -> None:
    """Rewrite in place the rows of ``build_lpm_stack``'s ``stack`` that
    the planes of ``lengths`` feed (their shapes are the config's, so
    the stack keeps its shape), and with ``counts`` the live counts from
    ``fields["fib_lpm_cnt"]``: the incremental form of a FIB upload,
    which re-ships only the planes of the lengths a churn touched."""
    # the row order of build_lpm_stack, from the shapes alone (no read
    # of the device's lens)
    lens = [L for L in range(LPM_LENGTHS - 1, -1, -1)
            if fields[lpm_field(L)].shape[1] > 0]
    for L in lengths:
        plane = fields[lpm_field(L)]
        w = plane.shape[1]
        if w == 0:
            continue
        r = lens.index(L)
        stack["fib_lpm_stk_pfx"][r, :w] = bias(plane[0])
        stack["fib_lpm_stk_slot"][r, :w] = plane[1]
    if counts:
        stack["fib_lpm_stk_cnt"].copy_(
            fields["fib_lpm_cnt"][stack["fib_lpm_lens"].long()])


# --- kernel 3: the fused all-lengths search ------------------------------


def _len_masks(lens: torch.Tensor) -> torch.Tensor:
    """uint32 network mask of each prefix length, as int64 values."""
    ln = lens.to(torch.int64)
    ones = torch.full_like(ln, _ADDR_MAX)
    return torch.where(ln == 0, 0, (ones << (32 - ln)) & _ADDR_MAX)


def lpm_fused_lookup_plain(dst, lens, cnt, pfx, slot):
    """The plain PyTorch version of ``lpm_fused_lookup``: per packet,
    mask + bias ``dst`` for every stacked length, bisect each length's
    live entries (``torch.searchsorted``, left), and keep the first hit
    along the longest-first length axis. Returns (found [P] bool,
    slot [P] int32, 0 on a miss)."""
    p = dst.shape[0]
    if lens.shape[0] == 0:
        return (torch.zeros(p, dtype=torch.bool, device=dst.device),
                torch.zeros(p, dtype=torch.int32, device=dst.device))
    m = bias(to_i32(u32(dst)[None, :] & _len_masks(lens)[:, None]))  # [L,P]
    i = torch.searchsorted(pfx, m.contiguous())                    # [L,P]
    ic = torch.clamp(i, max=pfx.shape[1] - 1)
    hit = (torch.gather(pfx, 1, ic) == m) & (i < cnt[:, None])
    found = hit.any(dim=0)
    lsel = first_true(hit.t())                                     # [P]
    cols = torch.arange(p, device=dst.device)
    s = torch.gather(slot, 1, ic)[lsel, cols]
    return found, torch.where(found, s, 0).to(torch.int32)


def lpm_fused_lookup(dst, lens, cnt, pfx, slot):
    """Fused all-lengths LPM search: the kernel of csrc/lpm_lookup.cu on
    CUDA tensors (the live prefixes staged in shared memory when they
    fit, one thread per packet, early exit at the first hit), the plain
    version on CPU tensors. ``dst`` [P] int32 (uint32 bits),
    ``lens``/``cnt`` [L] int32, ``pfx``/``slot`` [L, Npad] int32 (the
    ``build_lpm_stack`` layout). Returns (found [P] bool, slot [P]
    int32)."""
    if not _cuda.use_kernels(pfx):
        return lpm_fused_lookup_plain(dst, lens, cnt, pfx, slot)
    dev = pfx.device
    n_len, npad = pfx.shape
    p = dst.shape[0]
    _cuda.require(dst, "lpm_fused_lookup.dst", ndim=1, device=dev)
    for name, t in (("lens", lens), ("cnt", cnt)):
        _cuda.require(t, f"lpm_fused_lookup.{name}", ndim=1, device=dev)
        if t.shape[0] != n_len:
            raise ValueError(f"lpm_fused_lookup: {name} has {t.shape[0]} "
                             f"rows, the stack {n_len}")
    for name, t in (("pfx", pfx), ("slot", slot)):
        _cuda.require(t, f"lpm_fused_lookup.{name}", ndim=2, device=dev)
        if tuple(t.shape) != (n_len, npad):
            raise ValueError(f"lpm_fused_lookup: {name} shape mismatch")
    found = torch.empty(p, dtype=torch.bool, device=dev)
    out = torch.empty(p, dtype=torch.int32, device=dev)
    fn = _cuda.library("lpm_lookup").lpm_fused_lookup
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int32] * 4
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(_cuda.ptr(dst), _cuda.ptr(lens), _cuda.ptr(cnt),
             _cuda.ptr(pfx), _cuda.ptr(slot), p, n_len, npad,
             LPM_SMEM_ENTRIES, _cuda.ptr(found), _cuda.ptr(out),
             _cuda.stream())
    _cuda.check(err, "lpm_fused_lookup")
    lpm_fused_lookup.launches += 1
    return found, out


lpm_fused_lookup.launches = 0


def _stack(tables):
    return (tables.fib_lpm_lens, tables.fib_lpm_stk_cnt,
            tables.fib_lpm_stk_pfx, tables.fib_lpm_stk_slot)


def fib_lookup_lpm(tables, pkts):
    """The ``lpm`` rung of the FIB ladder: the plain all-lengths walk,
    resolved through the shared ``resolve_fib_slot``."""
    from vpp_tpu_torch.ops.fib import fib_flow_mix, resolve_fib_slot

    found, slot = lpm_fused_lookup_plain(pkts.dst_ip, *_stack(tables))
    return resolve_fib_slot(tables, slot, found, fib_flow_mix(pkts))


def fib_lookup_lpm_fused(tables, pkts):
    """The fused-kernel rung (``fib_impl: pallas``): ``lpm_fused_lookup``
    over the same stack, resolved through the same resolver."""
    from vpp_tpu_torch.ops.fib import fib_flow_mix, resolve_fib_slot

    found, slot = lpm_fused_lookup(pkts.dst_ip, *_stack(tables))
    return resolve_fib_slot(tables, slot, found, fib_flow_mix(pkts))
