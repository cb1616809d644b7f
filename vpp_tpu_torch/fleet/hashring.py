"""Consistent-hash flow steering math for the gateway fleet (ISSUE 18).

The port's copy of ``vpp_tpu/fleet/hashring.py`` (the port never
imports the JAX package). NumPy only, on purpose: everything here runs
on the steering tier's dispatch thread, which never touches the card.

Three layers, bottom-up:

* :func:`canon_mix_np` — the bit-identical NumPy twin of
  ``vpp_tpu_torch.ops.session.canon_mix`` (and of the reference's). With ``dataplane.sess_hash: sym``
  every instance buckets sessions by the direction-canonicalized
  5-tuple mix, so the steering tier can compute a packet's session
  BUCKET from the frame columns alone — without knowing flow direction
  and without a device round-trip. **Keep in sync with ops/session.py:**
  the pact is enforced by differential tests (tests/test_fleet.py on
  the port, tests/test_torch_fleet.py against both packages) that run
  them over random tuples.
* **Hash ranges** — ownership moves between instances in units of
  contiguous bucket ranges (``range_of``: the HIGH bits of the bucket
  index, the same axis the snapshot chunks and shard partitions cut
  on). A range is the migration quantum: rebalancing ships exactly the
  bucket rows whose range moved (pipeline/snapshot.py
  ``drain_bucket_range``), nothing else.
* :func:`assign_ranges` — rendezvous (highest-random-weight) hashing of
  ranges onto members. Chosen over a maglev permutation table for its
  structural disruption bound: a member's score for a range depends
  only on (range, member), so adding a member moves exactly the ranges
  the newcomer wins (~1/N of the total) and removing one moves exactly
  the ranges it owned — no other assignment can change. The bound is
  proven, not hoped for, in tests/test_fleet.py.

Tenant placement (ISSUE 14 composition): a tenant sliced via
``tnt_sess_base/mask`` owns a contiguous bucket window, which
:func:`tenant_ranges` projects onto the range axis. A hot tenant whose
slice spans many ranges is therefore spread across many instances by
construction — the slice geometry IS the placement policy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import zlib

# --- the NumPy twin of ops/session.py's mix -------------------------

_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA77)
_C3 = np.uint32(0xC2B2AE3D)
_C4 = np.uint32(0x27D4EB2F)
_C5 = np.uint32(0x2545F491)


def _hash_mix_np(src: np.ndarray, dst: np.ndarray, ports: np.ndarray,
                 proto: np.ndarray) -> np.ndarray:
    """Bit-identical twin of ``ops.session._hash_mix`` (uint32 in/out;
    NumPy's uint32 products wrap mod 2^32 as the device's do)."""
    h = src * _C1
    h = h ^ dst * _C2
    h = h ^ ports * _C3
    h = h ^ proto.astype(np.uint32) * _C4
    h = h ^ (h >> np.uint32(15))
    h = h * _C5
    h = h ^ (h >> np.uint32(13))
    return h


def canon_mix_np(src, dst, sport, dport, proto) -> np.ndarray:
    """Bit-identical twin of ``ops.session.canon_mix``: the
    direction-invariant 5-tuple mix (endpoints ordered by address,
    hairpin src==dst tie-broken by port). Inputs are broadcastable
    integer arrays; output is uint32."""
    src = np.asarray(src).astype(np.uint32)
    dst = np.asarray(dst).astype(np.uint32)
    sport = np.asarray(sport).astype(np.uint32)
    dport = np.asarray(dport).astype(np.uint32)
    proto = np.asarray(proto).astype(np.uint32)
    swap = (src > dst) | ((src == dst) & (sport > dport))
    a = np.where(swap, dst, src)
    b = np.where(swap, src, dst)
    fwd = (sport << np.uint32(16)) | dport
    rev = (dport << np.uint32(16)) | sport
    ports = np.where(swap, rev, fwd)
    return _hash_mix_np(a, b, ports, proto)


def buckets_of_packed(flat: np.ndarray, n_buckets: int,
                      tenant_ids: Optional[np.ndarray] = None,
                      tnt_base: Optional[np.ndarray] = None,
                      tnt_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-packet session bucket of a packed ``[5, B]`` int32 frame
    (pack_packet_columns layout), as the ``sess_hash: sym`` dataplane
    will compute it. With ``tenant_ids`` + the device slice planes
    (``tnt_sess_base/mask`` in GLOBAL bucket units) the tenant-sliced
    bucket is reproduced: ``base[t] + (mix & mask[t])`` — the NumPy
    form of ``ops.session.tenant_bucket``."""
    u = np.asarray(flat).view(np.uint32)
    src = u[0]
    dst = u[1]
    sport = u[2] >> np.uint32(16)
    dport = u[2] & np.uint32(0xFFFF)
    proto = (u[3] >> np.uint32(8)) & np.uint32(0xFF)
    mix = canon_mix_np(src, dst, sport, dport, proto)
    if tenant_ids is not None:
        t = np.asarray(tenant_ids).astype(np.int64)
        base = np.asarray(tnt_base).astype(np.int64)
        mask = np.asarray(tnt_mask).astype(np.uint32)
        return (base[t]
                + (mix & mask[t]).astype(np.int64)).astype(np.int64)
    return (mix & np.uint32(n_buckets - 1)).astype(np.int64)


# --- hash ranges ----------------------------------------------------


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def buckets_per_range(n_buckets: int, n_ranges: int) -> int:
    if not (_is_pow2(n_buckets) and _is_pow2(n_ranges)
            and n_ranges <= n_buckets):
        raise ValueError(
            f"n_buckets ({n_buckets}) and n_ranges ({n_ranges}) must "
            f"be powers of two with n_ranges <= n_buckets")
    return n_buckets // n_ranges


def range_of(buckets: np.ndarray, n_buckets: int,
             n_ranges: int) -> np.ndarray:
    """Range id of each bucket: the high bits of the bucket index."""
    return np.asarray(buckets) // buckets_per_range(n_buckets, n_ranges)


def range_span(rid: int, n_buckets: int,
               n_ranges: int) -> Tuple[int, int]:
    """``(start_bucket, n)`` of one range — the drain/adopt window."""
    per = buckets_per_range(n_buckets, n_ranges)
    if not 0 <= rid < n_ranges:
        raise ValueError(f"range id {rid} outside 0..{n_ranges - 1}")
    return rid * per, per


# --- rendezvous assignment ------------------------------------------


def member_salt(name: str) -> np.uint32:
    """Stable per-member salt (crc32 of the name — NOT Python's
    randomized ``hash``, which would reshuffle ownership per process)."""
    return np.uint32(zlib.crc32(name.encode("utf-8")) & 0xFFFFFFFF)


def _rv_scores(n_ranges: int, salts: np.ndarray) -> np.ndarray:
    """``[n_ranges, n_members]`` rendezvous score matrix: the same
    mix family, keyed on (range id, member salt)."""
    rids = np.arange(n_ranges, dtype=np.uint32)[:, None]
    salts = np.asarray(salts, np.uint32)[None, :]
    return _hash_mix_np(rids, salts, salts ^ _C1,
                        np.zeros_like(rids))


def assign_ranges(members: Sequence[str],
                  n_ranges: int) -> Dict[int, str]:
    """Rendezvous-assign every range to a member: each range goes to
    the member with the highest (range, member) score. Deterministic
    across processes (salts are content hashes; ties break by sorted
    member name) and disruption-bounded by construction: a member's
    score for a range never depends on WHO ELSE is in the fleet."""
    names = sorted(set(members))
    if not names:
        return {}
    salts = np.array([member_salt(n) for n in names], np.uint32)
    scores = _rv_scores(n_ranges, salts)
    winners = np.argmax(scores, axis=1)  # first max → name-order ties
    return {rid: names[int(w)] for rid, w in enumerate(winners)}


def moved_ranges(old: Dict[int, str],
                 new: Dict[int, str]) -> List[int]:
    """Range ids whose owner differs between two assignments — the
    exact migration work-list of a rebalance."""
    return sorted(r for r in new
                  if old.get(r) is not None and old.get(r) != new[r])


# --- tenant placement -----------------------------------------------


def tenant_ranges(base: int, mask: int, n_buckets: int,
                  n_ranges: int) -> List[int]:
    """Range ids a tenant's bucket slice ``[base, base + mask + 1)``
    intersects (tnt_sess_base/mask units — GLOBAL buckets). The
    steering tier spreads the tenant across these ranges' owners."""
    per = buckets_per_range(n_buckets, n_ranges)
    lo = int(base) // per
    hi = (int(base) + int(mask)) // per
    return list(range(lo, hi + 1))


def tenant_spread(base: int, mask: int, n_buckets: int, n_ranges: int,
                  owners: Dict[int, str]) -> List[str]:
    """Distinct instances serving a tenant's slice, sorted. A hot
    tenant sliced wider than one range lands on multiple instances by
    construction — placement IS the slice geometry."""
    return sorted({owners[r]
                   for r in tenant_ranges(base, mask, n_buckets,
                                          n_ranges)
                   if r in owners})
