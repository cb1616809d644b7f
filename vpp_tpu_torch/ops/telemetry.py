"""Device-resident telemetry plane: the wire-latency histogram, the
count-min flow sketch and its top-K candidate table.

The PyTorch counterpart of ``vpp_tpu/ops/telemetry.py``:

* **wire-latency histogram** — the packed boundary observes
  ``now_us - rx_stamp`` of every valid, stamped packet into a log2
  histogram plane: bucket ``b`` counts latencies in ``[2^b, 2^(b+1))``
  µs (bucket 0 also 0..1 µs, the last saturates). The bucket is a count
  of integer compares against the powers of two, never a float log.
* **heavy-hitter flow sketch** — a count-min sketch (``d`` rows of
  ``w`` counters, the session family's multiplicative-xor hash salted
  per row) and a K-slot candidate table, one challenger elected per
  step. Only the K rows and the bins cross to the host
  (``Dataplane.telemetry_snapshot``); the ``[d, w]`` sketch stays on
  the card.

In place. Like the session ops, the updates write the telemetry planes
of ``tables`` in place (the reference returns new arrays). The
scatter-adds are ``index_add_`` on int32, exact in any order under
duplicate indices; ``torch.argmax`` / ``argmin`` return the first
extremum, the reference's tie order; a 0-d index is taken as a ``[1]``
one, so nothing reads back to the host.

uint32 (pipeline/vector.py): the hashes widen to int64, multiply through
``_mul32`` (no int64 overflow) and shift the non-negative value, so
every ``>>`` is logical as in the reference's uint32 arithmetic.

The ring rider (``pack_tel_rider`` / ``unpack_tel_rider``) packs the
collect-facing planes into the ring window's one result copy
(pipeline/capture.py ``RingProgram``), as the reference's does.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vpp_tpu_torch.ops.session import _mul32
from vpp_tpu_torch.pipeline.vector import to_i32, u32

# telemetry knob values (DataplaneConfig.telemetry)
TEL_MODES = ("off", "latency", "full")

# per-row salts of the sketch hash family (the reference's)
_ROW_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
              0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)


def tel_clock_us() -> int:
    """Monotonic microseconds wrapped to a positive int32: the clock of
    the rx stamps and of the dispatch-time ``now_us``. A wrap makes one
    latency negative, and negative latencies are not observed."""
    return int(time.monotonic() * 1e6) & 0x7FFFFFFF


# --- wire-latency histogram -------------------------------------------


def lat_bucket(lat_us: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Exact log2 bucket of each latency (int32 [P]): how many of the
    thresholds ``2^k`` (k = 1..n_buckets-1) it reaches."""
    # made on the device (a captured step copies nothing from the host)
    k = torch.arange(1, n_buckets, dtype=torch.int32, device=lat_us.device)
    thresholds = torch.ones_like(k) << k
    return (lat_us[:, None] >= thresholds[None, :]).sum(
        dim=1, dtype=torch.int32)


def lat_bucket_np(lat_us: np.ndarray, n_buckets: int) -> np.ndarray:
    """The host-side twin of ``lat_bucket``."""
    thresholds = np.asarray([1 << k for k in range(1, n_buckets)],
                            np.int64)
    return (np.asarray(lat_us, np.int64)[:, None]
            >= thresholds[None, :]).sum(axis=1).astype(np.int32)


def tel_latency_update(tables, observe: torch.Tensor,
                       lat_us: torch.Tensor):
    """Scatter one batch's wire latencies into the histogram (in place).
    ``observe`` [P] masks the packets that count; ``lat_us`` [P] is
    clamped at 0, so a masked lane indexes a real bucket with weight 0.
    Returns ``(tables, n_observed)``."""
    hist = tables.tel_lat_hist
    inc = observe.to(torch.int32)
    hist.index_add_(0, lat_bucket(torch.clamp(lat_us, min=0),
                                  hist.shape[0]), inc)
    return tables, inc.sum(dtype=torch.int32)


# --- heavy-hitter flow sketch ----------------------------------------


def _flow_hash(pkts) -> torch.Tensor:
    """The per-flow hash as its uint32 value in an int64 tensor."""
    h = _mul32(u32(pkts.src_ip), 0x9E3779B1)
    h ^= _mul32(u32(pkts.dst_ip), 0x85EBCA77)
    ports = ((u32(pkts.sport) << 16) | (u32(pkts.dport) & 0xFFFF)) \
        & 0xFFFFFFFF
    h ^= _mul32(ports, 0xC2B2AE3D)
    h ^= _mul32(u32(pkts.proto), 0x27D4EB2F)
    return h ^ (h >> 15)


def tel_flow_hash(pkts) -> torch.Tensor:
    """Base per-flow hash of the post-NAT-reverse header (int32 [P]
    holding the uint32 bits): the session family's multiplicative-xor
    mix. The ML stage's rate-limit gate hashes with the same function
    (csrc/ml_score.cu repeats it)."""
    return to_i32(_flow_hash(pkts))


def tel_flow_hash_np(src, dst, sport, dport, proto) -> np.ndarray:
    """Host twin of ``tel_flow_hash`` (uint32)."""
    u = np.uint32
    with np.errstate(over="ignore"):
        h = np.asarray(src, u) * u(0x9E3779B1)
        h = h ^ (np.asarray(dst, u) * u(0x85EBCA77))
        ports = ((np.asarray(sport, np.uint64).astype(u) << u(16))
                 | (np.asarray(dport, u) & u(0xFFFF)))
        h = h ^ (ports * u(0xC2B2AE3D))
        h = h ^ (np.asarray(proto, u) * u(0x27D4EB2F))
    return h ^ (h >> u(15))


def sketch_cols(h0, row: int, w: int):
    """Column of base hash ``h0`` in sketch row ``row``: an int32
    tensor for a tensor ``h0`` (uint32 bits), an int32 array for a
    NumPy uint32 one."""
    salt = _ROW_SALTS[row % len(_ROW_SALTS)]
    if isinstance(h0, np.ndarray):
        u = np.uint32
        with np.errstate(over="ignore"):
            hr = h0.astype(u) * u(salt)
        hr = hr ^ (hr >> u(13))
        return (hr & u(w - 1)).astype(np.int32)
    hr = _mul32(u32(h0), salt)
    hr = hr ^ (hr >> 13)
    return (hr & (w - 1)).to(torch.int32)


def tel_flow_update(tables, pkts, alive: torch.Tensor):
    """One step's count-min + top-K update (telemetry "full"), in place.

    Sketch: one scatter-add per row; a flow's estimate is the minimum
    over the rows after the update, so it never under-counts. Top-K:
    resident keys refresh to the batch's largest estimate of their key;
    the best non-resident flow of the batch (first argmax) challenges
    the smallest slot (first argmin) and wins iff strictly larger.
    Returns ``(tables, n_sketched)``."""
    sketch = tables.tel_sketch
    d, w = sketch.shape
    k = tables.tel_top_key.shape[0]
    h0 = tel_flow_hash(pkts)
    inc = alive.to(torch.int32)
    cols = [sketch_cols(h0, r, w).long() for r in range(d)]
    for r in range(d):
        sketch[r].index_add_(0, cols[r], inc)
    est = sketch[0][cols[0]]
    for r in range(1, d):
        est = torch.minimum(est, sketch[r][cols[r]])
    est = torch.where(alive, est, 0)

    key, cnt = tables.tel_top_key, tables.tel_top_cnt
    match = ((cnt > 0)[:, None] & alive[None, :]
             & (key[:, None] == h0[None, :]))              # [K, P]
    cnt_new = torch.maximum(
        cnt, torch.where(match, est[None, :], 0).amax(dim=1))
    in_table = match.any(dim=0)
    cand = torch.where(alive & ~in_table, est, -1)
    lead = torch.argmax(cand).view(1)
    lead_est = cand[lead]
    vic = torch.argmin(cnt_new).view(1)
    sel = ((torch.arange(k, device=key.device) == vic)
           & (lead_est > cnt_new[vic]))
    ports = to_i32((u32(pkts.sport[lead]) << 16)
                   | (u32(pkts.dport[lead]) & 0xFFFF))
    key.copy_(torch.where(sel, h0[lead], key))
    for plane, val in ((tables.tel_top_src, pkts.src_ip[lead]),
                       (tables.tel_top_dst, pkts.dst_ip[lead]),
                       (tables.tel_top_ports, ports)):
        plane.copy_(torch.where(sel, val, plane))
    cnt.copy_(torch.where(sel, lead_est, cnt_new))
    n = inc.sum(dtype=torch.int32)
    tables.tel_sketched.add_(n)
    return tables, n


def tel_rider_width(nb: int, k: int) -> int:
    """int32 words of the packed telemetry rider: the histogram bins,
    the sketched-packet scalar, and the 5 top-K candidate planes."""
    return nb + 1 + 5 * k


def _rider_planes(tables):
    return (tables.tel_lat_hist, tables.tel_sketched.reshape(1),
            tables.tel_top_key, tables.tel_top_src, tables.tel_top_dst,
            tables.tel_top_ports, tables.tel_top_cnt)


def pack_tel_rider(tables, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The host-facing telemetry planes as ONE int32 vector that rides
    the ring window's result copy (the reference's ``pack_tel_rider``):
    the bins, the sketched count and the top-K candidates, never the
    ``[d, w]`` sketch. The uint32 planes are int32 tensors holding the
    same bits already (pipeline/vector.py), so the words are theirs.
    ``out``: a ``[tel_rider_width]`` int32 tensor to write into."""
    planes = _rider_planes(tables)
    if out is None:
        return torch.cat(planes)
    return torch.cat(planes, out=out)


def unpack_tel_rider(raw: np.ndarray, nb: int, k: int
                     ) -> Dict[str, np.ndarray]:
    """Host inverse of ``pack_tel_rider`` (geometry from the config:
    tables.tel_capacity)."""
    raw = np.asarray(raw, np.int32)
    if raw.shape[0] != tel_rider_width(nb, k):
        raise ValueError(f"telemetry rider of {raw.shape[0]} words, "
                         f"expected {tel_rider_width(nb, k)}")
    off = nb + 1
    u = np.uint32

    def plane(i):
        return raw[off + i * k: off + (i + 1) * k]

    return {
        "bins": raw[:nb].copy(),
        "sketched": int(raw[nb]),
        "top_key": plane(0).view(u),
        "top_src": plane(1).view(u),
        "top_dst": plane(2).view(u),
        "top_ports": plane(3).view(u),
        "top_cnt": plane(4).copy(),
    }


# --- host-side derivations (collect time; no device work) -------------


def bucket_bounds_seconds(nb: int) -> Tuple[float, ...]:
    """Prometheus ``le`` bounds of the bins, in seconds: bucket b's
    upper bound is 2^(b+1) µs; the saturating last bucket is +Inf."""
    return tuple((1 << (b + 1)) / 1e6 for b in range(nb - 1))


def quantiles_from_bins(bins: np.ndarray,
                        qs=(0.5, 0.99, 0.999)) -> Tuple[float, ...]:
    """Percentiles (µs) from the log2 bins, linearly interpolated inside
    the winning bucket. All-zero bins give 0.0 (no data)."""
    bins = np.asarray(bins, np.int64)
    total = int(bins.sum())
    if total == 0:
        return tuple(0.0 for _ in qs)
    cum = np.cumsum(bins)
    out = []
    for q in qs:
        rank = q * total
        b = int(np.searchsorted(cum, rank, side="left"))
        b = min(b, len(bins) - 1)
        lo = float(1 << b) if b else 0.0
        hi = float(1 << (b + 1))
        prev = int(cum[b - 1]) if b else 0
        frac = (rank - prev) / max(int(bins[b]), 1)
        out.append(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
    return tuple(out)


def approx_sum_us(bins: np.ndarray) -> float:
    """Lower-bound latency sum for a histogram's ``_sum``: each bucket
    contributes its lower bound, 2^b µs, and bucket 0 nothing."""
    bins = np.asarray(bins, np.int64)
    reps = np.asarray([(1 << b) if b else 0 for b in range(len(bins))],
                      np.int64)
    return float((bins * reps).sum())
