"""Carry staged tables and live state between NumPy and the port.

``tables_from_numpy`` takes the reference data plane's staged arrays as
plain NumPy — ``TableBuilder.host_arrays()`` of the JAX package and/or
``np.asarray`` of every field of its ``DataplaneTables``, session and
NAT columns included — and returns this package's ``DataplaneTables``
on ``device``; ``tables_to_numpy`` is the reverse. The module never
imports the JAX package: the caller hands it arrays, so both packages
can compute on the same state.

The mesh: ``cluster_tables_to_numpy`` reads node-stacked cluster tables
(the port's ``ClusterDataplane.tables``, or the reference's sharded
arrays, which ``np.asarray`` gathers into the same global ``[N, ...]``
layout) field by field, and ``cluster_result_to_numpy`` flattens a
``ClusterStepResult`` of either package into named arrays, so the tests
compare the two packages' clusters key by key.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from vpp_tpu_torch.pipeline.tables import (
    HOST_FIELDS,
    STATE_FIELDS,
    DataplaneConfig,
    DataplaneTables,
    derive,
    numpy_of,
    state_shapes,
    tensor_of,
)


def tables_from_numpy(arrays: Mapping[str, np.ndarray], device,
                      config: Optional[DataplaneConfig] = None
                      ) -> DataplaneTables:
    """The port's tables from NumPy arrays keyed by field name. Every
    staged field must be present; a missing state field (session / NAT
    columns, sweep cursors, placeholder planes) is zero-filled at the
    geometry of ``config`` — without a config it is an error."""
    missing = [f for f in HOST_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"staged fields missing: {missing}")
    absent = [f for f in STATE_FIELDS if f not in arrays]
    if absent and config is None:
        raise KeyError(f"state fields missing and no config to size "
                       f"them: {absent}")
    shapes = state_shapes(config) if absent else {}
    out = {f: tensor_of(arrays[f], device) for f in HOST_FIELDS}
    for f, dt in STATE_FIELDS.items():
        a = arrays[f] if f in arrays else np.zeros(shapes[f], dt)
        out[f] = tensor_of(a, device)
    return DataplaneTables(**out, **derive(out))


def tables_to_numpy(tables: DataplaneTables) -> Dict[str, np.ndarray]:
    """Every staged and state field as NumPy in the reference's dtype
    (uint32 fields as uint32); the derived tensors are left out."""
    return {f: numpy_of(f, getattr(tables, f))
            for f in tuple(HOST_FIELDS) + tuple(STATE_FIELDS)}


def _bits(a) -> np.ndarray:
    """An array of either package as NumPy, a copy (a CPU tensor's numpy
    view would follow the live table, which later steps write in
    place): a tensor through the host, a reference array through
    ``np.asarray``; 32-bit words as int32 bits (the reference's uint32
    columns and the port's int32 ones then compare equal)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    a = np.array(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def cluster_tables_to_numpy(tables, fields: Optional[Sequence[str]] = None
                            ) -> Dict[str, np.ndarray]:
    """Every staged and state field (or ``fields``) of node-stacked
    cluster tables, port or reference, as ``[N, ...]`` NumPy in the
    global layout with 32-bit words as int32 bits; the port's derived
    fields are left out."""
    names = fields if fields is not None else (
        tuple(HOST_FIELDS) + tuple(STATE_FIELDS))
    return {f: _bits(getattr(tables, f)) for f in names}


def cluster_result_to_numpy(result) -> Dict[str, np.ndarray]:
    """A ``ClusterStepResult`` of either package (its tables left out) as
    ``{"local.pkts.src_ip": [N, P], "local.disp": ..., "delivered...",
    "stats.rx": [N], ..., "fabric_sent": [N], ...}``."""
    out = {}
    for side in ("local", "delivered"):
        tx = getattr(result, side)
        for f in tx.pkts._fields:
            out[f"{side}.pkts.{f}"] = _bits(getattr(tx.pkts, f))
        for f in tx._fields[1:]:
            out[f"{side}.{f}"] = _bits(getattr(tx, f))
    for f in result.stats._fields:
        out[f"stats.{f}"] = _bits(getattr(result.stats, f))
    for f in ("fabric_overflow", "fabric_sent", "fastpath_pass1"):
        out[f] = _bits(getattr(result, f))
    return out
