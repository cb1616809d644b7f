"""Carry staged tables and live state between NumPy and the port.

``tables_from_numpy`` takes the reference data plane's staged arrays as
plain NumPy — ``TableBuilder.host_arrays()`` of the JAX package and/or
``np.asarray`` of every field of its ``DataplaneTables``, session and
NAT columns included — and returns this package's ``DataplaneTables``
on ``device``; ``tables_to_numpy`` is the reverse. The module never
imports the JAX package: the caller hands it arrays, so both packages
can compute on the same state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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
