"""The three implementation ladders (classifier, FIB, session probe).

Copied from ``vpp_tpu/parallel/partition.py`` (``select_impl``,
``select_fib_impl``, ``select_session_impl``) with the knob values
kept — ``pallas`` stays the name of the fused-kernel rung, so one
config means the same thing in both packages. In this package
``pallas_ok`` means "the tables live on a CUDA device" (the kernels of
csrc/ serve only there).

The reference also gates its session kernel on a TPU VMEM budget
(``session_pallas_fits``: the whole session table resident in a core's
fast memory). The Hopper kernel gathers each packet's bucket straight
from device memory, so the table size bounds nothing and there is no
such gate here.
"""

from __future__ import annotations


def select_impl(knob: str, bv_ok: bool, mxu_ok: bool, nrules: int,
                bv_min_rules: int, mxu_threshold: int,
                pallas_ok: bool = False) -> str:
    """The classifier ladder: explicit knobs honored when compilable;
    ``auto`` ladders pallas >= BV >= bv_min_rules > MXU >=
    mxu_threshold > dense. The pallas rung rides the BV planes."""
    if knob == "dense":
        return "dense"
    if knob == "mxu":
        return "mxu" if mxu_ok else "dense"
    if knob in ("pallas", "bv"):
        if bv_ok:
            return "pallas" if (knob == "pallas" and pallas_ok) else "bv"
        return "mxu" if mxu_ok and nrules >= mxu_threshold else "dense"
    if bv_ok and nrules >= bv_min_rules:
        return "pallas" if pallas_ok else "bv"
    if mxu_ok and nrules >= mxu_threshold:
        return "mxu"
    return "dense"


def select_fib_impl(knob: str, lpm_ok: bool, n_routes: int,
                    min_routes: int, pallas_ok: bool = False) -> str:
    """The FIB ladder: ``lpm``/``pallas`` need eligible planes (else
    dense); ``auto`` engages LPM at ``min_routes`` staged routes."""
    if knob == "dense":
        return "dense"
    if knob == "pallas":
        if lpm_ok:
            return "pallas" if pallas_ok else "lpm"
        return "dense"
    if knob == "lpm":
        return "lpm" if lpm_ok else "dense"
    if lpm_ok and n_routes >= min_routes:
        return "pallas" if pallas_ok else "lpm"
    return "dense"


def select_session_impl(knob: str, pallas_ok: bool) -> str:
    """The session-probe ladder: ``gather`` always compiles;
    ``pallas``/``auto`` take the fused probe kernel when it serves."""
    if knob == "gather":
        return "gather"
    return "pallas" if pallas_ok else "gather"
