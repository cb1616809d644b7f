"""Device-resident table state + host-side table compiler.

The PyTorch counterpart of ``vpp_tpu/pipeline/tables.py``: the same
``DataplaneConfig`` knobs, the same ``DataplaneTables`` field names and
host layouts (``TableBuilder.host_arrays()`` equals the reference's,
field by field), loaded into torch tensors on the builder's device.
uint32 fields are int32 tensors holding the same bits
(pipeline/vector.py).

The upload is incremental, as the reference's (``_UPLOAD_GROUPS``):
every builder mutator marks the upload group it touches, and
``to_device`` ships only the dirty groups, field by field within the
``glb_bv`` and ``fib`` groups. Where a commit's changes to the global
rule rows, the per-slot FIB rows or the service VIP rows confine to a
block (``_block_of``), that block travels as ONE int32 blob through one
pinned host buffer and one non-blocking host-to-device copy on the
current stream, and slice copies write it into the tensors the live
tables hold (``_glb_incremental``, ``_fib_incremental``,
``_svc_incremental``); the diff base moves only after the device writes
succeeded. With ``into`` (the live tables, ``Dataplane.swap``) every
write lands in the tensors the captured step programs hold, so a swap
captures nothing; without it a dirty field gets a new tensor. The
global table compiles incrementally too: an identity diff of the rule
objects (``pack_rules_incremental``) recompiles only the changed
bit-plane columns and BV dimension planes. Every upload's bytes are
charged to its group (pipeline/transfer.py). ``state_snapshot`` /
``state_restore`` roll the staging back and reset the diff bases.

The ML planes are staged at the configured capacity (``ml_capacity``,
``set_ml_model``), the telemetry planes take their configured shapes
(``tel_capacity``), and the tenant, service-VIP and ECMP planes theirs
(``tnt_capacity``, ``svc_capacity``, ``ecmp_capacity``), as in the
reference: a tenant registry (``set_tenant``) and a service registry
(``set_service``) are compiled into their planes by
``_restage_tenants`` / ``_restage_svc``, with the reference's slice
allocation and sticky weighted way fill.

Derived tensors (``DERIVED_FIELDS``), each following one upload group
(``DERIVED_GROUPS``): the populated LPM planes stacked into the biased
``[L, Npad]`` prefix and slot matrices the fused LPM kernel walks
(``fib_lpm_stk_*`` — the reference rebuilds them inside every traced
step, vpp_tpu/ops/lpm.py ``_fib_lookup_lpm_pallas``; here the rows of
the lengths a FIB upload re-ships are rewritten), and the MXU
coefficients and ``k`` as the rule-major int8 ``[R', 128]`` operand
``mxu_first_match`` reads, laid out as its shared-memory tiles
(``glb_mxu_op``, ops/acl_mxu.py ``mxu_operand`` — the reference casts
float32 to bf16 inside every call, vpp_tpu/ops/acl_mxu.py
``mxu_first_match``; a block commit rebuilds only the block's rows).
"""

from __future__ import annotations

import enum
import ipaddress
import logging
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vpp_tpu_torch.ir.rule import ANY_PORT, ContivRule
from vpp_tpu_torch.ml.model import ML_FEATURES
from vpp_tpu_torch.ops.acl_bv import (
    bv_capacity,
    bv_enabled_for,
    compile_bv,
    empty_bv,
)
from vpp_tpu_torch.ops.acl_mxu import (
    PLANES,
    compile_bitplanes_full,
    compile_bitplanes_update,
    empty_bitplanes,
    mxu_operand,
    mxu_operand_block,
)
from vpp_tpu_torch.ops.lpm import (
    LPM_FIELDS,
    LPM_LENGTHS,
    LPM_PAD,
    build_lpm_stack,
    ecmp_capacity,
    lpm_enabled_for,
    lpm_field,
    lpm_hint_layout,
    lpm_len_caps,
    update_lpm_stack,
)
from vpp_tpu_torch.ops.mlscore import ML_TNT_THRESH_INHERIT
from vpp_tpu_torch.pipeline.transfer import count_device_transfer
from vpp_tpu_torch.pipeline.vector import Disposition, as_i32

log = logging.getLogger("vpp_tpu_torch.tables")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    card. With no card present it raises — the port never quietly runs
    on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vpp_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return torch.device("cuda")


class InterfaceType(enum.IntEnum):
    NONE = 0
    POD = 1      # pod-facing interface
    UPLINK = 2   # node uplink toward other nodes / cluster edge
    HOST = 3     # host-stack interface


class DataplaneConfig(NamedTuple):
    """Static sizing of the device tables — the reference's knobs,
    names and defaults (vpp_tpu/pipeline/tables.py DataplaneConfig)."""

    max_tables: int = 16
    max_rules: int = 128
    max_global_rules: int = 128
    max_ifaces: int = 64
    fib_slots: int = 128
    fib_impl: str = "auto"
    fib_lpm_min_routes: int = 256
    fib_lpm_mem_mb: int = 256
    fib_lpm_plen_caps: tuple = ()
    fib_ecmp_groups: int = 0
    fib_ecmp_ways: int = 8
    sess_slots: int = 4096
    sess_ways: int = 4
    session_impl: str = "auto"
    sess_hash: str = "fwd"
    natsess_slots: int = 0
    sess_sweep_stride: int = 256
    sess_max_age: int = 3000
    nat_mappings: int = 64
    nat_backends: int = 512
    fastpath: bool = True
    fastpath_min_rules: int = 0
    classifier: str = "auto"
    classifier_bv_min_rules: int = 1024
    classifier_bv_mem_mb: int = 256
    ml_stage: str = "off"
    ml_hidden: int = 16
    ml_trees: int = 4
    ml_depth: int = 3
    telemetry: str = "off"
    telemetry_lat_buckets: int = 24
    telemetry_sketch_rows: int = 2
    telemetry_sketch_cols: int = 1024
    telemetry_topk: int = 8
    tenancy: str = "off"
    tenancy_tenants: int = 8
    tenancy_prefixes: int = 64
    overlay: str = "off"
    svc_vips: int = 0
    svc_backend_ways: int = 8


# --- the DataplaneTables field set (reference order) -----------------

_ACL_FIELDS = (
    "acl_src_net", "acl_src_mask", "acl_dst_net", "acl_dst_mask",
    "acl_proto", "acl_sport_lo", "acl_sport_hi", "acl_dport_lo",
    "acl_dport_hi", "acl_action", "acl_nrules",
    "acl_bv_bnd_src", "acl_bv_bnd_dst", "acl_bv_bnd_sport",
    "acl_bv_bnd_dport", "acl_bv_nbnd", "acl_bv_src", "acl_bv_dst",
    "acl_bv_sport", "acl_bv_dport", "acl_bv_proto",
)
_GLB_FIELDS = (
    "glb_src_net", "glb_src_mask", "glb_dst_net", "glb_dst_mask",
    "glb_proto", "glb_sport_lo", "glb_sport_hi", "glb_dport_lo",
    "glb_dport_hi", "glb_action", "glb_nrules",
    "glb_mxu_coeff", "glb_mxu_k", "glb_mxu_act",
    "glb_bv_bnd_src", "glb_bv_bnd_dst", "glb_bv_bnd_sport",
    "glb_bv_bnd_dport", "glb_bv_nbnd", "glb_bv_src", "glb_bv_dst",
    "glb_bv_sport", "glb_bv_dport", "glb_bv_proto",
)
_ML_FIELDS = (
    "glb_ml_w1", "glb_ml_b1", "glb_ml_s1", "glb_ml_w2", "glb_ml_b2",
    "glb_ml_f_feat", "glb_ml_f_thresh", "glb_ml_f_leaf", "glb_ml_thresh",
    "glb_ml_action", "glb_ml_rl_shift", "glb_ml_version",
)
_IF_FIELDS = ("if_type", "if_local_table", "if_apply_global")
_FIB_FIELDS = (
    "fib_prefix", "fib_mask", "fib_plen", "fib_tx_if", "fib_disp",
    "fib_next_hop", "fib_node_id", "fib_snat", "fib_grp",
) + LPM_FIELDS + (
    "fib_lpm_cnt", "fib_lpm_hint",
    "fib_grp_nh", "fib_grp_tx_if", "fib_grp_node", "fib_grp_n",
)
_NAT_FIELDS = (
    "nat_ext_ip", "nat_ext_port", "nat_proto", "nat_boff", "nat_bcnt",
    "nat_total_w", "nat_self_snat", "natb_ip", "natb_port", "natb_cumw",
    "nat_snat_ip",
)
_TNT_FIELDS = (
    "tnt_pfx_net", "tnt_pfx_mask", "tnt_pfx_id", "tnt_rate", "tnt_burst",
    "tnt_sess_base", "tnt_sess_mask", "tnt_nat_base", "tnt_nat_mask",
    "glb_ml_tnt_mode", "glb_ml_tnt_thresh", "tnt_vni",
)
_SVC_FIELDS = (
    "svc_vip_ip", "svc_vip_port", "svc_vip_proto", "svc_vip_snat",
    "svc_bk_n", "svc_bk_ip", "svc_bk_port",
)

# State fields (carried across swaps by reference) with numpy dtypes.
SESSION_FIELDS: Dict[str, type] = {
    "sess_src": np.uint32, "sess_dst": np.uint32, "sess_ports": np.uint32,
    "sess_proto": np.int32, "sess_valid": np.int32, "sess_time": np.int32,
    "natsess_a": np.uint32, "natsess_b": np.uint32,
    "natsess_ports": np.uint32, "natsess_proto": np.int32,
    "natsess_valid": np.int32, "natsess_time": np.int32,
    "natsess_orig_ip": np.uint32, "natsess_orig_port": np.int32,
    "natsess_src_ip": np.uint32, "natsess_sport": np.int32,
    "natsess_kind": np.int32,
    "sess_sweep_cursor": np.int32, "natsess_sweep_cursor": np.int32,
}
TELEMETRY_FIELDS: Dict[str, type] = {
    "tel_lat_hist": np.int32, "tel_sketch": np.int32,
    "tel_sketched": np.int32, "tel_top_key": np.uint32,
    "tel_top_src": np.uint32, "tel_top_dst": np.uint32,
    "tel_top_ports": np.uint32, "tel_top_cnt": np.int32,
}
TENANCY_STATE_FIELDS: Dict[str, type] = {
    f: np.int32 for f in ("tnt_tokens", "tnt_tok_time", "tnt_rx_c",
                          "tnt_tx_c", "tnt_rl_c", "tnt_qf_c")
}
FIB_STATE_FIELDS: Dict[str, type] = {"fib_ecmp_c": np.int32}
STATE_FIELDS: Dict[str, type] = {
    **SESSION_FIELDS, **TELEMETRY_FIELDS, **TENANCY_STATE_FIELDS,
    **FIB_STATE_FIELDS,
}

# The staged (non-state) fields, i.e. TableBuilder.host_arrays() keys.
HOST_FIELDS: Tuple[str, ...] = (
    _ACL_FIELDS + _GLB_FIELDS + _ML_FIELDS + _TNT_FIELDS + _IF_FIELDS
    + _FIB_FIELDS + ("sess_max_age",) + _NAT_FIELDS + ("ovl_vtep_ip",)
    + _SVC_FIELDS
)

# Derived per swap: from the LPM planes (build_lpm_stack) the populated
# lengths longest first, their live counts and the stacked biased
# prefix / slot planes; from the MXU coefficients and k (mxu_operand)
# the kernel's int8 operand, k folded into a pad plane, rows in the
# tensor cores' swizzled chunk order. Not part of the reference's field
# set.
DERIVED_FIELDS: Tuple[str, ...] = (
    "fib_lpm_lens", "fib_lpm_stk_cnt", "fib_lpm_stk_pfx",
    "fib_lpm_stk_slot", "glb_mxu_op",
)

TABLE_FIELDS: Tuple[str, ...] = (HOST_FIELDS + tuple(STATE_FIELDS)
                                 + DERIVED_FIELDS)

# the upload group each derived field follows: it is rebuilt (wholly,
# or the rows of a block commit) only when that group ships
DERIVED_GROUPS: Dict[str, str] = {
    "fib_lpm_lens": "fib", "fib_lpm_stk_cnt": "fib",
    "fib_lpm_stk_pfx": "fib", "fib_lpm_stk_slot": "fib",
    "glb_mxu_op": "glb",
}


def derive(host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every DERIVED_FIELDS tensor, from the staged tensors ``host``."""
    return {**build_lpm_stack(host), **mxu_operand(host)}

DataplaneTables = NamedTuple(
    "DataplaneTables", [(f, torch.Tensor) for f in TABLE_FIELDS])
DataplaneTables.__doc__ = (
    "The device table pytree: one tensor per reference field (uint32 "
    "as int32 bits) plus the derived LPM stack and MXU operand (module "
    "doc).")

# numpy dtype of every non-derived field (the reference's staging
# dtypes): uint32, int8 and float32 fields named, int32 otherwise.
_U32_FIELDS = frozenset(
    ("acl_src_net", "acl_src_mask", "acl_dst_net", "acl_dst_mask",
     "acl_bv_bnd_src", "acl_bv_bnd_dst", "acl_bv_src", "acl_bv_dst",
     "acl_bv_sport", "acl_bv_dport", "acl_bv_proto",
     "glb_src_net", "glb_src_mask", "glb_dst_net", "glb_dst_mask",
     "glb_bv_bnd_src", "glb_bv_bnd_dst", "glb_bv_src", "glb_bv_dst",
     "glb_bv_sport", "glb_bv_dport", "glb_bv_proto",
     "tnt_pfx_net", "tnt_pfx_mask",
     "fib_prefix", "fib_mask", "fib_next_hop", "fib_grp_nh",
     "nat_ext_ip", "natb_ip", "nat_snat_ip", "ovl_vtep_ip",
     "svc_vip_ip", "svc_bk_ip") + LPM_FIELDS
    + tuple(f for f, dt in STATE_FIELDS.items() if dt == np.uint32))
FIELD_DTYPES: Dict[str, type] = {
    f: (np.uint32 if f in _U32_FIELDS
        else np.int8 if f in ("glb_ml_w1", "glb_ml_w2")
        else np.float32 if f in ("glb_mxu_coeff", "glb_mxu_k")
        else np.int32)
    for f in HOST_FIELDS + tuple(STATE_FIELDS)
}


def tensor_of(arr, device) -> torch.Tensor:
    """One staged numpy array -> tensor on ``device`` (uint32 keeps its
    bits as int32; int8/float32 keep their type)."""
    a = np.asarray(arr)
    if a.dtype not in (np.int8, np.float32):
        a = as_i32(a)
    # np.array keeps a 0-d array 0-d (ascontiguousarray would not)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def numpy_of(field: str, t: torch.Tensor) -> np.ndarray:
    """One table tensor -> numpy in the reference's dtype."""
    a = t.detach().cpu().numpy()
    if FIELD_DTYPES[field] == np.uint32:
        return a.view(np.uint32)
    return a


# --- session / state geometry -----------------------------------------


def natsess_slots_of(config: DataplaneConfig) -> int:
    n = int(config.natsess_slots or 0)
    return n if n else config.sess_slots


def tel_capacity(config: DataplaneConfig) -> Tuple[int, int, int, int]:
    """(lat_buckets, sketch_rows, sketch_cols, topk) of the telemetry
    planes: placeholders for "off", and for the sketch and top-K planes
    under "latency" (the reference's shapes)."""
    mode = config.telemetry
    if mode == "off":
        return 1, 1, 1, 1
    nb = int(config.telemetry_lat_buckets)
    if mode == "latency":
        return nb, 1, 1, 1
    return (nb, int(config.telemetry_sketch_rows),
            int(config.telemetry_sketch_cols), int(config.telemetry_topk))


def tnt_capacity(config: DataplaneConfig) -> Tuple[int, int]:
    """(tenants T, prefix slots S) of the tenant planes: (1, 1)
    placeholders with tenancy off (the stage is compiled out)."""
    if config.tenancy == "off":
        return 1, 1
    return int(config.tenancy_tenants), int(config.tenancy_prefixes)


def svc_capacity(config: DataplaneConfig) -> Tuple[int, int]:
    """(VIP rows V, backend ways B) of the service planes; ``svc_vips``
    0 keeps one row that never matches (``svc_bk_n`` 0)."""
    v = int(config.svc_vips)
    return (v if v > 0 else 1), int(config.svc_backend_ways)


def state_shapes(config: DataplaneConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of every state field: the [slots/ways, ways] session
    grids, () cursors, the telemetry planes at ``tel_capacity``, the
    [T] tenancy planes and the [G, W] ECMP accounting plane."""
    w = config.sess_ways
    sess = (config.sess_slots // w, w)
    nat = (natsess_slots_of(config) // w, w)
    g, gw = ecmp_capacity(config)
    nb, d, cols, k = tel_capacity(config)
    out = {}
    for f in SESSION_FIELDS:
        out[f] = (() if f.endswith("_sweep_cursor")
                  else nat if f.startswith("natsess_") else sess)
    out.update({"tel_lat_hist": (nb,), "tel_sketch": (d, cols),
                "tel_sketched": ()})
    for f in ("tel_top_key", "tel_top_src", "tel_top_dst",
              "tel_top_ports", "tel_top_cnt"):
        out[f] = (k,)
    n_t, _ = tnt_capacity(config)
    for f in TENANCY_STATE_FIELDS:
        out[f] = (n_t,)
    out["fib_ecmp_c"] = (g, gw)
    return out


def zero_sessions(config: DataplaneConfig) -> Dict[str, np.ndarray]:
    """Fresh (empty) session-state arrays (host numpy)."""
    shapes = state_shapes(config)
    return {k: np.zeros(shapes[k], dt) for k, dt in SESSION_FIELDS.items()}


def zero_state_device(config: DataplaneConfig,
                      device) -> Dict[str, torch.Tensor]:
    """Every state field zero-filled on ``device`` (no host upload)."""
    shapes = state_shapes(config)
    return {f: torch.zeros(shapes[f], dtype=torch.int32, device=device)
            for f in STATE_FIELDS}


def restored_sessions(config: DataplaneConfig,
                      sessions) -> Dict[str, np.ndarray]:
    """A ``{field: host array}`` mapping of SESSION_FIELDS (a restored
    snapshot, a migrated range) checked against the config's geometry as
    the reference's ``to_device(sessions=...)`` checks it, each array
    in its staging dtype."""
    missing = set(SESSION_FIELDS) - set(sessions)
    if missing:
        raise ValueError(
            f"restored session state missing fields: {sorted(missing)}")
    shapes = state_shapes(config)
    for f in SESSION_FIELDS:
        if tuple(np.shape(sessions[f])) != shapes[f]:
            raise ValueError(
                f"restored session field {f!r} shape "
                f"{tuple(np.shape(sessions[f]))} != configured {shapes[f]}")
    return {f: np.asarray(sessions[f], dt) for f, dt in SESSION_FIELDS.items()}


# --- config validation -------------------------------------------------


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def validate_dataplane_config(config: DataplaneConfig) -> None:
    """Fail fast on a bad knob (the reference's checks, same
    messages)."""
    c = config
    ways, stride = c.sess_ways, c.sess_sweep_stride
    if not _is_pow2(c.sess_slots):
        raise ValueError(f"dataplane.sess_slots must be a power of two, "
                         f"got {c.sess_slots}")
    if not _is_pow2(ways):
        raise ValueError(
            f"dataplane.sess_ways must be a power of two, got {ways}")
    if ways > c.sess_slots:
        raise ValueError(f"dataplane.sess_ways ({ways}) exceeds "
                         f"sess_slots ({c.sess_slots})")
    nns = int(c.natsess_slots or 0)
    if nns and not _is_pow2(nns):
        raise ValueError(
            f"dataplane.natsess_slots must be a power of two (or 0 = "
            f"sess_slots), got {nns}")
    if nns and ways > nns:
        raise ValueError(
            f"dataplane.sess_ways ({ways}) exceeds natsess_slots ({nns})")
    if stride < 0 or (stride and not _is_pow2(stride)):
        raise ValueError(
            f"dataplane.sess_sweep_stride must be 0 (disabled) or a "
            f"power of two, got {stride}")
    if c.fib_impl not in ("dense", "lpm", "pallas", "auto"):
        raise ValueError(f"dataplane.fib_impl must be dense | lpm | "
                         f"pallas | auto, got {c.fib_impl!r}")
    if c.session_impl not in ("gather", "pallas", "auto"):
        raise ValueError(f"dataplane.session_impl must be gather | "
                         f"pallas | auto, got {c.session_impl!r}")
    if c.sess_hash not in ("fwd", "sym"):
        raise ValueError(
            f"dataplane.sess_hash must be fwd | sym, got {c.sess_hash!r}")
    if c.classifier not in ("dense", "mxu", "bv", "pallas", "auto"):
        raise ValueError(
            f"unknown dataplane.classifier {c.classifier!r} "
            f"(expected dense | mxu | bv | pallas | auto)")
    if int(c.fib_lpm_min_routes) < 0:
        raise ValueError(f"dataplane.fib_lpm_min_routes must be >= 0, "
                         f"got {c.fib_lpm_min_routes}")
    caps = tuple(c.fib_lpm_plen_caps or ())
    if len(caps) > 33:
        raise ValueError(
            f"dataplane.fib_lpm_plen_caps has {len(caps)} entries "
            f"(index = prefix length, max 33: /0../32)")
    for L, cap in enumerate(caps):
        if int(cap) < 0:
            raise ValueError(f"dataplane.fib_lpm_plen_caps[/{L}] must "
                             f"be >= 0, got {cap}")
    eg = int(c.fib_ecmp_groups)
    if not 0 <= eg <= 4096:
        raise ValueError(
            f"dataplane.fib_ecmp_groups must be in 0..4096, got {eg}")
    ew = int(c.fib_ecmp_ways)
    if eg and (not _is_pow2(ew) or ew > 256):
        raise ValueError(
            f"dataplane.fib_ecmp_ways must be a power of two <= 256 "
            f"(the flow-hash member pick masks with W-1), got {ew}")
    if c.ml_stage not in ("off", "score", "enforce"):
        raise ValueError(f"dataplane.ml_stage must be off | score | "
                         f"enforce, got {c.ml_stage!r}")
    if int(c.ml_hidden) < 1:
        raise ValueError(
            f"dataplane.ml_hidden must be >= 1, got {c.ml_hidden}")
    if int(c.ml_trees) < 1:
        raise ValueError(
            f"dataplane.ml_trees must be >= 1, got {c.ml_trees}")
    if not 1 <= int(c.ml_depth) <= 8:
        raise ValueError(f"dataplane.ml_depth must be in 1..8 (leaf "
                         f"table is 2^depth), got {c.ml_depth}")
    if c.telemetry not in ("off", "latency", "full"):
        raise ValueError(f"dataplane.telemetry must be off | latency | "
                         f"full, got {c.telemetry!r}")
    nb = int(c.telemetry_lat_buckets)
    if not 4 <= nb <= 31:
        raise ValueError(f"dataplane.telemetry_lat_buckets must be in "
                         f"4..31 (log2 µs bins in int32), got {nb}")
    d = int(c.telemetry_sketch_rows)
    if not 1 <= d <= 8:
        raise ValueError(
            f"dataplane.telemetry_sketch_rows must be in 1..8, got {d}")
    w = int(c.telemetry_sketch_cols)
    if not _is_pow2(w):
        raise ValueError(f"dataplane.telemetry_sketch_cols must be a "
                         f"power of two (column masking), got {w}")
    k = int(c.telemetry_topk)
    if not 1 <= k <= 64:
        raise ValueError(
            f"dataplane.telemetry_topk must be in 1..64, got {k}")
    if c.tenancy not in ("off", "on"):
        raise ValueError(
            f"dataplane.tenancy must be off | on, got {c.tenancy!r}")
    t = int(c.tenancy_tenants)
    if not 1 <= t <= 64:
        raise ValueError(
            f"dataplane.tenancy_tenants must be in 1..64, got {t}")
    s = int(c.tenancy_prefixes)
    if not 1 <= s <= 1024:
        raise ValueError(
            f"dataplane.tenancy_prefixes must be in 1..1024, got {s}")
    if c.overlay not in ("off", "vxlan"):
        raise ValueError(
            f"dataplane.overlay must be off | vxlan, got {c.overlay!r}")
    v = int(c.svc_vips)
    if not 0 <= v <= 4096:
        raise ValueError(
            f"dataplane.svc_vips must be in 0..4096, got {v}")
    b = int(c.svc_backend_ways)
    if not _is_pow2(b) or b > 256:
        raise ValueError(
            f"dataplane.svc_backend_ways must be a power of two <= 256 "
            f"(the flow-hash backend pick masks with B-1), got {b}")


# --- rule packing (vpp_tpu/pipeline/tables.py pack_rules) --------------


def _mask_of(plen: int, bits: int = 32) -> int:
    return ((1 << bits) - 1) ^ ((1 << (bits - plen)) - 1) if plen else 0


def _empty_packed(max_rules: int) -> Dict[str, np.ndarray]:
    """All-padding match arrays (rows that can never match)."""
    return {
        "src_net": np.zeros(max_rules, np.uint32),
        "src_mask": np.zeros(max_rules, np.uint32),
        "dst_net": np.zeros(max_rules, np.uint32),
        "dst_mask": np.zeros(max_rules, np.uint32),
        "proto": np.full(max_rules, -2, np.int32),
        "sport_lo": np.ones(max_rules, np.int32),
        "sport_hi": np.zeros(max_rules, np.int32),
        "dport_lo": np.ones(max_rules, np.int32),
        "dport_hi": np.zeros(max_rules, np.int32),
        "action": np.full(max_rules, -1, np.int32),
    }


def _rule_row(r: ContivRule) -> tuple:
    """One rule's 10-value match row; an IPv6 rule is a never-match row
    (non-IPv4 frames never reach the v4 classifier)."""
    if (r.src_network is not None and r.src_network.version != 4) or (
        r.dest_network is not None and r.dest_network.version != 4
    ):
        log.warning("skipping IPv6 rule in v4 table: %s", r)
        return (0, 0, 0, 0, -2, 1, 0, 1, 0, -1)
    if r.src_network is not None:
        sm = _mask_of(r.src_network.prefixlen)
        sn = int(r.src_network.network_address) & sm
    else:
        sm = sn = 0
    if r.dest_network is not None:
        dm = _mask_of(r.dest_network.prefixlen)
        dn = int(r.dest_network.network_address) & dm
    else:
        dm = dn = 0
    sp, dp = r.src_port, r.dest_port
    return (
        sn, sm, dn, dm, r.protocol.ip_proto,
        0 if sp == ANY_PORT else sp, 65535 if sp == ANY_PORT else sp,
        0 if dp == ANY_PORT else dp, 65535 if dp == ANY_PORT else dp,
        int(r.action),
    )


def pack_rules(rules: Sequence[ContivRule],
               max_rules: int) -> Dict[str, np.ndarray]:
    """Compile an ordered rule list into padded match arrays (first
    match wins; padding rows never match)."""
    n = len(rules)
    if n > max_rules:
        raise ValueError(f"{n} rules exceed table capacity {max_rules}")
    out = _empty_packed(max_rules)
    if n:
        _fill_packed(out, np.array([_rule_row(r) for r in rules], np.int64),
                     n)
    return out


def _fill_packed(out: Dict[str, np.ndarray], rows: np.ndarray,
                 n: int) -> None:
    # out's insertion order IS the row-tuple order
    for j, arr in enumerate(out.values()):
        arr[:n] = rows[:, j].astype(arr.dtype)


def pack_rules_incremental(
    rules: Sequence[ContivRule], max_rules: int,
    prev_rules: Optional[list], prev_rows: Optional[np.ndarray],
) -> Tuple[Dict[str, np.ndarray], np.ndarray, Optional[np.ndarray]]:
    """``pack_rules`` with an identity diff against the previous commit:
    unchanged entries of a commit's full rule list are the SAME rule
    objects, so ``new[i] is old[i]`` keeps row i and every other row is
    recomputed (a rule that moved fails the check at its new index).
    Returns ``(packed, rows, changed)``: ``rows`` caches the next call;
    ``changed`` the sorted indices of rows that differ from the previous
    commit, rows now past the end included (their bit-plane columns
    revert to padding), or None without a previous state (full
    compile)."""
    n = len(rules)
    if n > max_rules:
        raise ValueError(f"{n} rules exceed table capacity {max_rules}")
    rows = np.empty((n, 10), np.int64)
    if prev_rules is None or prev_rows is None:
        changed = None
        for i, r in enumerate(rules):
            rows[i] = _rule_row(r)
    else:
        m = len(prev_rules)
        changed_idx = []
        for i, r in enumerate(rules):
            if i < m and r is prev_rules[i]:
                rows[i] = prev_rows[i]
            else:
                rows[i] = _rule_row(r)
                changed_idx.append(i)
        changed_idx.extend(range(n, m))
        changed = np.asarray(changed_idx, np.int64)
    packed = _empty_packed(max_rules)
    if n:
        _fill_packed(packed, rows, n)
    return packed, rows, changed


# --- the ML model planes ------------------------------------------------


def ml_capacity(config: DataplaneConfig) -> Tuple[int, int, int, int]:
    """(features, hidden, trees, depth) capacity of the staged model
    planes; minimal placeholders with ``ml_stage`` off (the stage is
    compiled out, so they are never read)."""
    if config.ml_stage == "off":
        return ML_FEATURES, 1, 1, 1
    return (ML_FEATURES, int(config.ml_hidden), int(config.ml_trees),
            int(config.ml_depth))


def empty_ml(config: DataplaneConfig) -> Dict[str, np.ndarray]:
    """The no-model staging arrays at the config's capacity; the flag
    threshold INT32_MAX flags nothing."""
    f, h, t, d = ml_capacity(config)
    return {
        "glb_ml_w1": np.zeros((f, h), np.int8),
        "glb_ml_b1": np.zeros(h, np.int32),
        "glb_ml_s1": np.int32(0),
        "glb_ml_w2": np.zeros(h, np.int8),
        "glb_ml_b2": np.int32(0),
        "glb_ml_f_feat": np.zeros((t, d), np.int32),
        "glb_ml_f_thresh": np.zeros((t, d), np.int32),
        "glb_ml_f_leaf": np.zeros((t, 1 << d), np.int32),
        "glb_ml_thresh": np.int32(0x7FFFFFFF),
        "glb_ml_action": np.int32(0),
        "glb_ml_rl_shift": np.int32(0),
        "glb_ml_version": np.int32(0),
    }


def _fold_ml(model, config: DataplaneConfig
             ) -> Tuple[Dict[str, np.ndarray], int]:
    """Validate one model (an ``MlModel`` or its dict form) against the
    config's capacity and return the padded, zero-point-folded staging
    arrays and the staged kind. It validates completely before it
    returns, so the builder only assigns: a refused model leaves the
    staging untouched. The fold: the device centers features to
    ``x - 128``, so each int32 bias absorbs ``+128 * column_sum(W)``
    (exact in integers)."""
    from vpp_tpu_torch.ml.model import MlModel, MlModelError
    from vpp_tpu_torch.ops.mlscore import (
        ML_ACTION_NAMES,
        ML_KIND_FOREST,
        ML_KIND_MLP,
    )

    if isinstance(model, dict):
        model = MlModel.from_dict(model)
    model.validate()
    f, h, t, d = ml_capacity(config)
    if model.n_features > f:
        raise MlModelError(f"model has {model.n_features} features, "
                           f"pipeline computes {f}")
    out = empty_ml(config)
    action_code = {name: code for code, name
                   in ML_ACTION_NAMES.items()}[model.action]
    if model.kind == "mlp":
        mh = model.hidden
        if mh > h:
            raise MlModelError(
                f"model hidden {mh} exceeds dataplane.ml_hidden {h}")
        w1 = np.zeros((f, h), np.int8)
        w1[: model.n_features, :mh] = model.w1
        b1 = np.zeros(h, np.int32)
        # layer 1: +128 per centered input column
        b1[:mh] = model.b1.astype(np.int64) + 128 * model.w1.astype(
            np.int64).sum(axis=0)
        # padding columns: bias 0, relu 0, q1 0, centered -128 times a
        # zero weight: they add nothing to layer 2
        w2 = np.zeros(h, np.int8)
        w2[:mh] = model.w2
        b2 = int(model.b2) + 128 * int(model.w2.astype(np.int64).sum())
        out.update(glb_ml_w1=w1, glb_ml_b1=b1,
                   glb_ml_s1=np.int32(model.s1), glb_ml_w2=w2,
                   glb_ml_b2=np.int32(b2))
        kind = ML_KIND_MLP
    else:
        mt, md = model.trees, model.depth
        if mt > t or md > d:
            raise MlModelError(f"forest {mt}x{md} exceeds "
                               f"dataplane.ml_trees/ml_depth {t}x{d}")
        f_feat = np.zeros((t, d), np.int32)
        f_thresh = np.full((t, d), 255, np.int32)  # pad bits never set
        f_leaf = np.zeros((t, 1 << d), np.int32)
        f_feat[:mt, :md] = model.f_feat
        f_thresh[:mt, :md] = model.f_thresh
        # pad levels test feature 0 > 255 (bit 0), so a padded tree's
        # leaf index spans only the model's 2^md prefix
        f_leaf[:mt, : 1 << md] = model.f_leaf
        out.update(glb_ml_f_feat=f_feat, glb_ml_f_thresh=f_thresh,
                   glb_ml_f_leaf=f_leaf, glb_ml_b2=np.int32(model.b2))
        kind = ML_KIND_FOREST
    out.update(glb_ml_thresh=np.int32(model.flag_thresh),
               glb_ml_action=np.int32(action_code),
               glb_ml_rl_shift=np.int32(model.rl_shift),
               glb_ml_version=np.int32(model.version))
    return out, kind


# --- the tenant and service planes ----------------------------------------

def _assign_ways(prev_assign, members, target, key=lambda m: m):
    """The sticky way fill of ECMP groups and service backends: pass 1
    keeps each surviving member (matched by ``key``) on the ways it
    owned, up to its target share; pass 2 gives every freed or new way
    to the member furthest under its share (ties by member order).
    Returns the member index of each way."""
    ways = len(prev_assign)
    n = len(members)
    by_key = {key(m): i for i, m in enumerate(members)}
    counts = [0] * n
    assign_i = [None] * ways
    for w in range(ways):
        pm = prev_assign[w]
        i = by_key.get(key(pm)) if pm is not None else None
        if i is not None and counts[i] < target[i]:
            assign_i[w] = i
            counts[i] += 1
    for w in range(ways):
        if assign_i[w] is None:
            i = min(range(n), key=lambda j: (counts[j] - target[j], j))
            assign_i[w] = i
            counts[i] += 1
    return assign_i


# --- upload groups (the reference's, vpp_tpu/pipeline/tables.py) -------

# Global-table fields in ROW space [R] (diffed and block-written
# together; the bit-plane fields live in COLUMN space [R'])
_GLB_ROW_FIELDS: Tuple[str, ...] = (
    "glb_src_net", "glb_src_mask", "glb_dst_net", "glb_dst_mask",
    "glb_proto", "glb_sport_lo", "glb_sport_hi", "glb_dport_lo",
    "glb_dport_hi", "glb_action",
)


def _block_of(changed: np.ndarray, total: int) -> Optional[Tuple[int, int]]:
    """(lo, width) of the smallest padded block covering every changed
    index, widths on a x4 ladder from 256; None when nothing changed.
    ``lo`` is not aligned."""
    idx = np.nonzero(changed)[0]
    if len(idx) == 0:
        return None
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    w = 256
    while w < hi - lo:
        w *= 4
    if w >= total:
        return 0, total
    return min(lo, total - w), w


# Which table fields each builder mutation invalidates: to_device ships
# only dirty groups; a clean group's tensors are neither copied nor
# derived.
_UPLOAD_GROUPS: Dict[str, Tuple[str, ...]] = {
    "acl": _ACL_FIELDS,
    "glb": ("glb_src_net", "glb_src_mask", "glb_dst_net", "glb_dst_mask",
            "glb_proto", "glb_sport_lo", "glb_sport_hi", "glb_dport_lo",
            "glb_dport_hi", "glb_action", "glb_nrules", "glb_mxu_coeff",
            "glb_mxu_k", "glb_mxu_act"),
    # per dimension plane: only the planes compile_bv rebuilt re-ship
    "glb_bv": ("glb_bv_bnd_src", "glb_bv_bnd_dst", "glb_bv_bnd_sport",
               "glb_bv_bnd_dport", "glb_bv_nbnd", "glb_bv_src",
               "glb_bv_dst", "glb_bv_sport", "glb_bv_dport",
               "glb_bv_proto"),
    "ml": _ML_FIELDS,
    "if": _IF_FIELDS,
    # per field: the per-slot rows through the block blob, the planes
    # of the touched lengths, the counts, hints and ECMP tables as
    # _fib_dirty names them
    "fib": _FIB_FIELDS,
    "nat": _NAT_FIELDS,
    "config": ("sess_max_age", "ovl_vtep_ip"),
    "tenant": _TNT_FIELDS,
    "svc": _SVC_FIELDS,
}

# Per-slot FIB row arrays: diffed together and block-written as one
# blob [9 x w]
_FIB_SLOT_FIELDS: Tuple[str, ...] = _FIB_FIELDS[:9]

# Service planes in VIP-row space: one blob [5 x w | 2 x w x B]
_SVC_1D_FIELDS: Tuple[str, ...] = (
    "svc_vip_ip", "svc_vip_port", "svc_vip_proto", "svc_vip_snat",
    "svc_bk_n",
)
_SVC_2D_FIELDS: Tuple[str, ...] = ("svc_bk_ip", "svc_bk_port")

# BV dimension -> its global-table fields (the nbnd count vector rides
# along whenever any dimension was rebuilt)
_GLB_BV_DIM_FIELDS: Dict[str, Tuple[str, ...]] = {
    "src": ("glb_bv_bnd_src", "glb_bv_src"),
    "dst": ("glb_bv_bnd_dst", "glb_bv_dst"),
    "sport": ("glb_bv_bnd_sport", "glb_bv_sport"),
    "dport": ("glb_bv_bnd_dport", "glb_bv_dport"),
    "proto": ("glb_bv_proto",),
}


def _torch_dtype(arr: np.ndarray) -> torch.dtype:
    """The tensor dtype ``tensor_of`` gives ``arr``."""
    return {np.dtype(np.int8): torch.int8,
            np.dtype(np.float32): torch.float32}.get(arr.dtype, torch.int32)


class TableBuilder:
    """Mutable host-side (numpy) staging area for the device tables;
    ``to_device()`` produces the next epoch's DataplaneTables on the
    builder's device, grafting the live session state of the previous
    epoch so established flows survive the swap."""

    def __init__(self, config: DataplaneConfig = DataplaneConfig(),
                 device=None):
        validate_dataplane_config(config)
        self.config = c = config
        self.device = resolve_device(device)
        z = np.zeros
        self.acl = {k: np.tile(v, (c.max_tables, 1))
                    for k, v in pack_rules([], c.max_rules).items()}
        self.acl_nrules = z(c.max_tables, np.int32)
        self.glb = pack_rules([], c.max_global_rules)
        self.glb_nrules = 0
        self.bv_enabled = bv_enabled_for(c)
        self.glb_bv = empty_bv(c.max_global_rules, self.bv_enabled)
        self._bv_cols = None        # per-dimension column cache
        self._bv_dirty = set(_UPLOAD_GROUPS["glb_bv"])
        self.bv_rebuilt: Tuple[str, ...] = ()  # the last commit's planes
        self.bv_build_ms = 0.0
        # opt-out of the bit-plane compile, the reference's default on
        self.mxu_enabled = True
        self.glb_mxu = empty_bitplanes(c.max_global_rules)
        # the config transaction trace (pipeline/txn.py): with recording
        # started every mutator appends its declarative op here, and the
        # owning Dataplane journals the batch at its swap; ``txn_label``
        # names the next journaled txn
        self._rec = None
        self.txn_label = ""
        local_bv = empty_bv(c.max_rules, self.bv_enabled)
        lib, lw, lpr = bv_capacity(c.max_rules, self.bv_enabled)
        self.acl_bv = {
            "bnd_src": np.tile(local_bv.bnd_src, (c.max_tables, 1)),
            "bnd_dst": np.tile(local_bv.bnd_dst, (c.max_tables, 1)),
            "bnd_sport": np.tile(local_bv.bnd_sport, (c.max_tables, 1)),
            "bnd_dport": np.tile(local_bv.bnd_dport, (c.max_tables, 1)),
            "nbnd": np.tile(local_bv.nbnd, (c.max_tables, 1)),
            "src": z((c.max_tables, lib, lw), np.uint32),
            "dst": z((c.max_tables, lib, lw), np.uint32),
            "sport": z((c.max_tables, lib, lw), np.uint32),
            "dport": z((c.max_tables, lib, lw), np.uint32),
            "proto": z((c.max_tables, lpr, lw), np.uint32),
        }
        self.acl_bv_ok = np.ones(c.max_tables, bool)
        self.if_type = z(c.max_ifaces, np.int32)
        self.if_local_table = np.full(c.max_ifaces, -1, np.int32)
        self.if_apply_global = z(c.max_ifaces, np.int32)
        self.fib_prefix = z(c.fib_slots, np.uint32)
        self.fib_mask = z(c.fib_slots, np.uint32)
        self.fib_plen = np.full(c.fib_slots, -1, np.int32)
        self.fib_tx_if = z(c.fib_slots, np.int32)
        self.fib_disp = np.full(c.fib_slots, int(Disposition.DROP),
                                np.int32)
        self.fib_next_hop = z(c.fib_slots, np.uint32)
        self.fib_node_id = np.full(c.fib_slots, -1, np.int32)
        self.fib_snat = z(c.fib_slots, np.int32)
        self.fib_grp = np.full(c.fib_slots, -1, np.int32)
        self.lpm_enabled = lpm_enabled_for(c)
        self.lpm_caps = lpm_len_caps(c)
        self._lpm_layout, hint_rows = lpm_hint_layout(self.lpm_caps)
        self.lpm_hint = z(hint_rows, np.int32)
        self.lpm_planes = {}
        for length in range(LPM_LENGTHS):
            plane = z((2, self.lpm_caps[length]), np.uint32)
            plane[0, :] = LPM_PAD
            self.lpm_planes[lpm_field(length)] = plane
        self.lpm_cnt = z(LPM_LENGTHS, np.int32)
        self.lpm_counts = z(LPM_LENGTHS, np.int64)
        self._lpm_dirty_lens = set(range(LPM_LENGTHS))
        self.lpm_build_ms = 0.0   # host cost of the last plane restage
        gcap, ways = ecmp_capacity(c)
        self.fib_grp_nh = z((gcap, ways), np.uint32)
        self.fib_grp_tx_if = np.full((gcap, ways), -1, np.int32)
        self.fib_grp_node = np.full((gcap, ways), -1, np.int32)
        self.fib_grp_n = z(gcap, np.int32)
        self.nat_ext_ip = z(c.nat_mappings, np.uint32)
        self.nat_ext_port = z(c.nat_mappings, np.int32)
        self.nat_proto = z(c.nat_mappings, np.int32)
        self.nat_boff = z(c.nat_mappings, np.int32)
        self.nat_bcnt = z(c.nat_mappings, np.int32)
        self.nat_total_w = z(c.nat_mappings, np.int32)
        self.nat_self_snat = z(c.nat_mappings, np.int32)
        self.natb_ip = z(c.nat_backends, np.uint32)
        self.natb_port = z(c.nat_backends, np.int32)
        self.natb_cumw = z(c.nat_backends, np.int32)
        self.nat_snat_ip = np.uint32(0)
        # the staged ML model (set_ml_model); ml_kind is its
        # ML_KIND_* (0: none), which the Dataplane re-gates on
        self.ml = empty_ml(c)
        self.ml_kind = 0
        # the tenant registry (set_tenant), compiled into the tnt_*
        # planes by _restage_tenants
        self.tenants: Dict[int, dict] = {}
        self.tnt: Dict[str, np.ndarray] = {}
        self._restage_tenants()
        # ECMP groups: {gid: {"members": [(nh, tx_if, node)], "assign":
        # [member per way]}} (set_nh_group)
        self.nh_groups: Dict[int, dict] = {}
        # the node's VTEP address (set_vtep_ip)
        self.ovl_vtep_ip = np.uint32(0)
        # the service registry (set_service), keyed (ip, port, proto),
        # compiled into the svc_* planes by _restage_svc
        self.services: Dict[Tuple[int, int, int], dict] = {}
        self.svc: Dict[str, np.ndarray] = {}
        self._restage_svc()
        # --- the incremental upload (module doc) ---
        # groups touched since the last to_device; every group is dirty
        # until the first one
        self._dirty = set(_UPLOAD_GROUPS)
        # the fields of the "fib" group to re-ship (per field)
        self._fib_dirty = set(_UPLOAD_GROUPS["fib"])
        # field -> the tensor the last to_device produced for it (the
        # live tables' tensors after a swap): clean groups reuse them,
        # dirty ones are written into them in place with ``into``
        self._dev_cache: Dict[str, torch.Tensor] = {}
        # the diff bases of the block paths: host arrays as of the last
        # successful device upload (None: the next commit ships full)
        self._glb_prev: Optional[Dict[str, np.ndarray]] = None
        self._fib_prev: Optional[Dict[str, np.ndarray]] = None
        self._svc_prev: Optional[Dict[str, np.ndarray]] = None
        # the identity-diff caches of set_global_table (None: the next
        # commit compiles in full)
        self._glb_rules_ref: Optional[list] = None
        self._glb_rows: Optional[np.ndarray] = None
        self._glb_bad: Optional[np.ndarray] = None
        # the last "fib" and "svc" uploads (the reference's records:
        # fields re-shipped whole, blob bytes, bytes, host ms), and per
        # group the last to_device's path ("clean", "block" or "full"),
        # fields shipped whole and bytes
        self.fib_upload: Dict[str, object] = {}
        # whether the last to_device re-shipped FIB state (the swap's
        # route-churn histogram observes only those)
        self.fib_last_shipped = False
        self.svc_upload: Dict[str, object] = {}
        self.last_upload: Dict[str, dict] = {}
        # this to_device's writes go in place (``into``); the fields it
        # gave new tensors
        self._in_place = False
        self._fresh: set = set()

    def _mark(self, group: str) -> None:
        self._dirty.add(group)

    # --- op recording (the config transaction trace) ---
    def start_recording(self) -> None:
        from vpp_tpu_torch.pipeline.txn import ConfigTxn

        if self._rec is None:
            self._rec = ConfigTxn()

    def drain_recording(self):
        """The ops recorded since the last drain as one ConfigTxn (None
        when recording is off or nothing was staged); consumes the
        pending ``txn_label``. ``Dataplane.swap`` calls it under the
        commit lock."""
        from vpp_tpu_torch.pipeline.txn import ConfigTxn

        if self._rec is None or not self._rec.ops:
            self.txn_label = ""
            return None
        txn = self._rec
        txn.label = self.txn_label
        self.txn_label = ""
        self._rec = ConfigTxn()
        return txn

    def bv_ok(self) -> bool:
        """Whether the BV classifier can serve this staged config."""
        return (self.bv_enabled and self.glb_bv.ok
                and bool(self.acl_bv_ok.all()))

    # --- ACL ---
    def set_local_table(self, slot: int,
                        rules: Sequence[ContivRule]) -> None:
        packed = pack_rules(rules, self.config.max_rules)
        for k, v in packed.items():
            self.acl[k][slot] = v
        self.acl_nrules[slot] = len(rules)
        if self.bv_enabled:
            bv, _, _ = compile_bv(packed, self.config.max_rules)
            for dim in ("src", "dst", "sport", "dport"):
                self.acl_bv[f"bnd_{dim}"][slot] = getattr(bv, f"bnd_{dim}")
                self.acl_bv[dim][slot] = getattr(bv, f"bm_{dim}")
            self.acl_bv["nbnd"][slot] = bv.nbnd
            self.acl_bv["proto"][slot] = bv.bm_proto
            self.acl_bv_ok[slot] = bv.ok
        if self._rec is not None:
            self._rec.set_local_table(slot, rules)
        self._mark("acl")

    def clear_local_table(self, slot: int) -> None:
        self.set_local_table(slot, [])

    def set_global_table(self, rules: Sequence[ContivRule]) -> None:
        """Stage the ordered global rule list. Incremental as the
        reference's: rows whose rule object is unchanged are kept
        (``pack_rules_incremental``), only the changed bit-plane columns
        recompile (``compile_bitplanes_update``) and only the BV
        dimension planes whose intervals moved rebuild (``compile_bv``,
        which marks just those planes to re-ship). The identity caches
        are kept only after a successful compile: an exception clears
        them, so a retried commit compiles in full."""
        cap = self.config.max_global_rules
        packed, rows, changed = pack_rules_incremental(
            rules, cap, self._glb_rules_ref, self._glb_rows)
        self.glb = packed
        self.glb_nrules = len(rules)
        if self._rec is not None:
            self._rec.set_global_table(rules)
        try:
            if not self.mxu_enabled:
                self.glb_mxu = empty_bitplanes(cap)
                bad = None  # a full compile if re-enabled
            elif changed is None or self._glb_bad is None:
                self.glb_mxu, bad = compile_bitplanes_full(self.glb, cap)
            else:
                self.glb_mxu, bad = compile_bitplanes_update(
                    self.glb, cap, self.glb_mxu, self._glb_bad, changed)
            if self.bv_enabled:
                # upload-ok: compile_bv reuses the previous planes for
                # every dimension it did not rebuild, so with `rebuilt`
                # empty the device copies are still equal and leaving
                # glb_bv unmarked is the zero-reship design, not a stale
                # plane; a rebuilt dimension marks the group below
                self.glb_bv, self._bv_cols, rebuilt = compile_bv(
                    self.glb, cap, prev=self.glb_bv,
                    prev_cols=self._bv_cols)
                self.bv_rebuilt = rebuilt
                self.bv_build_ms = self.glb_bv.build_ms
                if rebuilt:
                    self._bv_dirty.add("glb_bv_nbnd")
                    for dim in rebuilt:
                        self._bv_dirty.update(_GLB_BV_DIM_FIELDS[dim])
                    self._mark("glb_bv")
        except Exception:
            self._glb_rules_ref = None
            self._glb_rows = None
            self._glb_bad = None
            self._bv_cols = None
            self._bv_dirty = set(_UPLOAD_GROUPS["glb_bv"])
            raise
        self._glb_rules_ref = list(rules)
        self._glb_rows = rows
        self._glb_bad = bad
        self._mark("glb")

    # --- interfaces ---
    def set_interface(self, if_index: int, if_type: int,
                      local_table: int = -1,
                      apply_global: bool = False) -> None:
        self.if_type[if_index] = int(if_type)
        self.if_local_table[if_index] = local_table
        self.if_apply_global[if_index] = int(apply_global)
        if self._rec is not None:
            self._rec.set_interface(if_index, int(if_type), local_table,
                                    bool(apply_global))
        self._mark("if")

    def set_if_local_table(self, if_index: int, slot: int) -> None:
        self.if_local_table[if_index] = slot
        if self._rec is not None:
            self._rec.set_if_local_table(if_index, slot)
        self._mark("if")

    # --- FIB ---
    def _mark_fib_slots(self, *plens: int) -> None:
        """One route mutation: the per-slot rows changed (they ship by
        block or whole) and the planes of the named prefix lengths need
        restaging."""
        self._fib_dirty.update(_FIB_SLOT_FIELDS)
        if self.lpm_enabled:
            self._lpm_dirty_lens.update(
                int(p) for p in plens if 0 <= p <= 32)
        self._mark("fib")

    def add_route(self, prefix: str, tx_if: int, disposition: Disposition,
                  next_hop: int = 0, node_id: int = -1,
                  slot: Optional[int] = None, snat: bool = False,
                  group: Optional[int] = None) -> int:
        """Install one route in ``slot`` (default: the first free one).
        ``group`` names an ECMP group (``set_nh_group``) the route
        resolves through instead of its own next hop, interface and
        node, which are staged as given all the same."""
        net = ipaddress.ip_network(prefix)
        if group is not None:
            gcap = self.fib_grp_nh.shape[0]
            if int(self.config.fib_ecmp_groups) <= 0:
                raise ValueError(
                    "route names an ECMP group but "
                    "dataplane.fib_ecmp_groups is 0")
            if not 0 <= int(group) < gcap:
                raise ValueError(
                    f"ECMP group {group} out of range 0..{gcap - 1}")
        if slot is None:
            free = np.nonzero(self.fib_plen < 0)[0]
            if len(free) == 0:
                raise ValueError("FIB full")
            slot = int(free[0])
        old_plen = int(self.fib_plen[slot])
        mask = _mask_of(net.prefixlen)
        self.fib_prefix[slot] = int(net.network_address) & mask
        self.fib_mask[slot] = mask
        self.fib_plen[slot] = net.prefixlen
        self.fib_tx_if[slot] = tx_if
        self.fib_disp[slot] = int(disposition)
        self.fib_next_hop[slot] = next_hop
        self.fib_node_id[slot] = node_id
        self.fib_snat[slot] = int(snat)
        self.fib_grp[slot] = -1 if group is None else int(group)
        if self._rec is not None:
            self._rec.add_route(prefix, tx_if, int(disposition),
                                int(next_hop), int(node_id), bool(snat),
                                slot=slot, group=group)
        self._mark_fib_slots(old_plen, net.prefixlen)
        return slot

    def add_routes_np(self, nets: np.ndarray, plens: np.ndarray,
                      tx_if: np.ndarray, disp: np.ndarray,
                      next_hop=0, node_id=-1, snat=0, group=-1,
                      base_slot: int = 0) -> int:
        """Bulk route loader: vectorised writes of N routes into slots
        ``[base_slot, base_slot + N)`` (scalars broadcast; ``nets`` are
        masked here), with ``add_route``'s ECMP-group checks. Returns the
        count staged."""
        n = len(nets)
        if base_slot + n > self.config.fib_slots:
            raise ValueError(
                f"{n} routes at base {base_slot} exceed fib_slots "
                f"{self.config.fib_slots}")
        grp = np.asarray(group, np.int32)
        if (grp >= 0).any():
            # an out-of-range id would be clipped onto a real group on
            # the device and forward through its members
            gcap = self.fib_grp_nh.shape[0]
            if int(self.config.fib_ecmp_groups) <= 0:
                raise ValueError(
                    "routes name ECMP groups but "
                    "dataplane.fib_ecmp_groups is 0")
            if int(grp.max()) >= gcap or int(grp.min()) < -1:
                raise ValueError(
                    f"ECMP group ids must be -1 (none) or in "
                    f"0..{gcap - 1}")
        plens = np.asarray(plens, np.int32)
        sl = slice(base_slot, base_slot + n)
        masks = np.array([_mask_of(int(p)) for p in range(33)],
                         np.uint32)[plens]
        # a copy: the lengths these slots held before the write (their
        # planes must restage too; the reference reads them through a
        # view after the write, ROADMAP.md)
        old = self.fib_plen[sl].copy()
        self.fib_prefix[sl] = np.asarray(nets, np.uint32) & masks
        self.fib_mask[sl] = masks
        self.fib_plen[sl] = plens
        self.fib_tx_if[sl] = np.asarray(tx_if, np.int32)
        self.fib_disp[sl] = np.asarray(disp, np.int32)
        self.fib_next_hop[sl] = np.asarray(next_hop, np.uint32)
        self.fib_node_id[sl] = np.asarray(node_id, np.int32)
        self.fib_snat[sl] = np.asarray(snat, np.int32)
        self.fib_grp[sl] = np.asarray(group, np.int32)
        touched = set(np.unique(plens).tolist())
        touched |= set(np.unique(old[old >= 0]).tolist())
        self._mark_fib_slots(*touched)
        return n

    def del_route(self, prefix: str) -> bool:
        net = ipaddress.ip_network(prefix)
        mask = _mask_of(net.prefixlen)
        want = int(net.network_address) & mask
        hit = np.nonzero((self.fib_plen == net.prefixlen)
                         & (self.fib_prefix == want))[0]
        if len(hit) == 0:
            return False
        self.fib_plen[hit[0]] = -1
        if self._rec is not None:
            self._rec.del_route(prefix)
        self._mark_fib_slots(net.prefixlen)
        return True

    # --- ECMP next-hop groups (ops/fib.py resolve_fib_slot) ---
    def set_nh_group(self, gid: int, members) -> None:
        """Stage one ECMP group of ``(next_hop_ip, tx_if, node_id)``
        members. The way fill is sticky (``_assign_ways``): surviving
        members keep the ways they own up to their rebalanced share."""
        if int(self.config.fib_ecmp_groups) <= 0:
            raise ValueError(
                "dataplane.fib_ecmp_groups is 0 — ECMP group tables "
                "carry placeholder shapes (raise the knob)")
        gcap, ways = self.fib_grp_nh.shape
        if not 0 <= int(gid) < gcap:
            raise ValueError(f"ECMP group {gid} out of range "
                             f"0..{gcap - 1}")
        gid = int(gid)
        mset = []
        for m in members:
            t = (int(m[0]), int(m[1]), int(m[2]))
            if t not in mset:
                mset.append(t)
        if not mset:
            raise ValueError(
                "ECMP group needs at least one member "
                "(del_nh_group removes a group)")
        if len(mset) > ways:
            raise ValueError(
                f"{len(mset)} distinct members exceed fib_ecmp_ways "
                f"{ways}")
        prev = self.nh_groups.get(gid)
        n = len(mset)
        target = [ways // n + (1 if i < ways % n else 0) for i in range(n)]
        assign = [mset[i] for i in _assign_ways(
            list(prev["assign"]) if prev else [None] * ways, mset, target)]
        self.nh_groups[gid] = {"members": mset, "assign": assign}
        self.fib_grp_nh[gid] = np.array([m[0] for m in assign], np.uint32)
        self.fib_grp_tx_if[gid] = np.array([m[1] for m in assign], np.int32)
        self.fib_grp_node[gid] = np.array([m[2] for m in assign], np.int32)
        self.fib_grp_n[gid] = n
        if self._rec is not None:
            self._rec.set_nh_group(gid, [list(m) for m in mset])
        self._mark_groups()

    def _mark_groups(self) -> None:
        self._fib_dirty.update(("fib_grp_nh", "fib_grp_tx_if",
                                "fib_grp_node", "fib_grp_n"))
        self._mark("fib")

    def del_nh_group(self, gid: int) -> bool:
        """Remove one ECMP group; routes still naming it fail closed
        (a no-route miss) until repointed."""
        if int(gid) not in self.nh_groups:
            return False
        gid = int(gid)
        del self.nh_groups[gid]
        self.fib_grp_nh[gid] = 0
        self.fib_grp_tx_if[gid] = -1
        self.fib_grp_node[gid] = -1
        self.fib_grp_n[gid] = 0
        if self._rec is not None:
            self._rec.del_nh_group(gid)
        self._mark_groups()
        return True

    def _restage_lpm(self) -> None:
        """Recompile the dirty per-length LPM planes: each length's
        slots sorted by prefix, the LOWEST slot kept per duplicate
        prefix (the dense lookup's tie-break), plus its stride hint
        rows (ops/lpm.py lpm_hint_layout)."""
        if not self._lpm_dirty_lens or not self.lpm_enabled:
            self._lpm_dirty_lens.clear()
            return
        t0 = time.perf_counter()
        for length in sorted(self._lpm_dirty_lens):
            cap = self.lpm_caps[length]
            slots = np.nonzero(self.fib_plen == length)[0]
            pfx = self.fib_prefix[slots]
            order = np.argsort(pfx, kind="stable")
            pfx, slots = pfx[order], slots[order]
            if len(pfx):
                keep = np.ones(len(pfx), bool)
                keep[1:] = pfx[1:] != pfx[:-1]
                pfx, slots = pfx[keep], slots[keep]
            n = len(pfx)
            self.lpm_counts[length] = n
            plane = np.zeros((2, cap), np.uint32)
            plane[0, :] = LPM_PAD
            nc = min(n, cap)
            plane[0, :nc] = pfx[:nc]
            plane[1, :nc] = slots[:nc]
            self.lpm_planes[lpm_field(length)] = plane
            self.lpm_cnt[length] = nc
            self._fib_dirty.add(lpm_field(length))
            b, off, _steps = self._lpm_layout[length]
            if off >= 0:
                bounds = (np.arange((1 << b) + 1, dtype=np.uint64)
                          << (32 - b))
                self.lpm_hint[off:off + (1 << b) + 1] = np.searchsorted(
                    pfx[:nc], bounds).astype(np.int32)
                self._fib_dirty.add("fib_lpm_hint")
        self._fib_dirty.add("fib_lpm_cnt")
        self._lpm_dirty_lens.clear()
        self.lpm_build_ms = (time.perf_counter() - t0) * 1e3

    def lpm_ok(self) -> bool:
        """Whether the LPM planes can serve this staged FIB (allocated,
        and every populated length within its capacity)."""
        if not self.lpm_enabled:
            return False
        self._restage_lpm()
        caps = np.asarray(self.lpm_caps, np.int64)
        return bool((self.lpm_counts <= caps).all())

    def fib_route_count(self) -> int:
        return int(np.count_nonzero(self.fib_plen >= 0))

    # --- NAT ---
    def set_nat_mapping(self, slot: int, ext_ip: int, ext_port: int,
                        proto: int,
                        backends: Sequence[Tuple[int, int, int]],
                        boff: int, self_snat: bool = False) -> None:
        """Install a DNAT mapping with weighted ``(ip, port, weight)``
        backends at ``slot``, placed at ``boff`` in the backend arrays."""
        if boff + len(backends) > self.config.nat_backends:
            raise ValueError("NAT backend arrays full")
        cum = 0
        for j, (bip, bport, w) in enumerate(backends):
            cum += w
            self.natb_ip[boff + j] = bip
            self.natb_port[boff + j] = bport
            self.natb_cumw[boff + j] = cum
        self.nat_ext_ip[slot] = ext_ip
        self.nat_ext_port[slot] = ext_port
        self.nat_proto[slot] = proto
        self.nat_boff[slot] = boff
        self.nat_bcnt[slot] = len(backends)
        self.nat_total_w[slot] = cum
        self.nat_self_snat[slot] = int(self_snat)
        if self._rec is not None:
            self._rec.set_nat_mapping(
                slot, int(ext_ip), int(ext_port), int(proto),
                [(int(a), int(b), int(w)) for a, b, w in backends],
                int(boff), bool(self_snat))
        self._mark("nat")

    def clear_nat(self) -> None:
        self.nat_bcnt[:] = 0
        if self._rec is not None:
            self._rec.clear_nat()
        self._mark("nat")

    def set_snat_ip(self, ip: int) -> None:
        """Set the node's SNAT address (0 disables SNAT)."""
        self.nat_snat_ip = np.uint32(ip)
        if self._rec is not None:
            self._rec.set_snat_ip(int(ip))
        self._mark("nat")

    # --- VXLAN overlay and service VIPs ---
    def set_vtep_ip(self, ip: int) -> None:
        """The node's VTEP address: the decap admission filter and the
        encap outer source (0: unset, any VTEP-addressed frame)."""
        self.ovl_vtep_ip = np.uint32(ip)
        if self._rec is not None:
            self._rec.set_vtep_ip(int(ip))
        self._mark("config")

    def _restage_svc(self) -> None:
        """Compile the service registry into the svc_* planes: VIP rows
        sorted by (ip, port, proto), padding rows all zero with
        ``svc_bk_n`` 0 (they never match)."""
        n_v, n_b = svc_capacity(self.config)
        z = np.zeros
        out = {"svc_vip_ip": z(n_v, np.uint32), "svc_vip_port": z(n_v, np.int32),
               "svc_vip_proto": z(n_v, np.int32),
               "svc_vip_snat": z(n_v, np.int32), "svc_bk_n": z(n_v, np.int32),
               "svc_bk_ip": z((n_v, n_b), np.uint32),
               "svc_bk_port": z((n_v, n_b), np.int32)}
        for r, key in enumerate(sorted(self.services)):
            e = self.services[key]
            out["svc_vip_ip"][r], out["svc_vip_port"][r], \
                out["svc_vip_proto"][r] = key
            out["svc_vip_snat"][r] = int(e["self_snat"])
            out["svc_bk_n"][r] = len(e["members"])
            out["svc_bk_ip"][r] = np.array([m[0] for m in e["assign"]],
                                           np.uint32)
            out["svc_bk_port"][r] = np.array([m[1] for m in e["assign"]],
                                             np.int32)
        self.svc = out

    def set_service(self, vip_ip: int, port: int, proto: int,
                    backends: Sequence[Tuple[int, int, int]],
                    self_snat: bool = False) -> None:
        """Stage (or replace) one service VIP's ``(ip, port, weight)``
        backends. The ways are targeted by weight (largest remainder,
        ties by member order) and filled sticky per service
        (``_assign_ways`` keyed by endpoint, so a weight change alone
        moves nothing it need not). Validated completely before anything
        is staged."""
        c = self.config
        if int(c.svc_vips) <= 0:
            raise ValueError(
                "dataplane.svc_vips is 0 — the svc planes carry "
                "placeholder shapes (raise the knob)")
        n_v, n_b = svc_capacity(c)
        if not 1 <= int(port) <= 65535:
            raise ValueError(
                f"service port must be in 1..65535 (exact match), "
                f"got {port}")
        key = (int(vip_ip) & 0xFFFFFFFF, int(port), int(proto))
        mset, seen = [], set()
        for m in backends:
            bip, bport, w = int(m[0]), int(m[1]), int(m[2])
            if w <= 0:
                raise ValueError(f"backend weight must be > 0, got {w}")
            if (bip, bport) not in seen:
                seen.add((bip, bport))
                mset.append((bip, bport, w))
        if not mset:
            raise ValueError(
                "service needs at least one backend "
                "(del_service removes a VIP)")
        if len(mset) > n_b:
            raise ValueError(
                f"{len(mset)} distinct backends exceed "
                f"svc_backend_ways {n_b}")
        if key not in self.services and len(self.services) >= n_v:
            raise ValueError(
                f"service table full ({n_v} VIP rows — raise "
                f"dataplane.svc_vips)")
        total_w = sum(m[2] for m in mset)
        raw = [n_b * m[2] / total_w for m in mset]
        target = [int(r) for r in raw]
        order = sorted(range(len(mset)),
                       key=lambda i: (-(raw[i] - target[i]), i))
        for i in order[:n_b - sum(target)]:
            target[i] += 1
        prev = self.services.get(key)
        assign = [mset[i] for i in _assign_ways(
            list(prev["assign"]) if prev else [None] * n_b, mset, target,
            key=lambda m: (m[0], m[1]))]
        self.services[key] = {"members": mset, "assign": assign,
                              "self_snat": bool(self_snat)}
        self._restage_svc()
        if self._rec is not None:
            self._rec.set_service(key[0], key[1], key[2],
                                  [list(m) for m in mset],
                                  bool(self_snat))
        self._mark("svc")

    def del_service(self, vip_ip: int, port: int, proto: int) -> bool:
        """Remove one service VIP: new flows to it stop matching, flows
        already translated keep their NAT sessions until they age out."""
        key = (int(vip_ip) & 0xFFFFFFFF, int(port), int(proto))
        if key not in self.services:
            return False
        del self.services[key]
        self._restage_svc()
        if self._rec is not None:
            self._rec.del_service(key[0], key[1], key[2])
        self._mark("svc")
        return True

    def clear_services(self) -> None:
        self.services = {}
        self._restage_svc()
        if self._rec is not None:
            self._rec.clear_services()
        self._mark("svc")

    # --- per-packet ML model (ops/mlscore.py) ---
    def set_ml_model(self, model) -> None:
        """Stage one quantized model (an ``MlModel`` or its dict form)
        for the next epoch. ``_fold_ml`` validates, pads and folds it
        before anything here changes, so a refused model leaves the
        previous one staged."""
        staged, kind = _fold_ml(model, self.config)
        self.ml = staged
        self.ml_kind = kind
        if self._rec is not None:
            self._rec.set_ml_model(model)
        self._mark("ml")

    @property
    def ml_kind_name(self) -> Optional[str]:
        """The staged model's kind, ``"mlp"`` or ``"forest"`` (None: no
        model staged)."""
        from vpp_tpu_torch.ops.mlscore import ML_KIND_NAMES

        return ML_KIND_NAMES.get(self.ml_kind)

    def clear_ml_model(self) -> None:
        """Back to the no-model state (the stage re-gates off at the
        next swap)."""
        self.ml = empty_ml(self.config)
        self.ml_kind = 0
        if self._rec is not None:
            self._rec.clear_ml_model()
        self._mark("ml")

    # --- tenancy (vpp_tpu_torch/tenancy/) ---
    def _restage_tenants(self) -> None:
        """Compile the tenant registry into the tnt_* planes. Session
        and NAT bucket slices are allocated in ascending tenant-id order
        from the TOP of the table downward; unsliced tenants (the
        default tenant 0 among them) share the residual bottom range,
        masked to its largest power of two, so unsliced traffic never
        hashes into a slice. With nothing sliced the residual is the
        whole table (the unsliced hash). The same registry always
        compiles the same arrays."""
        from vpp_tpu_torch.ops.vxlan import DEFAULT_VNI
        from vpp_tpu_torch.tenancy.sched import ML_MODE_CODES

        c = self.config
        n_t, n_s = tnt_capacity(c)
        nbs = {"sess": c.sess_slots // c.sess_ways,
               "nat": natsess_slots_of(c) // c.sess_ways}
        net = np.zeros(n_s, np.uint32)
        mask = np.zeros(n_s, np.uint32)
        pid = np.full(n_s, -1, np.int32)
        rate = np.zeros(n_t, np.int32)
        burst = np.zeros(n_t, np.int32)
        base = {k: np.zeros(n_t, np.int32) for k in nbs}
        bmask = {k: np.zeros(n_t, np.int32) for k in nbs}
        mlm = np.zeros(n_t, np.int32)
        mlt = np.full(n_t, ML_TNT_THRESH_INHERIT, np.int32)
        # tenant t's VNI (-1: none); with tenancy off tenant 0 admits
        # the default VNI, so the single-tenant overlay works unstaged
        vni = np.full(n_t, -1, np.int32)
        if c.tenancy == "off":
            vni[0] = DEFAULT_VNI
        slot = 0
        cursor = dict(nbs)
        sliced = {k: set() for k in nbs}
        for tid in sorted(self.tenants):
            e = self.tenants[tid]
            for p in e["prefixes"]:
                if slot >= n_s:
                    raise ValueError(
                        f"tenant prefix map full ({n_s} slots — raise "
                        f"dataplane.tenancy_prefixes)")
                pnet = ipaddress.ip_network(p, strict=False)
                m = _mask_of(pnet.prefixlen)
                net[slot] = int(pnet.network_address) & m
                mask[slot] = m
                pid[slot] = tid
                slot += 1
            rate[tid] = e["rate"]
            burst[tid] = e["burst"]
            for kind in nbs:
                nbk = e[f"{kind}_buckets"]
                if nbk:
                    cursor[kind] -= nbk
                    base[kind][tid] = cursor[kind]
                    bmask[kind][tid] = nbk - 1
                    sliced[kind].add(tid)
            mlm[tid] = ML_MODE_CODES[e.get("ml_mode", "inherit")]
            if e.get("ml_thresh") is not None:
                mlt[tid] = int(e["ml_thresh"])
            if e.get("vni") is not None:
                vni[tid] = int(e["vni"])
        # unsliced tenants: base 0, the largest power of two inside the
        # residual [0, cursor) (validate_tenancy_config keeps it > 0
        # whenever one exists)
        for kind in nbs:
            free = cursor[kind]
            um = (1 << (free.bit_length() - 1)) - 1 if free > 0 else 0
            for tid in range(n_t):
                if tid not in sliced[kind]:
                    bmask[kind][tid] = um
        self.tnt = {
            "tnt_pfx_net": net, "tnt_pfx_mask": mask, "tnt_pfx_id": pid,
            "tnt_rate": rate, "tnt_burst": burst,
            "tnt_sess_base": base["sess"], "tnt_sess_mask": bmask["sess"],
            "tnt_nat_base": base["nat"], "tnt_nat_mask": bmask["nat"],
            "glb_ml_tnt_mode": mlm, "glb_ml_tnt_thresh": mlt,
            "tnt_vni": vni,
        }

    def _set_tenants(self, merged: Dict[int, dict]) -> None:
        """Validate a whole registry, then stage it (a refused one leaves
        the staging as it was)."""
        from vpp_tpu_torch.tenancy.sched import validate_tenancy_config

        entries = validate_tenancy_config(self.config,
                                          list(merged.values()))
        self.tenants = {e["id"]: e for e in entries}
        self._restage_tenants()

    def set_tenant(self, tid: int, **kw) -> None:
        """Register (or replace) one tenant: ``prefixes``, ``vni``, the
        token bucket (``rate`` tokens a tick, ``burst``), the session /
        NAT slices (``sess_buckets`` / ``nat_buckets``, powers of two; 0
        unsliced), ``weight`` and the ML override (``ml_mode`` /
        ``ml_thresh``). The registry is validated as a whole before
        anything is staged."""
        if self.config.tenancy == "off":
            raise ValueError(
                "dataplane.tenancy is off — set_tenant requires "
                "tenancy: on (the tnt_* planes carry placeholder "
                "shapes otherwise)")
        merged = {t: dict(e) for t, e in self.tenants.items()}
        merged[int(tid)] = {"id": int(tid), **kw}
        self._set_tenants(merged)
        if self._rec is not None:
            self._rec.set_tenant(int(tid), **kw)
        self._mark("tenant")

    def clear_tenants(self) -> None:
        """Back to the single default tenant (everything tenant 0,
        unsliced, unlimited)."""
        self.tenants = {}
        self._restage_tenants()
        if self._rec is not None:
            self._rec.clear_tenants()
        self._mark("tenant")

    def set_tenant_ml(self, tid: int, ml_mode: str = "inherit",
                      ml_thresh: Optional[int] = None) -> None:
        """Change one tenant's ML mode and threshold and nothing else:
        table values only, so a swap replays the captured programs."""
        if int(tid) not in self.tenants:
            raise ValueError(
                f"tenant {tid} not registered (set_tenant first)")
        merged = {t: dict(x) for t, x in self.tenants.items()}
        merged[int(tid)].update(ml_mode=ml_mode, ml_thresh=ml_thresh)
        self._set_tenants(merged)
        if self._rec is not None:
            self._rec.set_tenant_ml(int(tid), ml_mode, ml_thresh)
        self._mark("tenant")

    # --- transactional rollback ---
    # staging-state array attributes (everything a mutator can touch,
    # besides the dict-of-arrays acl / glb and the scalars handled in
    # state_snapshot / state_restore)
    _STATE_ARRAYS = (
        "acl_nrules", "if_type", "if_local_table", "if_apply_global",
        "fib_prefix", "fib_mask", "fib_plen", "fib_tx_if", "fib_disp",
        "fib_next_hop", "fib_node_id", "fib_snat", "fib_grp",
        "fib_grp_nh", "fib_grp_tx_if", "fib_grp_node", "fib_grp_n",
        "lpm_cnt", "lpm_counts", "lpm_hint",
        "nat_ext_ip", "nat_ext_port", "nat_proto", "nat_boff", "nat_bcnt",
        "nat_total_w", "nat_self_snat", "natb_ip", "natb_port",
        "natb_cumw",
    )

    def state_snapshot(self) -> dict:
        """Copy of the whole staged (host) configuration, no device
        state; ``state_restore`` rolls back to it. The lazy LPM staging
        is settled first, so the planes agree with the per-slot rows."""
        self._restage_lpm()
        return {
            "arrays": {k: getattr(self, k).copy()
                       for k in self._STATE_ARRAYS},
            "acl": {k: v.copy() for k, v in self.acl.items()},
            "acl_bv": {k: v.copy() for k, v in self.acl_bv.items()},
            "acl_bv_ok": self.acl_bv_ok.copy(),
            "glb": {k: v.copy() for k, v in self.glb.items()},
            "glb_nrules": self.glb_nrules,
            # replaced wholesale by their mutators, never in place
            "glb_mxu": self.glb_mxu,
            "glb_bv": self.glb_bv,
            "ml": self.ml,
            "ml_kind": self.ml_kind,
            "tnt": self.tnt,
            "tenants": {t: dict(e) for t, e in self.tenants.items()},
            "lpm_planes": {k: v.copy()
                           for k, v in self.lpm_planes.items()},
            "nh_groups": {g: {"members": list(e["members"]),
                              "assign": list(e["assign"])}
                          for g, e in self.nh_groups.items()},
            "nat_snat_ip": self.nat_snat_ip,
            "ovl_vtep_ip": self.ovl_vtep_ip,
            "svc": self.svc,
            "services": {k: {"members": list(e["members"]),
                             "assign": list(e["assign"]),
                             "self_snat": e["self_snat"]}
                         for k, e in self.services.items()},
            "dirty": set(self._dirty),
            "rec_ops": (list(self._rec.ops) if self._rec is not None
                        else None),
        }

    def state_restore(self, snap: dict) -> None:
        """Restore a ``state_snapshot``, writing the staging arrays in
        place. The device may hold the rolled-back commit, so the diff
        bases and the identity caches reset (the next upload of the
        fib, svc and glb groups is whole, every BV plane re-ships), and
        the dirty set is the union of both: a redundant re-upload is
        harmless, a stale tensor is not."""
        for k, v in snap["arrays"].items():
            getattr(self, k)[...] = v
        for k, v in snap["acl"].items():
            self.acl[k][...] = v
        for k, v in snap["acl_bv"].items():
            self.acl_bv[k][...] = v
        self.acl_bv_ok[...] = snap["acl_bv_ok"]
        for k, v in snap["glb"].items():
            self.glb[k][...] = v
        self.glb_nrules = snap["glb_nrules"]
        self.glb_mxu = snap["glb_mxu"]
        self.glb_bv = snap["glb_bv"]
        self.ml = snap["ml"]
        self.ml_kind = snap["ml_kind"]
        self.tnt = snap["tnt"]
        self.tenants = {t: dict(e) for t, e in snap["tenants"].items()}
        for k, v in snap["lpm_planes"].items():
            self.lpm_planes[k][...] = v
        self.nh_groups = {g: {"members": list(e["members"]),
                              "assign": list(e["assign"])}
                          for g, e in snap["nh_groups"].items()}
        self._lpm_dirty_lens = set()
        self._fib_dirty = set(_UPLOAD_GROUPS["fib"])
        self._fib_prev = None
        self._glb_rules_ref = None
        self._glb_rows = None
        self._glb_bad = None
        self._bv_cols = None
        self._bv_dirty = set(_UPLOAD_GROUPS["glb_bv"])
        self.nat_snat_ip = snap["nat_snat_ip"]
        self.ovl_vtep_ip = snap["ovl_vtep_ip"]
        self.svc = snap["svc"]
        self.services = {k: {"members": list(e["members"]),
                             "assign": list(e["assign"]),
                             "self_snat": e["self_snat"]}
                         for k, e in snap["services"].items()}
        self._svc_prev = None
        self._dirty |= set(snap["dirty"])
        if self._rec is not None and snap.get("rec_ops") is not None:
            self._rec.ops[:] = snap["rec_ops"]

    # --- device upload ---
    def host_arrays(self) -> Dict[str, np.ndarray]:
        """The staged configuration as numpy arrays keyed by field name
        (everything except state) — equal to the reference's."""
        self._restage_lpm()
        out = {f"acl_{k}": v for k, v in self.acl.items()}
        out["acl_nrules"] = self.acl_nrules
        for k in ("bnd_src", "bnd_dst", "bnd_sport", "bnd_dport", "nbnd",
                  "src", "dst", "sport", "dport", "proto"):
            out[f"acl_bv_{k}"] = self.acl_bv[k]
        out.update({f"glb_{k}": v for k, v in self.glb.items()})
        out["glb_nrules"] = np.int32(self.glb_nrules)
        bv = self.glb_bv
        for dim in ("src", "dst", "sport", "dport"):
            out[f"glb_bv_bnd_{dim}"] = getattr(bv, f"bnd_{dim}")
            out[f"glb_bv_{dim}"] = getattr(bv, f"bm_{dim}")
        out["glb_bv_nbnd"] = bv.nbnd
        out["glb_bv_proto"] = bv.bm_proto
        out["glb_mxu_coeff"] = self.glb_mxu.coeff
        out["glb_mxu_k"] = self.glb_mxu.k
        out["glb_mxu_act"] = self.glb_mxu.act
        for f in _IF_FIELDS + _FIB_FIELDS[:9]:
            out[f] = getattr(self, f)
        out.update(self.lpm_planes)
        out["fib_lpm_cnt"] = self.lpm_cnt
        out["fib_lpm_hint"] = self.lpm_hint
        for f in ("fib_grp_nh", "fib_grp_tx_if", "fib_grp_node",
                  "fib_grp_n") + _NAT_FIELDS:
            out[f] = getattr(self, f)
        out["sess_max_age"] = np.int32(self.config.sess_max_age)
        out.update(self.ml)
        out.update(self.tnt)
        out.update(self.svc)
        out["ovl_vtep_ip"] = self.ovl_vtep_ip
        return {f: out[f] for f in HOST_FIELDS}

    def to_device(self, sessions=None, into=None) -> DataplaneTables:
        """The next epoch's tables on the builder's device. Only the
        fields of groups mutated since the last call ship (module doc);
        a clean group's tensors are those the last call produced.

        ``sessions`` — the previous epoch's DataplaneTables — hands its
        live state tensors over by reference; a ``{field: numpy}``
        mapping of SESSION_FIELDS (a restored snapshot) is checked
        (``restored_sessions``) and uploaded, the telemetry, tenancy and
        ECMP state starting cold as in the reference; None starts empty.

        ``into`` — the live tables, which this builder produced last —
        asks for every write in place: a dirty field is written into the
        tensor the live tables hold (whole, or by block), so the
        captured step programs (pipeline/capture.py) stay valid. Without
        it a dirty field gets a new tensor and the tables returned
        earlier keep their values."""
        if sessions is not None and not isinstance(sessions, dict):
            state = {f: getattr(sessions, f) for f in STATE_FIELDS}
        else:
            state = zero_state_device(self.config, self.device)
        if isinstance(sessions, dict):
            for f, a in restored_sessions(self.config, sessions).items():
                state[f] = tensor_of(a, self.device)
        host_np = self.host_arrays()
        self._in_place = into is not None
        self._fresh = set()
        self.last_upload = {}
        self.fib_last_shipped = False
        glb_full = False
        for group, fields in _UPLOAD_GROUPS.items():
            dirty = group in self._dirty
            rec = self.last_upload[group] = {"fields": [], "bytes": 0}
            if group == "fib":
                self._upload_fib(host_np, fields, dirty)
            elif group == "svc":
                self._upload_svc(host_np, fields, dirty)
            elif group == "glb_bv":
                for name in fields:
                    if (dirty and name in self._bv_dirty) \
                            or name not in self._dev_cache:
                        self._ship(group, name, host_np[name])
                self._bv_dirty.clear()
            else:
                if group == "glb" and dirty:
                    if self._glb_incremental(host_np):
                        dirty = False
                    else:
                        glb_full = True
                for name in fields:
                    if dirty or name not in self._dev_cache:
                        self._ship(group, name, host_np[name])
                if group == "glb" and (
                        glb_full or "glb_mxu_op" not in self._dev_cache):
                    self._derive("glb_mxu_op", mxu_operand(
                        self._dev_cache)["glb_mxu_op"])
            rec["path"] = ("clean" if not rec["bytes"] else "block"
                           if "blob_bytes" in rec else "full")
        if glb_full:
            # the diff base moves only after every device write succeeded
            self._set_glb_prev(host_np)
        self._dirty.clear()
        host = {f: self._dev_cache[f] for f in HOST_FIELDS}
        derived = {f: self._dev_cache[f] for f in DERIVED_FIELDS}
        return DataplaneTables(**host, **state, **derived)

    # --- the writes ---
    def _held(self, name: str) -> Optional[torch.Tensor]:
        """The tensor a write of ``name`` goes into: the cached one in
        place (``into``), a private copy of it otherwise (made once a
        call), None before the first upload."""
        held = self._dev_cache.get(name)
        if held is None or self._in_place or name in self._fresh:
            return held
        held = self._dev_cache[name] = held.clone()
        self._fresh.add(name)
        return held

    def _ship(self, group: str, name: str, arr) -> None:
        """One field uploaded whole (its bytes charged to ``group``). In
        place on the card it goes through a pinned host buffer and a
        non-blocking copy on the current stream."""
        a = np.asarray(arr)
        a = a if a.dtype in (np.int8, np.float32) else as_i32(a)
        held = self._dev_cache.get(name)
        if (self._in_place and held is not None
                and tuple(held.shape) == a.shape
                and held.dtype == _torch_dtype(a)):
            if self.device.type == "cuda":
                pinned = torch.empty(a.shape, dtype=held.dtype,
                                     pin_memory=True)
                pinned.numpy()[...] = a
                held.copy_(pinned, non_blocking=True)
            else:
                held.copy_(torch.from_numpy(np.array(a, order="C")))
        else:
            self._dev_cache[name] = torch.from_numpy(
                np.array(a, order="C")).to(self.device)
            self._fresh.add(name)
        self._charge(group, a.nbytes, name)

    def _charge(self, group: str, nbytes: int,
                name: Optional[str] = None) -> None:
        rec = self.last_upload[group]
        rec["bytes"] += int(nbytes)
        if name is not None:
            rec["fields"].append(name)
        else:
            rec["blob_bytes"] = rec.get("blob_bytes", 0) + int(nbytes)
        count_device_transfer(group, int(nbytes), "h2d")

    def _derive(self, name: str, new: torch.Tensor) -> None:
        """A derived tensor rebuilt whole, written into the held one."""
        held = self._dev_cache.get(name)
        if (self._in_place and held is not None
                and held.shape == new.shape and held.dtype == new.dtype):
            held.copy_(new)
        else:
            self._dev_cache[name] = new
            self._fresh.add(name)

    def _blob(self, group: str, blob: np.ndarray) -> torch.Tensor:
        """The block blob on the device: one pinned host buffer and one
        non-blocking copy on the current stream (the stream the steps
        run on; the pinned allocator keeps the buffer until the copy is
        done)."""
        src = torch.from_numpy(blob)
        if self.device.type == "cuda":
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            out = pinned.to(self.device, non_blocking=True)
        else:
            out = src.clone()
        self._charge(group, blob.nbytes)
        return out

    def _write_rows(self, fields, blob_t: torch.Tensor, lo: int, w: int,
                    base: int = 0) -> int:
        """Block-write ``[lo, lo + w)`` of each 1-d field from its slice
        of the device blob (int32 bits, viewed as the field's dtype).
        Returns the blob offset after them."""
        for name in fields:
            held = self._held(name)
            held[lo:lo + w].copy_(blob_t[base:base + w].view(held.dtype))
            base += w
        return base

    # --- the global table (row blocks and bit-plane column blocks) ---
    def _set_glb_prev(self, host_np: Dict[str, np.ndarray]) -> None:
        """The glb diff base: the row arrays COPIED (state_restore writes
        them in place), the bit-plane arrays by reference (replaced
        wholesale, never written)."""
        prev = {f: host_np[f].copy() for f in _GLB_ROW_FIELDS}
        for f in ("glb_mxu_coeff", "glb_mxu_k", "glb_mxu_act",
                  "glb_nrules"):
            prev[f] = host_np[f]
        self._glb_prev = prev

    def _glb_incremental(self, host_np: Dict[str, np.ndarray]) -> bool:
        """The glb group by block: diff against the last upload and, when
        the changed rows and the changed bit-plane columns each fit a
        block, ship them as one blob ``[10 x w_r rows | w_c k | w_c act |
        PLANES x w_c coeff]`` and write it into the held tensors, with
        the rows ``[lo_c, lo_c + w_c)`` of ``glb_mxu_op`` rebuilt.
        Returns False for the full upload (no diff base, or a change
        spanning the table). The diff base moves only after the
        writes."""
        prev = self._glb_prev
        if prev is None or any(f not in self._dev_cache
                               for f in _UPLOAD_GROUPS["glb"]
                               + ("glb_mxu_op",)):
            return False
        n_rows = host_np["glb_action"].shape[0]
        n_cols = host_np["glb_mxu_k"].shape[0]
        changed_r = np.zeros(n_rows, bool)
        for f in _GLB_ROW_FIELDS:
            changed_r |= prev[f] != host_np[f]
        changed_c = ((prev["glb_mxu_k"] != host_np["glb_mxu_k"])
                     | (prev["glb_mxu_act"] != host_np["glb_mxu_act"])
                     | np.any(prev["glb_mxu_coeff"]
                              != host_np["glb_mxu_coeff"], axis=0))
        blk_r = _block_of(changed_r, n_rows)
        blk_c = _block_of(changed_c, n_cols)
        if blk_r is None and blk_c is None:
            # content-identical commit: only the rule count may differ
            if int(prev["glb_nrules"]) != int(host_np["glb_nrules"]):
                self._ship("glb", "glb_nrules", host_np["glb_nrules"])
            self._set_glb_prev(host_np)
            return True
        lo_r, w_r = blk_r or (0, min(256, n_rows))
        lo_c, w_c = blk_c or (0, min(256, n_cols))
        if w_r >= n_rows or w_c >= n_cols:
            return False  # the change spans the table: ship it whole
        blob = np.empty(10 * w_r + 2 * w_c + PLANES * w_c, np.int32)
        for i, f in enumerate(_GLB_ROW_FIELDS):
            blob[i * w_r:(i + 1) * w_r] = \
                host_np[f][lo_r:lo_r + w_r].view(np.int32)
        base = 10 * w_r
        blob[base:base + w_c] = \
            host_np["glb_mxu_k"][lo_c:lo_c + w_c].view(np.int32)
        blob[base + w_c:base + 2 * w_c] = \
            host_np["glb_mxu_act"][lo_c:lo_c + w_c]
        blob[base + 2 * w_c:] = np.ascontiguousarray(
            host_np["glb_mxu_coeff"][:, lo_c:lo_c + w_c]
        ).reshape(-1).view(np.int32)
        blob_t = self._blob("glb", blob)
        self._write_rows(_GLB_ROW_FIELDS, blob_t, lo_r, w_r)
        self._write_rows(("glb_mxu_k", "glb_mxu_act"), blob_t, lo_c, w_c,
                         base)
        coeff = blob_t[base + 2 * w_c:].view(torch.float32).reshape(
            PLANES, w_c)
        self._held("glb_mxu_coeff")[:, lo_c:lo_c + w_c].copy_(coeff)
        self._held("glb_mxu_op")[lo_c:lo_c + w_c].copy_(mxu_operand_block(
            coeff, blob_t[base:base + w_c].view(torch.float32), lo_c))
        self._ship("glb", "glb_nrules", host_np["glb_nrules"])
        self._set_glb_prev(host_np)
        return True

    # --- the FIB (per-length planes and the per-slot row block) ---
    def _upload_fib(self, host_np: Dict[str, np.ndarray],
                    fields: Tuple[str, ...], dirty: bool) -> None:
        """The "fib" group: the per-slot rows by block when the changes
        confine to one (``_fib_incremental``), every other field whole
        when ``_fib_dirty`` names it; the LPM stack's rows of the
        re-shipped planes (and its counts) rebuilt on the device. Records
        ``fib_upload``."""
        t0 = time.perf_counter()
        shipped = []
        blob_bytes = None
        if dirty:
            blob_bytes = self._fib_incremental(host_np)
        for name in fields:
            if name in _FIB_SLOT_FIELDS and blob_bytes is not None:
                continue
            if (dirty and name in self._fib_dirty) \
                    or name not in self._dev_cache:
                self._ship("fib", name, host_np[name])
                shipped.append(name)
        if "fib_lpm_stk_pfx" not in self._dev_cache:
            for f, t in build_lpm_stack(self._dev_cache).items():
                self._derive(f, t)
        else:
            lengths = [L for L in range(len(LPM_FIELDS))
                       if lpm_field(L) in shipped]
            if lengths or "fib_lpm_cnt" in shipped:
                update_lpm_stack(
                    {f: self._held(f) for f in DERIVED_FIELDS
                     if DERIVED_GROUPS[f] == "fib"},
                    self._dev_cache, lengths, "fib_lpm_cnt" in shipped)
        if dirty and blob_bytes is None:
            self._set_fib_prev(host_np)
        if dirty:
            self.fib_last_shipped = True
            self.fib_upload = {
                "fields": tuple(shipped),
                "blob_bytes": int(blob_bytes or 0),
                "bytes": int(sum(host_np[f].nbytes for f in shipped)
                             + (blob_bytes or 0)),
                "ms": (time.perf_counter() - t0) * 1e3,
            }
            self._fib_dirty.clear()

    def _set_fib_prev(self, host_np: Dict[str, np.ndarray]) -> None:
        """The per-slot diff base (COPIES: state_restore writes the
        staging in place)."""
        self._fib_prev = {f: host_np[f].copy() for f in _FIB_SLOT_FIELDS}

    def _fib_incremental(self, host_np: Dict[str, np.ndarray]):
        """The per-slot FIB rows by block: when the changes against the
        last upload confine to a block, one blob ``[9 x w]`` written into
        the held tensors. Returns its bytes (0: nothing changed), or
        None for the whole upload. The diff base moves only after the
        writes."""
        prev = self._fib_prev
        if prev is None or any(f not in self._dev_cache
                               for f in _FIB_SLOT_FIELDS):
            return None
        n = host_np["fib_plen"].shape[0]
        changed = np.zeros(n, bool)
        for f in _FIB_SLOT_FIELDS:
            changed |= prev[f] != host_np[f]
        blk = _block_of(changed, n)
        if blk is None:
            return 0
        lo, w = blk
        if w >= n:
            return None
        blob = np.empty(len(_FIB_SLOT_FIELDS) * w, np.int32)
        for i, f in enumerate(_FIB_SLOT_FIELDS):
            blob[i * w:(i + 1) * w] = host_np[f][lo:lo + w].view(np.int32)
        self._write_rows(_FIB_SLOT_FIELDS, self._blob("fib", blob), lo, w)
        self._set_fib_prev(host_np)
        return blob.nbytes

    # --- the service planes (VIP-row blocks) ---
    def _upload_svc(self, host_np: Dict[str, np.ndarray],
                    fields: Tuple[str, ...], dirty: bool) -> None:
        """The "svc" group: the changed VIP rows by block
        (``_svc_incremental``), else every field whole. Records
        ``svc_upload``."""
        t0 = time.perf_counter()
        shipped = []
        blob_bytes = None
        if dirty:
            blob_bytes = self._svc_incremental(host_np)
        for name in fields:
            if blob_bytes is not None:
                continue
            if dirty or name not in self._dev_cache:
                self._ship("svc", name, host_np[name])
                shipped.append(name)
        if dirty and blob_bytes is None:
            self._set_svc_prev(host_np)
        if dirty:
            self.svc_upload = {
                "fields": tuple(shipped),
                "blob_bytes": int(blob_bytes or 0),
                "bytes": int(sum(host_np[f].nbytes for f in shipped)
                             + (blob_bytes or 0)),
                "ms": (time.perf_counter() - t0) * 1e3,
            }

    def _set_svc_prev(self, host_np: Dict[str, np.ndarray]) -> None:
        """The svc diff base (references: _restage_svc replaces the
        staging arrays wholesale)."""
        self._svc_prev = {f: host_np[f]
                          for f in _SVC_1D_FIELDS + _SVC_2D_FIELDS}

    def _svc_incremental(self, host_np: Dict[str, np.ndarray]):
        """The service planes by VIP-row block (widths 8, 32, ...): one
        blob ``[5 x w | 2 x w x B]`` written into the held tensors.
        Returns its bytes (0: nothing changed), or None for the whole
        upload."""
        prev = self._svc_prev
        all_fields = _SVC_1D_FIELDS + _SVC_2D_FIELDS
        if prev is None or any(f not in self._dev_cache
                               for f in all_fields):
            return None
        n_v, n_b = host_np["svc_bk_ip"].shape
        changed = np.zeros(n_v, bool)
        for f in _SVC_1D_FIELDS:
            changed |= prev[f] != host_np[f]
        for f in _SVC_2D_FIELDS:
            changed |= np.any(prev[f] != host_np[f], axis=1)
        idx = np.nonzero(changed)[0]
        if len(idx) == 0:
            return 0
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        w = 8
        while w < hi - lo:
            w *= 4
        if w >= n_v:
            return None
        lo = min(lo, n_v - w)
        n1 = len(_SVC_1D_FIELDS)
        blob = np.empty(n1 * w + len(_SVC_2D_FIELDS) * w * n_b, np.int32)
        for i, f in enumerate(_SVC_1D_FIELDS):
            blob[i * w:(i + 1) * w] = host_np[f][lo:lo + w].view(np.int32)
        base = n1 * w
        for i, f in enumerate(_SVC_2D_FIELDS):
            blob[base + i * w * n_b:base + (i + 1) * w * n_b] = \
                np.ascontiguousarray(
                    host_np[f][lo:lo + w]).reshape(-1).view(np.int32)
        blob_t = self._blob("svc", blob)
        base = self._write_rows(_SVC_1D_FIELDS, blob_t, lo, w)
        for f in _SVC_2D_FIELDS:
            self._held(f)[lo:lo + w].copy_(
                blob_t[base:base + w * n_b].reshape(w, n_b))
            base += w * n_b
        self._set_svc_prev(host_np)
        return blob.nbytes

