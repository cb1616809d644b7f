"""Device-resident table state + host-side table compiler.

The PyTorch counterpart of ``vpp_tpu/pipeline/tables.py``: the same
``DataplaneConfig`` knobs, the same ``DataplaneTables`` field names and
host layouts (``TableBuilder.host_arrays()`` equals the reference's,
field by field), loaded into torch tensors on the builder's device.
uint32 fields are int32 tensors holding the same bits
(pipeline/vector.py).

Cut to the main path: every ``to_device`` is a full upload (the
reference's incremental upload groups are a later slice, ROADMAP Queue
1 item 8). The ML planes are staged at the configured capacity
(``ml_capacity``, ``set_ml_model``), the telemetry planes take their
configured shapes (``tel_capacity``), and the tenant, service-VIP and
ECMP planes theirs (``tnt_capacity``, ``svc_capacity``,
``ecmp_capacity``), as in the reference: a tenant registry
(``set_tenant``) and a service registry (``set_service``) are compiled
into their planes by ``_restage_tenants`` / ``_restage_svc``, with the
reference's slice allocation and sticky weighted way fill. The global
table's MXU bit-planes are compiled in full at every
``set_global_table`` (the reference diffs rule identities and
recompiles only the changed columns; that joins the incremental upload
groups).

Derived tensors, built ONCE per swap by ``to_device``: the populated LPM
planes stacked into the biased ``[L, Npad]`` prefix and slot matrices
the fused LPM kernel walks (``fib_lpm_stk_*`` — the reference rebuilds
them inside every traced step, vpp_tpu/ops/lpm.py
``_fib_lookup_lpm_pallas``), and the MXU coefficients and ``k`` as the
rule-major int8 ``[R', 128]`` operand ``mxu_first_match`` reads, laid
out as its shared-memory tiles (``glb_mxu_op``, ops/acl_mxu.py
``mxu_operand`` — the reference casts float32 to bf16 inside every
call, vpp_tpu/ops/acl_mxu.py ``mxu_first_match``).
"""

from __future__ import annotations

import ipaddress
import logging
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
    compile_bitplanes_full,
    empty_bitplanes,
    mxu_operand,
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
)
from vpp_tpu_torch.ops.mlscore import ML_TNT_THRESH_INHERIT
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


class InterfaceType:
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
    if not n:
        return out
    rows = np.array([_rule_row(r) for r in rules], np.int64)
    for j, arr in enumerate(out.values()):
        arr[:n] = rows[:, j].astype(arr.dtype)
    return out


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
        self._bv_cols = None
        # opt-out of the bit-plane compile, the reference's default on
        self.mxu_enabled = True
        self.glb_mxu = empty_bitplanes(c.max_global_rules)
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

    def clear_local_table(self, slot: int) -> None:
        self.set_local_table(slot, [])

    def set_global_table(self, rules: Sequence[ContivRule]) -> None:
        cap = self.config.max_global_rules
        packed = pack_rules(rules, cap)
        self.glb_mxu = (compile_bitplanes_full(packed, cap)[0]
                        if self.mxu_enabled else empty_bitplanes(cap))
        if self.bv_enabled:
            # per-dimension incremental: planes whose intervals did not
            # move since the last commit are carried over
            self.glb_bv, self._bv_cols, _ = compile_bv(
                packed, cap, prev=self.glb_bv, prev_cols=self._bv_cols)
        self.glb = packed
        self.glb_nrules = len(rules)

    # --- interfaces ---
    def set_interface(self, if_index: int, if_type: int,
                      local_table: int = -1,
                      apply_global: bool = False) -> None:
        self.if_type[if_index] = int(if_type)
        self.if_local_table[if_index] = local_table
        self.if_apply_global[if_index] = int(apply_global)

    def set_if_local_table(self, if_index: int, slot: int) -> None:
        self.if_local_table[if_index] = slot

    # --- FIB ---
    def _mark_fib_lengths(self, *plens: int) -> None:
        if self.lpm_enabled:
            self._lpm_dirty_lens.update(
                int(p) for p in plens if 0 <= p <= 32)

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
        self._mark_fib_lengths(old_plen, net.prefixlen)
        return slot

    def del_route(self, prefix: str) -> bool:
        net = ipaddress.ip_network(prefix)
        mask = _mask_of(net.prefixlen)
        want = int(net.network_address) & mask
        hit = np.nonzero((self.fib_plen == net.prefixlen)
                         & (self.fib_prefix == want))[0]
        if len(hit) == 0:
            return False
        self.fib_plen[hit[0]] = -1
        self._mark_fib_lengths(net.prefixlen)
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
        return True

    def _restage_lpm(self) -> None:
        """Recompile the dirty per-length LPM planes: each length's
        slots sorted by prefix, the LOWEST slot kept per duplicate
        prefix (the dense lookup's tie-break), plus its stride hint
        rows (ops/lpm.py lpm_hint_layout)."""
        if not self._lpm_dirty_lens or not self.lpm_enabled:
            self._lpm_dirty_lens.clear()
            return
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
            b, off, _steps = self._lpm_layout[length]
            if off >= 0:
                bounds = (np.arange((1 << b) + 1, dtype=np.uint64)
                          << (32 - b))
                self.lpm_hint[off:off + (1 << b) + 1] = np.searchsorted(
                    pfx[:nc], bounds).astype(np.int32)
        self._lpm_dirty_lens.clear()

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

    def clear_nat(self) -> None:
        self.nat_bcnt[:] = 0

    def set_snat_ip(self, ip: int) -> None:
        """Set the node's SNAT address (0 disables SNAT)."""
        self.nat_snat_ip = np.uint32(ip)

    # --- VXLAN overlay and service VIPs ---
    def set_vtep_ip(self, ip: int) -> None:
        """The node's VTEP address: the decap admission filter and the
        encap outer source (0: unset, any VTEP-addressed frame)."""
        self.ovl_vtep_ip = np.uint32(ip)

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

    def del_service(self, vip_ip: int, port: int, proto: int) -> bool:
        """Remove one service VIP: new flows to it stop matching, flows
        already translated keep their NAT sessions until they age out."""
        key = (int(vip_ip) & 0xFFFFFFFF, int(port), int(proto))
        if key not in self.services:
            return False
        del self.services[key]
        self._restage_svc()
        return True

    def clear_services(self) -> None:
        self.services = {}
        self._restage_svc()

    # --- per-packet ML model (ops/mlscore.py) ---
    def set_ml_model(self, model) -> None:
        """Stage one quantized model (an ``MlModel`` or its dict form)
        for the next epoch. ``_fold_ml`` validates, pads and folds it
        before anything here changes, so a refused model leaves the
        previous one staged."""
        staged, kind = _fold_ml(model, self.config)
        self.ml = staged
        self.ml_kind = kind

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

    def clear_tenants(self) -> None:
        """Back to the single default tenant (everything tenant 0,
        unsliced, unlimited)."""
        self.tenants = {}
        self._restage_tenants()

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
        """The next epoch's tables on the builder's device (a full
        upload of the staged arrays). ``sessions`` — the previous
        epoch's DataplaneTables — hands its live state tensors over by
        reference; a ``{field: numpy}`` mapping of SESSION_FIELDS (a
        restored snapshot) is uploaded; None starts empty.

        ``into`` — the live DataplaneTables — refreshes its tensors IN
        PLACE: every staged or derived field whose shape and dtype are
        unchanged is written into the tensor ``into`` holds (``copy_``),
        so a captured step (pipeline/capture.py), which holds their
        addresses, stays valid; a field whose shape or dtype changed
        gets a new tensor (and the tables' signature, a new program)."""
        state = zero_state_device(self.config, self.device)
        if isinstance(sessions, dict):
            shapes = state_shapes(self.config)
            for f in SESSION_FIELDS:
                arr = np.asarray(sessions[f])
                if tuple(arr.shape) != shapes[f]:
                    raise ValueError(
                        f"restored session field {f!r} shape "
                        f"{tuple(arr.shape)} != configured {shapes[f]}")
                state[f] = tensor_of(arr, self.device)
        elif sessions is not None:
            state = {f: getattr(sessions, f) for f in STATE_FIELDS}
        host = {f: tensor_of(a, self.device)
                for f, a in self.host_arrays().items()}
        derived = derive(host)
        if into is not None:
            host, derived = (
                {f: _refresh(getattr(into, f), t) for f, t in d.items()}
                for d in (host, derived))
        return DataplaneTables(**host, **state, **derived)


def _refresh(held: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``held`` with ``new``'s contents where the two agree in shape and
    dtype (written in place), else ``new``."""
    if held.shape != new.shape or held.dtype != new.dtype:
        return new
    return held.copy_(new)
