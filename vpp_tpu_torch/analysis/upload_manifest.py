"""The upload manifest: how each ``DataplaneTables`` field ships, which
``TableBuilder`` attributes stage which group, and which builder methods
the mark dataflow leaves out — the reviewed source of truth the
``--uploads`` pass (uploadlint.py) holds ``vpp_tpu_torch/pipeline/
tables.py`` to. A field added without a decision on how it ships is a
finding: the failure is otherwise silent, a stale device plane (staged,
never re-shipped) or a whole-table upload at every swap.

* ``FIELD_PLACEMENTS``: every field -> exactly one placement:
  ``group:<name>`` (an ``_UPLOAD_GROUPS`` entry re-ships it when the
  group is dirty), ``ledger:<NAME>`` (state carried across swaps by
  reference: sessions, telemetry, tenancy state, ECMP counters; never
  re-staged from the host) or ``derived:<group>`` (rebuilt on the device
  from a group's fields when that group ships: the LPM stack the fused
  LPM kernel walks, the int8 operand of ``mxu_first_match``;
  ``DERIVED_GROUPS``).
* ``STAGED_ATTRS``: builder attribute -> its upload group. A mutator that
  writes one must mark the group on every path that does not raise.
  Host-only metadata (caches, diff bases, timings) is absent: writing it
  cannot stale a device plane.
* ``EXEMPT_METHODS``: builder methods the mark dataflow leaves out, each
  with the invariant that makes it sound.
"""

from typing import Dict

# --- field -> placement (generated from tables.py, then reviewed) ---------
# In TABLE_FIELDS order.
FIELD_PLACEMENTS: Dict[str, str] = {
    "acl_src_net": "group:acl",
    "acl_src_mask": "group:acl",
    "acl_dst_net": "group:acl",
    "acl_dst_mask": "group:acl",
    "acl_proto": "group:acl",
    "acl_sport_lo": "group:acl",
    "acl_sport_hi": "group:acl",
    "acl_dport_lo": "group:acl",
    "acl_dport_hi": "group:acl",
    "acl_action": "group:acl",
    "acl_nrules": "group:acl",
    "acl_bv_bnd_src": "group:acl",
    "acl_bv_bnd_dst": "group:acl",
    "acl_bv_bnd_sport": "group:acl",
    "acl_bv_bnd_dport": "group:acl",
    "acl_bv_nbnd": "group:acl",
    "acl_bv_src": "group:acl",
    "acl_bv_dst": "group:acl",
    "acl_bv_sport": "group:acl",
    "acl_bv_dport": "group:acl",
    "acl_bv_proto": "group:acl",
    "glb_src_net": "group:glb",
    "glb_src_mask": "group:glb",
    "glb_dst_net": "group:glb",
    "glb_dst_mask": "group:glb",
    "glb_proto": "group:glb",
    "glb_sport_lo": "group:glb",
    "glb_sport_hi": "group:glb",
    "glb_dport_lo": "group:glb",
    "glb_dport_hi": "group:glb",
    "glb_action": "group:glb",
    "glb_nrules": "group:glb",
    "glb_mxu_coeff": "group:glb",
    "glb_mxu_k": "group:glb",
    "glb_mxu_act": "group:glb",
    "glb_bv_bnd_src": "group:glb_bv",
    "glb_bv_bnd_dst": "group:glb_bv",
    "glb_bv_bnd_sport": "group:glb_bv",
    "glb_bv_bnd_dport": "group:glb_bv",
    "glb_bv_nbnd": "group:glb_bv",
    "glb_bv_src": "group:glb_bv",
    "glb_bv_dst": "group:glb_bv",
    "glb_bv_sport": "group:glb_bv",
    "glb_bv_dport": "group:glb_bv",
    "glb_bv_proto": "group:glb_bv",
    "glb_ml_w1": "group:ml",
    "glb_ml_b1": "group:ml",
    "glb_ml_s1": "group:ml",
    "glb_ml_w2": "group:ml",
    "glb_ml_b2": "group:ml",
    "glb_ml_f_feat": "group:ml",
    "glb_ml_f_thresh": "group:ml",
    "glb_ml_f_leaf": "group:ml",
    "glb_ml_thresh": "group:ml",
    "glb_ml_action": "group:ml",
    "glb_ml_rl_shift": "group:ml",
    "glb_ml_version": "group:ml",
    "tnt_pfx_net": "group:tenant",
    "tnt_pfx_mask": "group:tenant",
    "tnt_pfx_id": "group:tenant",
    "tnt_rate": "group:tenant",
    "tnt_burst": "group:tenant",
    "tnt_sess_base": "group:tenant",
    "tnt_sess_mask": "group:tenant",
    "tnt_nat_base": "group:tenant",
    "tnt_nat_mask": "group:tenant",
    "glb_ml_tnt_mode": "group:tenant",
    "glb_ml_tnt_thresh": "group:tenant",
    "tnt_vni": "group:tenant",
    "if_type": "group:if",
    "if_local_table": "group:if",
    "if_apply_global": "group:if",
    "fib_prefix": "group:fib",
    "fib_mask": "group:fib",
    "fib_plen": "group:fib",
    "fib_tx_if": "group:fib",
    "fib_disp": "group:fib",
    "fib_next_hop": "group:fib",
    "fib_node_id": "group:fib",
    "fib_snat": "group:fib",
    "fib_grp": "group:fib",
    "fib_lpm_p0": "group:fib",
    "fib_lpm_p1": "group:fib",
    "fib_lpm_p2": "group:fib",
    "fib_lpm_p3": "group:fib",
    "fib_lpm_p4": "group:fib",
    "fib_lpm_p5": "group:fib",
    "fib_lpm_p6": "group:fib",
    "fib_lpm_p7": "group:fib",
    "fib_lpm_p8": "group:fib",
    "fib_lpm_p9": "group:fib",
    "fib_lpm_p10": "group:fib",
    "fib_lpm_p11": "group:fib",
    "fib_lpm_p12": "group:fib",
    "fib_lpm_p13": "group:fib",
    "fib_lpm_p14": "group:fib",
    "fib_lpm_p15": "group:fib",
    "fib_lpm_p16": "group:fib",
    "fib_lpm_p17": "group:fib",
    "fib_lpm_p18": "group:fib",
    "fib_lpm_p19": "group:fib",
    "fib_lpm_p20": "group:fib",
    "fib_lpm_p21": "group:fib",
    "fib_lpm_p22": "group:fib",
    "fib_lpm_p23": "group:fib",
    "fib_lpm_p24": "group:fib",
    "fib_lpm_p25": "group:fib",
    "fib_lpm_p26": "group:fib",
    "fib_lpm_p27": "group:fib",
    "fib_lpm_p28": "group:fib",
    "fib_lpm_p29": "group:fib",
    "fib_lpm_p30": "group:fib",
    "fib_lpm_p31": "group:fib",
    "fib_lpm_p32": "group:fib",
    "fib_lpm_cnt": "group:fib",
    "fib_lpm_hint": "group:fib",
    "fib_grp_nh": "group:fib",
    "fib_grp_tx_if": "group:fib",
    "fib_grp_node": "group:fib",
    "fib_grp_n": "group:fib",
    "sess_max_age": "group:config",
    "nat_ext_ip": "group:nat",
    "nat_ext_port": "group:nat",
    "nat_proto": "group:nat",
    "nat_boff": "group:nat",
    "nat_bcnt": "group:nat",
    "nat_total_w": "group:nat",
    "nat_self_snat": "group:nat",
    "natb_ip": "group:nat",
    "natb_port": "group:nat",
    "natb_cumw": "group:nat",
    "nat_snat_ip": "group:nat",
    "ovl_vtep_ip": "group:config",
    "svc_vip_ip": "group:svc",
    "svc_vip_port": "group:svc",
    "svc_vip_proto": "group:svc",
    "svc_vip_snat": "group:svc",
    "svc_bk_n": "group:svc",
    "svc_bk_ip": "group:svc",
    "svc_bk_port": "group:svc",
    "sess_src": "ledger:SESSION_FIELDS",
    "sess_dst": "ledger:SESSION_FIELDS",
    "sess_ports": "ledger:SESSION_FIELDS",
    "sess_proto": "ledger:SESSION_FIELDS",
    "sess_valid": "ledger:SESSION_FIELDS",
    "sess_time": "ledger:SESSION_FIELDS",
    "natsess_a": "ledger:SESSION_FIELDS",
    "natsess_b": "ledger:SESSION_FIELDS",
    "natsess_ports": "ledger:SESSION_FIELDS",
    "natsess_proto": "ledger:SESSION_FIELDS",
    "natsess_valid": "ledger:SESSION_FIELDS",
    "natsess_time": "ledger:SESSION_FIELDS",
    "natsess_orig_ip": "ledger:SESSION_FIELDS",
    "natsess_orig_port": "ledger:SESSION_FIELDS",
    "natsess_src_ip": "ledger:SESSION_FIELDS",
    "natsess_sport": "ledger:SESSION_FIELDS",
    "natsess_kind": "ledger:SESSION_FIELDS",
    "sess_sweep_cursor": "ledger:SESSION_FIELDS",
    "natsess_sweep_cursor": "ledger:SESSION_FIELDS",
    "tel_lat_hist": "ledger:TELEMETRY_FIELDS",
    "tel_sketch": "ledger:TELEMETRY_FIELDS",
    "tel_sketched": "ledger:TELEMETRY_FIELDS",
    "tel_top_key": "ledger:TELEMETRY_FIELDS",
    "tel_top_src": "ledger:TELEMETRY_FIELDS",
    "tel_top_dst": "ledger:TELEMETRY_FIELDS",
    "tel_top_ports": "ledger:TELEMETRY_FIELDS",
    "tel_top_cnt": "ledger:TELEMETRY_FIELDS",
    "tnt_tokens": "ledger:TENANCY_STATE_FIELDS",
    "tnt_tok_time": "ledger:TENANCY_STATE_FIELDS",
    "tnt_rx_c": "ledger:TENANCY_STATE_FIELDS",
    "tnt_tx_c": "ledger:TENANCY_STATE_FIELDS",
    "tnt_rl_c": "ledger:TENANCY_STATE_FIELDS",
    "tnt_qf_c": "ledger:TENANCY_STATE_FIELDS",
    "fib_ecmp_c": "ledger:FIB_STATE_FIELDS",
    "fib_lpm_lens": "derived:fib",
    "fib_lpm_stk_cnt": "derived:fib",
    "fib_lpm_stk_pfx": "derived:fib",
    "fib_lpm_stk_slot": "derived:fib",
    "glb_mxu_op": "derived:glb",
}

# --- builder attribute -> upload group -------------------------------------
STAGED_ATTRS: Dict[str, str] = {
    # acl: the per-table rule columns and their compiled bit-planes
    "acl": "acl",
    "acl_nrules": "acl",
    "acl_bv": "acl",
    "acl_bv_ok": "acl",
    # glb: the packed global rule columns and the MXU coefficients
    "glb": "glb",
    "glb_nrules": "glb",
    "glb_mxu": "glb",
    # glb_bv: the compiled global bit-vector planes
    "glb_bv": "glb_bv",
    # ml: the model planes and their kind
    "ml": "ml",
    "ml_kind": "ml",
    # tenant: the registry and its compiled planes
    "tenants": "tenant",
    "tnt": "tenant",
    # if: interface types and table bindings
    "if_type": "if",
    "if_local_table": "if",
    "if_apply_global": "if",
    # fib: the route slots, the ECMP groups and the LPM restage
    "fib_prefix": "fib",
    "fib_plen": "fib",
    "fib_mask": "fib",
    "fib_next_hop": "fib",
    "fib_tx_if": "fib",
    "fib_node_id": "fib",
    "fib_disp": "fib",
    "fib_snat": "fib",
    "fib_grp": "fib",
    "nh_groups": "fib",
    "fib_grp_nh": "fib",
    "fib_grp_tx_if": "fib",
    "fib_grp_node": "fib",
    "fib_grp_n": "fib",
    "lpm_planes": "fib",
    "lpm_cnt": "fib",
    "lpm_counts": "fib",
    "lpm_hint": "fib",
    # nat: the static mappings, the backend pools, the SNAT address
    "nat_proto": "nat",
    "nat_ext_ip": "nat",
    "nat_ext_port": "nat",
    "nat_boff": "nat",
    "nat_bcnt": "nat",
    "nat_total_w": "nat",
    "nat_self_snat": "nat",
    "natb_ip": "nat",
    "natb_port": "nat",
    "natb_cumw": "nat",
    "nat_snat_ip": "nat",
    # config: the scalars that ship with the config group
    "ovl_vtep_ip": "config",
    # svc: the service registry and its compiled planes
    "services": "svc",
    "svc": "svc",
}

# --- methods the mark dataflow leaves out ----------------------------------
EXEMPT_METHODS: Dict[str, str] = {
    "state_snapshot": (
        "reads the staging (after settling the lazy LPM restage); it "
        "stales nothing"),
    "_restage_lpm": (
        "the lazy LPM restage runs only with 'fib' already dirty: "
        "_mark_fib_slots adds the length to _lpm_dirty_lens and marks "
        "'fib' together, and state_restore empties the set, so the group "
        "mark happened at the add_route / del_route that queued it"),
    "state_restore": (
        "the rollback: both callers (txn.apply_txn, the CLI's config "
        "replay) snapshot and restore under the dataplane's commit lock, "
        "before the aborted commit's swap, so no to_device runs between "
        "and _dirty only grew since the snapshot; the union with the "
        "snapshot's dirty set, the whole fib / glb_bv re-dirty and the "
        "reset diff bases cover every group whose staging can differ from "
        "the device"),
}
