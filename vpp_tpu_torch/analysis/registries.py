"""The registry passes, which import the port itself (and nothing of the
reference): ``--kernels`` holds ``capture_manifest.KERNELS`` against the
tree, ``--tables`` the table builder's compiled structures against their
invariants.

The metrics and counter-parity passes of the reference are held on the
port by tests/test_torch_stats.py (the reference's exposition tests bound
to the port), so they are not repeated here.
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path
from typing import List, Optional

from vpp_tpu_torch.analysis.common import REPO, SourceCache, iter_source_files

_SMALL = dict(max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
              fib_slots=16, sess_slots=64, nat_mappings=2, nat_backends=4)
MESH_MODES = ("refused", "runs", "sharded-plain")


def _def_of(cache: SourceCache, repo: Path, rel: str, qual: str):
    """The def ``qual`` (dotted) of ``rel``, or None."""
    tree = cache.get(rel, repo / rel).tree
    node = tree
    for part in qual.split("."):
        node = next((n for n in getattr(node, "body", [])
                     if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                     and n.name == part), None)
        if node is None:
            return None
    return node


def _mentions(node, name: str) -> bool:
    return any((isinstance(n, ast.Name) and n.id == name)
               or (isinstance(n, ast.Attribute) and n.attr == name)
               for n in ast.walk(node))


def library_call_sites(repo: Path, cache: SourceCache):
    """(path, enclosing function, library, symbol, line) of every
    ``_cuda.library("<name>").<symbol>`` of the package with a literal
    name."""
    out = []
    for rel, path in iter_source_files(repo, ("vpp_tpu_torch",)):
        tree = cache.get(rel, path).tree
        if tree is None:
            continue

        def scan(node, fn):
            for child in ast.iter_child_nodes(node):
                inner = child.name if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
                if isinstance(child, ast.Attribute) and \
                        isinstance(child.value, ast.Call):
                    call = child.value
                    f = call.func
                    if isinstance(f, ast.Attribute) and \
                            f.attr == "library" and call.args and \
                            isinstance(call.args[0], ast.Constant) and \
                            isinstance(call.args[0].value, str):
                        out.append((rel, fn, call.args[0].value, child.attr,
                                    child.lineno))
                scan(child, inner)

        scan(tree, None)
    return out


def kernels_lint(repo=None, manifest=None,
                 cache: Optional[SourceCache] = None) -> List[str]:
    """The ``--kernels`` pass: every ``KERNELS`` entry against the tree
    (its source, library call, wrapper, plain version, dispatch root,
    knob and rung, fields and their partition rules, and what a
    rule-sharded mesh does with its knob), every ``csrc/*.cu`` against
    the entries, and ``capture.WRAPPERS`` against the wrappers. Returns
    problems (empty == clean)."""
    repo = Path(repo or REPO)
    cache = cache or SourceCache()
    if manifest is None:
        from vpp_tpu_torch.analysis import capture_manifest as manifest
    from vpp_tpu_torch.parallel.partition import (
        PartitionError,
        spec_for,
        validate_partitioning,
    )
    from vpp_tpu_torch.pipeline import capture
    from vpp_tpu_torch.pipeline.dataplane import Dataplane
    from vpp_tpu_torch.pipeline.tables import (
        DataplaneConfig,
        DataplaneTables,
        validate_dataplane_config,
    )

    kernels = manifest.KERNELS
    problems: List[str] = []
    wrappers = []
    dp = Dataplane(DataplaneConfig(**_SMALL), device="cpu")
    for name, e in kernels.items():
        where = f"kernels: {name}"
        src = repo / e["source"]
        if not src.is_file():
            problems.append(f"{where}: source {e['source']} is missing")
        elif Path(e["source"]).stem != e["library"]:
            problems.append(f"{where}: library {e['library']!r} is not "
                            f"the stem of {e['source']}")
        try:
            mod = importlib.import_module(manifest.module_name(e["module"]))
        except Exception as err:  # noqa: BLE001 - a lint reports it
            problems.append(f"{where}: {e['module']} does not import: "
                            f"{err}")
            continue
        wrapper = getattr(mod, e["wrapper"], None)
        wrappers.append(wrapper)
        for attr in (e["wrapper"], e["plain"]):
            if not callable(getattr(mod, attr, None)):
                problems.append(f"{where}: {e['module']} defines no "
                                f"callable {attr!r}")
        if not isinstance(getattr(wrapper, "launches", None), int):
            problems.append(f"{where}: wrapper {e['wrapper']!r} keeps no "
                            f"launch counter")
        root_rel, root_qual = e["root"]
        root = _def_of(cache, repo, root_rel, root_qual)
        if root is None:
            problems.append(f"{where}: dispatch root {root_qual!r} is no "
                            f"def of {root_rel}")
        elif not _mentions(root, e["wrapper"]):
            problems.append(f"{where}: dispatch root {root_qual!r} never "
                            f"calls {e['wrapper']!r}")
        for f in e["fields"]:
            if f not in DataplaneTables._fields:
                problems.append(f"{where}: operand {f!r} is no "
                                f"DataplaneTables field")
                continue
            try:
                spec_for(f)
            except PartitionError as err:
                problems.append(f"{where}: operand {f!r} has no "
                                f"partition rule: {err}")
        if e["knob"] not in DataplaneConfig._fields:
            problems.append(f"{where}: knob {e['knob']!r} is no "
                            f"DataplaneConfig field")
            continue
        if not hasattr(dp, e["rung"]):
            problems.append(f"{where}: Dataplane reports no rung "
                            f"{e['rung']!r}")
        if e["mesh"] not in MESH_MODES:
            problems.append(f"{where}: mesh {e['mesh']!r} is none of "
                            f"{MESH_MODES}")
        for value in e["values"]:
            cfg = DataplaneConfig(**_SMALL, **{e["knob"]: value})
            try:
                validate_dataplane_config(cfg)
                validate_partitioning(cfg, rule_shards=1)
            except ValueError as err:
                problems.append(f"{where}: {e['knob']}={value!r} is "
                                f"refused standalone: {err}")
                continue
            try:
                validate_partitioning(cfg, rule_shards=2)
            except ValueError as err:
                if e["mesh"] != "refused":
                    problems.append(
                        f"{where}: {e['knob']}={value!r} is refused on a "
                        f"rule-sharded mesh, whose entry says "
                        f"{e['mesh']!r}: {err}")
                elif "PARTITION_RULES" not in str(err):
                    problems.append(
                        f"{where}: the mesh refusal of {e['knob']}="
                        f"{value!r} does not name PARTITION_RULES: {err}")
            else:
                if e["mesh"] == "refused":
                    problems.append(
                        f"{where}: {e['knob']}={value!r} on a rule-sharded "
                        f"mesh is not refused by validate_partitioning: "
                        f"the kernel would get a shard's operands")
        if e["mesh"] == "runs":
            cluster = cache.get("vpp_tpu_torch/parallel/cluster.py",
                                repo / "vpp_tpu_torch/parallel/cluster.py")
            if not _mentions(cluster.tree, e["wrapper"]):
                problems.append(f"{where}: the entry says a mesh runs it, "
                                f"but parallel/cluster.py never calls "
                                f"{e['wrapper']!r}")
    sources = sorted(p.relative_to(repo).as_posix()
                     for p in (repo / "vpp_tpu_torch" / "csrc").glob("*.cu"))
    named = [e["source"] for e in kernels.values()]
    for s in sources:
        if named.count(s) != 1:
            problems.append(f"kernels: {s} has {named.count(s)} KERNELS "
                            f"entries, not one")
    for rel, fn, lib, sym, line in library_call_sites(repo, cache):
        hit = [n for n, e in kernels.items()
               if (e["module"], e["wrapper"], e["library"], e["symbol"])
               == (rel, fn, lib, sym)]
        if not hit:
            problems.append(f"kernels: {rel}:{line} loads "
                            f"{lib}.{sym} in {fn!r}, which is no registered "
                            f"wrapper")
    if tuple(capture.WRAPPERS) != tuple(wrappers):
        problems.append("kernels: capture.WRAPPERS is not the KERNELS "
                        "wrappers in order")
    return problems


# --- the table invariants ---------------------------------------------------


def _bv_plane_problems(name: str, bv, nrules: int, max_rules: int) -> list:
    """The invariants of one compiled BvTable against its rule count."""
    import numpy as np

    from vpp_tpu_torch.ops.acl_bv import DIMS, bv_capacity

    problems = []
    cap_i, cap_w, _cap_pr = bv_capacity(max_rules, True)
    planes = {dim: getattr(bv, f"bm_{dim}") for dim in DIMS}
    planes["proto"] = bv.bm_proto
    for k, dim in enumerate(DIMS):
        bnd = getattr(bv, f"bnd_{dim}")
        n = int(bv.nbnd[k])
        if len(bnd) != cap_i:
            problems.append(f"tables: {name}.{dim} boundary capacity "
                            f"{len(bnd)} != bv_capacity {cap_i}")
        live = bnd[:n].astype(np.int64)
        if n and not (np.diff(live) > 0).all():
            problems.append(f"tables: {name}.{dim} boundaries not strictly "
                            f"sorted")
        if n and live[0] != 0:
            problems.append(f"tables: {name}.{dim} boundary[0] != 0 (the "
                            f"value space must be covered)")
    for pname, bm in planes.items():
        if bm.shape[-1] != cap_w or cap_w != max(1, (max_rules + 31) // 32):
            problems.append(f"tables: {name}.{pname} word width "
                            f"{bm.shape[-1]} does not fit {max_rules} rules")
        # padding inert on the rule axis: no bit of a rule >= nrules
        for w in range(bm.shape[-1]):
            nbits = min(32, max(0, nrules - w * 32))
            allowed = np.uint32((1 << nbits) - 1)
            if (bm[..., w] & ~allowed).any():
                problems.append(f"tables: {name}.{pname} word {w} sets "
                                f"bits of padding rules (nrules={nrules})")
        # and on the interval axis: rows past the live count all zero
        if pname != "proto":
            n = int(bv.nbnd[list(DIMS).index(pname)])
            if bm[n:].any():
                problems.append(f"tables: {name}.{pname} has bits set in "
                                f"interval rows >= nbnd ({n})")
    return problems


def _lpm_builder():
    """A representative FIB: duplicate prefixes, /0 and /32, an ECMP
    group, a deleted route."""
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig, TableBuilder
    from vpp_tpu_torch.pipeline.vector import Disposition

    b = TableBuilder(DataplaneConfig(
        **dict(_SMALL, fib_slots=64), fib_impl="lpm", fib_ecmp_groups=4,
        fib_ecmp_ways=4), device="cpu")
    b.add_route("0.0.0.0/0", 1, Disposition.REMOTE, node_id=1)
    b.add_route("255.255.255.255/32", 2, Disposition.LOCAL)
    b.add_route("10.1.1.0/24", 3, Disposition.LOCAL)
    b.add_route("10.1.2.0/24", 3, Disposition.LOCAL)
    b.add_route("10.1.1.0/24", 4, Disposition.LOCAL)   # a duplicate
    b.set_nh_group(1, [(101, 5, -1), (102, 6, 2)])
    b.add_route("10.9.0.0/16", 5, Disposition.REMOTE, group=1)
    b.del_route("10.1.2.0/24")
    b._restage_lpm()
    return b


def _lpm_plane_problems() -> list:
    """The LPM planes, their stride hints and the ECMP groups of a
    representative FIB: each plane strictly sorted within its live
    prefix and inert past it, counts within capacity, slots of the
    plane's length, a duplicate kept at the lowest slot, each live
    group's ways its members, an unregistered group zeroed."""
    import numpy as np

    from vpp_tpu_torch.ops.lpm import (
        LPM_LENGTHS,
        LPM_PAD,
        lpm_field,
        lpm_hint_layout,
    )

    problems = []
    b = _lpm_builder()
    if not b.lpm_ok():
        problems.append("tables: the representative LPM table is not "
                        "lpm_ok")
    for length in range(LPM_LENGTHS):
        plane = b.lpm_planes[lpm_field(length)]
        n, cap = int(b.lpm_cnt[length]), plane.shape[1]
        if n > cap:
            problems.append(f"tables: lpm /{length} count {n} exceeds cap "
                            f"{cap}")
            continue
        live = plane[0, :n].astype(np.int64)
        if n > 1 and not (np.diff(live) > 0).all():
            problems.append(f"tables: lpm /{length} prefixes not strictly "
                            f"sorted (a duplicate must keep one slot)")
        if (plane[0, n:] != LPM_PAD).any() or (plane[1, n:] != 0).any():
            problems.append(f"tables: lpm /{length} pad rows past count {n} "
                            f"are not inert")
        slots = plane[1, :n].astype(np.int64)
        if n and ((slots < 0) | (slots >= b.config.fib_slots)).any():
            problems.append(f"tables: lpm /{length} slot row out of range")
        elif n and (b.fib_plen[slots] != length).any():
            problems.append(f"tables: lpm /{length} slot row points at a "
                            f"route of another length")
    layout, hint_rows = lpm_hint_layout(b.lpm_caps)
    if len(b.lpm_hint) != hint_rows:
        problems.append(f"tables: lpm hint rows {len(b.lpm_hint)} != "
                        f"layout {hint_rows}")
    else:
        for length in range(LPM_LENGTHS):
            bb, off, _steps = layout[length]
            if off < 0:
                continue
            h = b.lpm_hint[off:off + (1 << bb) + 1]
            if (np.diff(h) < 0).any() or h[0] != 0 \
                    or h[-1] != int(b.lpm_cnt[length]):
                problems.append(f"tables: lpm /{length} hint rows are not "
                                f"a monotone [0, count] bracket")
    p24, n24 = b.lpm_planes[lpm_field(24)], int(b.lpm_cnt[24])
    dup = p24[1, :n24][p24[0, :n24] == (10 << 24 | 1 << 16 | 1 << 8)]
    if len(dup) != 1 or int(b.fib_tx_if[int(dup[0])]) != 3:
        problems.append("tables: the duplicate prefix does not keep the "
                        "lowest slot")
    registered = set(b.nh_groups)
    used = {int(g) for g in np.unique(b.fib_grp) if g >= 0}
    if not used <= registered:
        problems.append(f"tables: routes name unregistered ECMP groups "
                        f"{sorted(used - registered)}")
    for gid in range(b.fib_grp_nh.shape[0]):
        if gid in registered:
            members = {tuple(m) for m in b.nh_groups[gid]["members"]}
            rows = set(zip(b.fib_grp_nh[gid].tolist(),
                           b.fib_grp_tx_if[gid].tolist(),
                           b.fib_grp_node[gid].tolist()))
            if not rows <= members:
                problems.append(f"tables: ecmp group {gid} ways hold "
                                f"non-members")
            if int(b.fib_grp_n[gid]) != len(members):
                problems.append(f"tables: ecmp group {gid} member count "
                                f"desynced")
        elif int(b.fib_grp_n[gid]) != 0 or b.fib_grp_nh[gid].any():
            problems.append(f"tables: unregistered ecmp group {gid} row "
                            f"not zeroed")
    return problems


def _derived_problems() -> list:
    """The derived tensors the kernels read, against what they derive
    from: the LPM stack (``lpm_fused_lookup``) holds the populated
    lengths longest first, their live counts and each plane's rows; the
    MXU operand (``mxu_first_match``) unswizzles to the coefficients
    with ``k`` in its plane."""
    import torch

    from vpp_tpu_torch.ops.acl_mxu import _K_PLANE, mxu_operand_rows
    from vpp_tpu_torch.ops.lpm import LPM_LENGTHS, bias, lpm_field

    problems = []
    t = _lpm_builder().to_device()
    planes = {L: getattr(t, lpm_field(L)) for L in range(LPM_LENGTHS)}
    lens = [L for L in range(LPM_LENGTHS - 1, -1, -1)
            if planes[L].shape[1] > 0]
    if t.fib_lpm_lens.tolist() != lens:
        problems.append(f"tables: fib_lpm_lens {t.fib_lpm_lens.tolist()} "
                        f"are not the populated lengths longest first")
    elif not torch.equal(t.fib_lpm_stk_cnt,
                         t.fib_lpm_cnt[t.fib_lpm_lens.long()]):
        problems.append("tables: fib_lpm_stk_cnt is not the stacked "
                        "lengths' live counts")
    else:
        for r, L in enumerate(lens):
            w = planes[L].shape[1]
            if not (torch.equal(t.fib_lpm_stk_pfx[r, :w], bias(planes[L][0]))
                    and torch.equal(t.fib_lpm_stk_slot[r, :w],
                                    planes[L][1])):
                problems.append(f"tables: the LPM stack's row {r} is not "
                                f"plane /{L}")
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig, TableBuilder

    b = TableBuilder(DataplaneConfig(**_SMALL), device="cpu")
    b.set_global_table(_rules()[:6])
    t = b.to_device()
    rows, k = mxu_operand_rows(t.glb_mxu_op)
    want = t.glb_mxu_coeff.t().to(torch.int8)
    if want[:, _K_PLANE].any():
        problems.append("tables: the MXU operand's k plane is not a pad "
                        "plane of the coefficients")
    want[:, _K_PLANE] = 0
    if not torch.equal(rows, want) or \
            not torch.equal(k, t.glb_mxu_k.to(torch.int32)):
        problems.append("tables: glb_mxu_op does not unswizzle to "
                        "glb_mxu_coeff and glb_mxu_k")
    return problems


def _svc_plane_problems() -> list:
    """The service planes of a representative registry: VIP rows sorted
    by (ip, port, proto), padding rows inert, each live row's ways its
    registered backends with the weighted largest-remainder fill, a
    surviving backend keeping its ways when another is replaced; and the
    tenancy-off VNI plane (slot 0 the default VNI, every other -1)."""
    import numpy as np

    from vpp_tpu_torch.ops.vxlan import DEFAULT_VNI
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig, TableBuilder

    problems = []
    b = TableBuilder(DataplaneConfig(**_SMALL, svc_vips=4,
                                     svc_backend_ways=8), device="cpu")
    vip1, vip2 = 0x0A600001, 0x0A600002
    bk = [0x0A000001, 0x0A000002, 0x0A000003, 0x0A000004, 0x0A000005]
    b.set_service(vip2, 80, 6, [(bk[0], 8080, 1), (bk[1], 8080, 1)])
    b.set_service(vip1, 443, 6, [(bk[2], 8443, 2), (bk[3], 8443, 1),
                                 (bk[4], 8443, 1)], self_snat=True)
    svc, n = b.svc, len(b.services)
    keys = list(zip(svc["svc_vip_ip"][:n].astype(np.int64).tolist(),
                    svc["svc_vip_port"][:n].tolist(),
                    svc["svc_vip_proto"][:n].tolist()))
    if keys != sorted(keys):
        problems.append("tables: svc VIP rows not sorted by (ip, port, "
                        "proto)")
    if (svc["svc_bk_n"][n:].any() or svc["svc_vip_ip"][n:].any()
            or svc["svc_bk_ip"][n:].any() or svc["svc_bk_port"][n:].any()):
        problems.append("tables: svc padding rows past the live count are "
                        "not inert")
    order = sorted(b.services)
    for r, key in enumerate(order):
        e = b.services[key]
        members = {(m[0], m[1]) for m in e["members"]}
        ways = set(zip(svc["svc_bk_ip"][r].astype(np.int64).tolist(),
                       svc["svc_bk_port"][r].tolist()))
        if not ways <= members:
            problems.append(f"tables: svc row {r} ways hold non-members")
        if int(svc["svc_bk_n"][r]) != len(e["members"]):
            problems.append(f"tables: svc row {r} bk_n desynced")
    r1 = order.index((vip1, 443, 6))
    owned = int((svc["svc_bk_ip"][r1].astype(np.int64) == bk[2]).sum())
    if owned != 4:
        problems.append(f"tables: svc weighted fill wrong: the weight-2 "
                        f"backend owns {owned}/8 ways, not 4")
    r2 = order.index((vip2, 80, 6))
    before = svc["svc_bk_ip"][r2].astype(np.int64).copy()
    b.set_service(vip2, 80, 6, [(bk[0], 8080, 1), (0x0A000009, 8080, 1)])
    after = b.svc["svc_bk_ip"][r2].astype(np.int64)
    survivor = before == bk[0]
    if not (after[survivor] == bk[0]).all():
        problems.append("tables: svc sticky fill moved a surviving "
                        "backend's ways")
    if not (after[~survivor] == 0x0A000009).all():
        problems.append("tables: svc replaced backend's ways not handed to "
                        "the replacement")
    if int(b.tnt["tnt_vni"][0]) != DEFAULT_VNI:
        problems.append("tables: tenancy-off tnt_vni[0] is not DEFAULT_VNI")
    if (b.tnt["tnt_vni"][1:] != -1).any():
        problems.append("tables: unconfigured tnt_vni slots are not -1")
    return problems


def _rules():
    import ipaddress

    from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol

    return [
        ContivRule(action=Action.PERMIT, protocol=Protocol.TCP,
                   src_network=ipaddress.ip_network(f"10.{i}.0.0/16"),
                   dest_port=80 + i)
        for i in range(40)
    ] + [
        ContivRule(action=Action.DENY, protocol=Protocol.UDP, dest_port=0),
        ContivRule(action=Action.PERMIT),          # wildcard everything
        ContivRule(action=Action.DENY, protocol=Protocol.TCP,
                   dest_port=65535),
        ContivRule(action=Action.DENY),            # terminal deny-all
    ]


def tables_lint() -> List[str]:
    """The ``--tables`` pass: a representative rule set through a
    BV-enabled builder (the global table and a local one, an empty
    slot's planes inert), the LPM planes and ECMP groups, the derived
    kernel operands, the service planes, and the capacity constants the
    classifiers share. Returns problems (empty == clean)."""
    from vpp_tpu_torch.ops.acl_bv import BvTable, bv_capacity, bv_global_bytes
    from vpp_tpu_torch.ops.acl_mxu import mxu_rule_capacity
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig, TableBuilder

    cfg = DataplaneConfig(**dict(_SMALL, max_rules=16, max_global_rules=96),
                          classifier="bv")
    b = TableBuilder(cfg, device="cpu")
    rules = _rules()
    b.set_global_table(rules)
    b.set_local_table(0, rules[:7])
    problems = _bv_plane_problems("glb", b.glb_bv, b.glb_nrules,
                                  cfg.max_global_rules)
    for slot, nrules in ((0, 7), (1, 0)):
        a = b.acl_bv
        local = BvTable(
            bnd_src=a["bnd_src"][slot], bnd_dst=a["bnd_dst"][slot],
            bnd_sport=a["bnd_sport"][slot], bnd_dport=a["bnd_dport"][slot],
            nbnd=a["nbnd"][slot], bm_src=a["src"][slot],
            bm_dst=a["dst"][slot], bm_sport=a["sport"][slot],
            bm_dport=a["dport"][slot], bm_proto=a["proto"][slot],
            ok=bool(b.acl_bv_ok[slot]), build_ms=0.0)
        problems += _bv_plane_problems(f"local[{slot}]", local, nrules,
                                       cfg.max_rules)
    problems += _lpm_plane_problems()
    problems += _derived_problems()
    problems += _svc_plane_problems()
    for r in (cfg.max_rules, cfg.max_global_rules, 1024, 10240):
        ib, w, _pr = bv_capacity(r, True)
        if ib != 2 * r + 2:
            problems.append(f"tables: bv interval capacity {ib} != 2*{r}+2")
        if w * 32 < r:
            problems.append(f"tables: bv word capacity {w}*32 < {r} rules")
        if mxu_rule_capacity(r) < r:
            problems.append(f"tables: mxu rule capacity "
                            f"{mxu_rule_capacity(r)} < {r}")
        if bv_global_bytes(r) < ib * w * 4 * 4:
            problems.append(f"tables: bv_global_bytes({r}) smaller than its "
                            f"own bitmap matrices")
    return problems
