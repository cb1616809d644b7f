"""Debug CLI: the vppctl analog.

Reference: VPP's `vppctl` show commands (`show interface`, `show acl`,
`show session`, `show nat44`, `show ip fib`, `show trace`, `show run`,
`show errors`) used throughout docs/VPP_PACKET_TRACING_K8S.md. Operates
on a live Dataplane (and optionally its tracer/stats); every command
returns a string so it serves both the interactive REPL and tests.

The port's copy of ``vpp_tpu/cli.py``: the same commands, and the same
text line for line where the data is the same. Every step writes the
session planes in place, so a page that reads a live plane (``show
session``, ``show sessions``, ``show nat44``, ``show fastpath``) takes
it under the dataplane's ``_lock`` as one device reduction and one host
copy; ``test connectivity`` builds its probe on the dataplane's device
and ``Dataplane.probe`` steps it under the same lock. ``show kernels``
names the card (or ``cpu``) as its backend, ``show io`` lists the
captured step programs where the reference lists its jit compiles, and
``show partitions`` names the ROADMAP item of the mesh (the partition
layer is not ported).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.tables import InterfaceType
from vpp_tpu_torch.pipeline.vector import Disposition, ip4_str


MESH_ITEM = "ROADMAP Queue 1 item 10 (Mesh / cluster)"

_M32 = 0xFFFFFFFF


def _session_counts(t, now: int) -> dict:
    """The scalars of ``show sessions`` for both session tables, reduced
    on the tables' device and copied to the host at once: the max age,
    and per table (``sess``, ``natsess``) the occupied, live (not idle
    past the max age at ``now``) and full-bucket counts and the sweep
    cursor. Call under the dataplane's ``_lock``."""
    rows = [t.sess_max_age.reshape(()).to(torch.int64)]
    for prefix in ("sess", "natsess"):
        valid = getattr(t, f"{prefix}_valid")
        occ = valid == 1
        fresh = (now - getattr(t, f"{prefix}_time")) <= t.sess_max_age
        rows += [occ.sum(), (occ & fresh).sum(),
                 (occ.sum(dim=1) == valid.shape[1]).sum(),
                 getattr(t, f"{prefix}_sweep_cursor").reshape(())
                 .to(torch.int64)]
    v = torch.stack(rows).tolist()
    return {"max_age": v[0], "sess": v[1:5], "natsess": v[5:9]}


class DebugCLI:
    def __init__(self, dataplane: Dataplane, tracer=None, stats=None,
                 pump=None, io_ctl=None, session_engine=None,
                 mesh_runtime=None, store=None, snapshotter=None,
                 ml_source=None, fleet=None, fleet_pump=None):
        self.dp = dataplane
        self.tracer = tracer
        self.stats = stats
        # optional IO front-end handles: the agent-side pump and the
        # control-socket client into the (separate) IO daemon process
        self.pump = pump
        self.io_ctl = io_ctl
        # optional host-stack handle (show session-rules)
        self.session_engine = session_engine
        # optional mesh/multi-host runtime handle (show mesh)
        self.mesh_runtime = mesh_runtime
        # optional cluster-store handle (show store: endpoint, fencing
        # epoch, HA failover state as this agent experiences it)
        self.store = store
        # optional SessionSnapshotter (show resilience: snapshot
        # generation/age, degraded components, backoff state)
        self.snapshotter = snapshotter
        # optional MlModelSource (show ml: load ledger, degraded flag)
        self.ml_source = ml_source
        # optional gateway-fleet handles (show fleet: ownership map,
        # epochs, migration/conservation counters)
        self.fleet = fleet
        self.fleet_pump = fleet_pump

    # --- dispatch ---
    def run(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return ""
        handlers = {
            ("show", "interface"): self.show_interface,
            ("show", "acl"): self.show_acl,
            ("show", "sessions"): self.show_sessions,
            ("show", "session"): self.show_session,
            ("show", "session-rules"): self.show_session_rules,
            ("show", "mesh"): self.show_mesh,
            ("show", "partitions"): self.show_partitions,
            ("show", "nat44"): self.show_nat44,
            ("show", "services"): self.show_services,
            ("show", "overlay"): self.show_overlay,
            ("show", "trace"): self.show_trace,
            ("show", "errors"): self.show_errors,
            ("show", "fastpath"): self.show_fastpath,
            ("show", "kernels"): self.show_kernels,
            ("show", "ml"): self.show_ml,
            ("show", "latency"): self.show_latency,
            ("show", "top-flows"): self.show_top_flows,
            ("show", "governor"): self.show_governor,
            ("show", "tenants"): self.show_tenants,
            ("show", "io"): self.show_io,
            ("show", "neighbors"): self.show_neighbors,
            ("show", "store"): self.show_store,
            ("show", "resilience"): self.show_resilience,
            ("show", "fleet"): self.show_fleet,
            ("help",): self.help,
        }
        for sig, fn in handlers.items():
            if tuple(parts[: len(sig)]) == sig:
                return fn()
        if tuple(parts[:2]) == ("show", "fib"):
            return self.show_fib(parts[2:])
        if tuple(parts[:2]) == ("show", "config-history"):
            return self.show_config_history(parts[2:])
        if tuple(parts[:2]) == ("show", "spans"):
            return self.show_spans(parts[2:])
        if tuple(parts[:2]) == ("test", "connectivity"):
            return self.test_connectivity(parts[2:])
        if tuple(parts[:2]) == ("trace", "add"):
            return self.trace_add(parts[2:])
        if tuple(parts[:2]) == ("trace", "clear"):
            return self.trace_clear()
        if tuple(parts[:2]) == ("config", "replay"):
            return self.config_replay(parts[2:])
        return f"unknown command: {line.strip()!r} (try 'help')"

    def help(self) -> str:
        return (
            "commands: show interface | show acl | show session | "
            "show sessions | show session-rules | show mesh | "
            "show partitions | "
            "show nat44 | show services | show overlay | "
            "show fib | show trace | show errors | "
            "show fastpath | show kernels | show ml | show latency | "
            "show top-flows | "
            "show governor | show tenants | show io | show neighbors | "
            "show store | "
            "show resilience | show fleet | "
            "show config-history [n] | show spans [n] | "
            "trace add [n] | trace clear | config replay <journal> | "
            "test connectivity <src> <dst> <tcp|udp|icmp> [dport]"
        )

    # --- config transaction trace (api-trace analog) ---
    def show_spans(self, args: List[str]) -> str:
        """Control-plane span timelines (trace/spans.py): per applied
        txn, the KSR → kvstore → agent → render → swap stage timings —
        the `show trace` analog for the config path."""
        from vpp_tpu_torch.trace import spans as _spans

        try:
            limit = int(args[0]) if args else 10
            if limit <= 0:
                raise ValueError("count must be positive")
        except ValueError as e:
            return f"bad argument: {e}"
        return _spans.RECORDER.format_traces(limit=limit)

    def show_config_history(self, args: List[str]) -> str:
        """Tail of the NB transaction journal the live agent recorded
        (`api-trace` dump analog): epoch, timestamp, label, op count,
        and — when the epoch's swap was traced — the per-stage config
        path timings of the applying transaction."""
        journal = self.dp.journal
        if journal is None:
            return "config journal not enabled (set txn_journal_path)"
        limit = int(args[0]) if args else 20
        import os
        import time as _time

        from vpp_tpu_torch.trace import spans as _spans

        if not journal.path or not os.path.exists(journal.path):
            return f"{journal.applied} txns applied (no journal file)"
        entries = journal.load_entries()
        # epoch -> per-stage seconds of the trace whose swap published it
        by_epoch = _spans.RECORDER.epoch_timings()
        lines = []
        for e in entries[-limit:]:
            ts = _time.strftime("%H:%M:%S", _time.localtime(e.get("t", 0)))
            label = e.get("label") or "-"
            line = (
                f"epoch {e.get('epoch'):>5}  {ts}  {len(e.get('ops', [])):>3} "
                f"ops  {label}"
            )
            _, stages = by_epoch.get(e.get("epoch"), (None, None))
            if stages:
                line += "  [" + " ".join(
                    f"{stage} {sec * 1e3:.2f}ms"
                    for stage, sec in sorted(stages.items())
                ) + "]"
            lines.append(line)
        lines.append(f"{len(entries)} txns journaled, showing last "
                     f"{min(limit, len(entries))}")
        if journal.torn_lines:
            lines.append(
                f"WARNING: {journal.torn_lines} torn trailing line "
                f"(crash mid-append) tolerated on load"
            )
        return "\n".join(lines)

    def config_replay(self, args: List[str]) -> str:
        """Replay a journal file against the LIVE dataplane as ONE
        transaction (bulk restore: stage every journaled op + a single
        epoch swap)."""
        if not args:
            return "usage: config replay <journal.jsonl>"
        from vpp_tpu_torch.pipeline.txn import TxnJournal

        journal = TxnJournal(args[0])
        txns = journal.load()
        if not txns:
            return f"no transactions in {args[0]}"
        dp = self.dp
        with dp.commit_lock:
            snap = dp.builder.state_snapshot()
            try:
                for txn in txns:
                    txn.apply_to_builder(dp.builder)
            except Exception as e:  # noqa: BLE001 — debug path
                dp.builder.state_restore(snap)
                return f"replay failed (rolled back): {type(e).__name__}: {e}"
            dp.builder.txn_label = f"config-replay {args[0]}"
            epoch = dp.swap()
        return f"replayed {len(txns)} txns from {args[0]} -> epoch {epoch}"

    # --- commands ---
    def show_interface(self) -> str:
        dp = self.dp
        t = np.asarray(dp.builder.if_type)
        lines = [f"{'idx':>4} {'type':<8} {'acl-table':>9}  pod"]
        for i in np.nonzero(t != 0)[0]:
            i = int(i)
            pod = dp.if_pod.get(i)
            name = f"{pod[0]}/{pod[1]}" if pod else (
                "uplink" if i == dp.uplink_if else
                "host" if i == dp.host_if else ""
            )
            slot = int(dp.builder.if_local_table[i])
            lines.append(
                f"{i:>4} {InterfaceType(int(t[i])).name.lower():<8} "
                f"{slot if slot >= 0 else '-':>9}  {name}"
            )
        return "\n".join(lines)

    def show_acl(self) -> str:
        dp = self.dp
        b = dp.builder
        impl = getattr(dp, "classifier_impl", "dense")
        knob = getattr(dp, "classifier", "auto")
        lines = [
            f"classifier: {impl} (knob {knob}), "
            f"global rules {int(b.glb_nrules)}",
        ]
        if getattr(b, "bv_enabled", False):
            from vpp_tpu_torch.ops.acl_bv import bv_global_bytes

            detail = (
                f"  bv: bitmap {bv_global_bytes(dp.config.max_global_rules)}"
                f" bytes, build {b.bv_build_ms:.2f} ms"
            )
            rebuilt = getattr(b, "bv_rebuilt", ())
            if rebuilt:
                detail += f", last rebuilt planes: {','.join(rebuilt)}"
            if not b.bv_ok():
                detail += " (NOT eligible: non-prefix mask rule)"
            lines.append(detail)
        ns = getattr(dp, "classify_ns_pkt", None)
        if ns is not None:
            lines.append(f"  classify probe: {ns:.1f} ns/pkt "
                         f"(time_classifier diagnostic)")
        for table_id, slot in sorted(dp.table_slots.items()):
            n = int(dp.builder.acl_nrules[slot])
            lines.append(f"local table {table_id} (slot {slot}, {n} rules):")
            lines.extend(self._rules(dp.builder.acl, slot, n))
        n = int(dp.builder.glb_nrules)
        lines.append(f"global table ({n} rules):")
        lines.extend(self._rules(dp.builder.glb, None, n))
        return "\n".join(lines)

    def _rules(self, packed, slot: Optional[int], n: int) -> List[str]:
        def col(name, i):
            a = packed[name]
            return a[slot][i] if slot is not None else a[i]

        out = []
        for i in range(n):
            act = "permit" if int(col("action", i)) == 1 else "deny"
            proto = int(col("proto", i))
            pstr = {6: "tcp", 17: "udp", 1: "icmp", -1: "any"}.get(proto, str(proto))
            src = f"{ip4_str(int(col('src_net', i)))}/{bin(int(col('src_mask', i))).count('1')}"
            dst = f"{ip4_str(int(col('dst_net', i)))}/{bin(int(col('dst_mask', i))).count('1')}"
            def port_range(lo, hi):
                if (lo, hi) == (0, 65535):
                    return "any"
                return str(lo) if lo == hi else f"{lo}-{hi}"

            sport = port_range(int(col("sport_lo", i)), int(col("sport_hi", i)))
            dport = port_range(int(col("dport_lo", i)), int(col("dport_hi", i)))
            out.append(f"  [{i}] {act} {pstr} {src}:{sport} -> {dst}:{dport}")
        return out

    def show_session(self) -> str:
        dp = self.dp
        t = dp.tables
        if t is None:
            return "no live tables"
        with dp._lock:
            valid = t.sess_valid.reshape(-1)
            idxs = torch.nonzero(valid).reshape(-1)
            cols = torch.stack([
                getattr(t, f).reshape(-1)[idxs[:64]].to(torch.int64)
                for f in ("sess_src", "sess_dst", "sess_ports",
                          "sess_proto", "sess_time")])
            n = torch.stack([torch.tensor(idxs.numel()),
                             torch.tensor(valid.shape[0])]).tolist()
            cols = cols.cpu().numpy()
        lines = [f"{n[0]} established sessions "
                 f"({n[1]} slots)"]
        for src, dst, ports, proto, age in cols.T:
            ports = int(ports) & _M32
            lines.append(
                f"  {ip4_str(int(src))}:{ports >> 16} -> "
                f"{ip4_str(int(dst))}:{ports & 0xFFFF} "
                f"proto {int(proto)} last-hit {int(age)}"
            )
        if n[0] > 64:
            lines.append(f"  ... {n[0] - 64} more")
        return "\n".join(lines)

    def show_sessions(self) -> str:
        """Session-TABLE health page (the per-flow dump is
        `show session`): geometry, live occupancy / load factor and the
        amortized sweep cursors of both set-associative tables
        (ops/session.py; docs/SESSIONS.md)."""
        dp = self.dp
        t = dp.tables
        if t is None:
            return "no live tables"
        now = max(dp._now, dp.clock_ticks())
        # aggregate ON DEVICE: at the 10M-slot config the valid + time
        # columns are ~270 MB across both tables — a CLI page must pull
        # back a few scalars, not the arrays
        with dp._lock:
            counts = _session_counts(t, now)
        max_age = counts["max_age"]
        lines = [f"session tables (max_age {max_age} ticks, "
                 f"sweep stride {dp._sweep_stride} buckets/step)"]
        for name, prefix in (("reflective", "sess"), ("nat", "natsess")):
            n_buckets, ways = getattr(t, f"{prefix}_valid").shape
            slots = n_buckets * ways
            occupied, live, full, cursor = counts[prefix]
            lines.append(
                f"  {name}: {slots} slots = {n_buckets} buckets x "
                f"{ways} ways")
            lines.append(
                f"    live {live} ({100.0 * live / slots:.1f}% load)  "
                f"occupied {occupied} (incl. expired)  "
                f"full-buckets {full}")
            lines.append(
                f"    sweep cursor {cursor}/{n_buckets}")
        if self.stats is not None:
            tot = self.stats.totals_snapshot()
            lines.append(
                "  insert-fail {s}/{n} (sess/nat)  evictions "
                "expired {ee}+{ne} victim {ev}+{nv}".format(
                    s=tot.get("sess_insert_fail", 0),
                    n=tot.get("natsess_insert_fail", 0),
                    ee=tot.get("sess_evict_expired", 0),
                    ne=tot.get("natsess_evict_expired", 0),
                    ev=tot.get("sess_evict_victim", 0),
                    nv=tot.get("natsess_evict_victim", 0)))
        return "\n".join(lines)

    def show_mesh(self) -> str:
        """Mesh/multi-host runtime state: nodes this host drives, the
        lockstep tick/epoch counters (multi-host), fabric pump
        counters. The `show version`-grade operator one-pager for the
        multi-chip plane."""
        rt = self.mesh_runtime
        if rt is None:
            return "not a mesh agent (no runtime attached)"
        lines = []
        cluster = getattr(rt, "cluster", None)
        if cluster is not None:
            lines.append(
                f"cluster: {cluster.n_nodes} nodes, epoch {cluster.epoch}")
        local = getattr(cluster, "local_nodes", None)
        if local is not None:
            lines.append(f"local mesh rows: {local}")
        driver = getattr(rt, "driver", None)
        if driver is not None:
            lines.append(
                f"lockstep: tick {driver.ticks}, applied epoch-req "
                f"{driver.applied}, session aging every "
                f"{driver.expire_every} ticks")
        agents = getattr(rt, "agents", None)
        if agents:
            lines.append("agents: " + ", ".join(
                f"{a.config.node_name}(id {a.node_id})" for a in agents))
        pump = getattr(rt, "cluster_pump", None)
        if pump is not None:
            ps = pump.stats
            lines.append(
                f"fabric pump: steps {ps.get('steps', 0)}, frames "
                f"{ps.get('frames', 0)}, fabric pkts "
                f"{ps.get('fabric_pkts', 0)}, tx-ring-full "
                f"{ps.get('tx_ring_full', 0)}, errors "
                f"{ps.get('batch_errors', 0)}, pending "
                f"{pump.has_pending() if hasattr(pump, 'has_pending') else '?'}")
        return "\n".join(lines) or "mesh runtime attached, no state"

    def show_partitions(self) -> str:
        """The partition-rule layer's resolved placements: the mesh's
        page. The partition layer (``parallel/partition.py``) and the
        mesh runtime are not ported, so the port names their ROADMAP
        item and imports nothing."""
        return ("partition layer: not ported (parallel/partition.py and "
                f"the mesh runtime wait for {MESH_ITEM}); this dataplane "
                "is standalone, every table field lives whole on "
                f"{self.dp.device}")

    def show_session_rules(self) -> str:
        """The `show session rules` analog: the VPPTCP renderer's
        installed session filter tables, most-specific first per scope
        (reference: session_rules_table dump,
        plugins/policy/renderer/vpptcp/bin_api/session)."""
        eng = self.session_engine
        if eng is None:
            return "no session rule engine attached"
        rules = eng.dump()
        lines = [f"{len(rules)} session rules "
                 f"(capacity {eng.capacity})"]
        scope_name = {1: "LOCAL", 2: "GLOBAL"}
        act_name = {0: "deny", 1: "allow"}
        for r in rules[:128]:
            lcl = (f"{ip4_str(int(r.lcl_net))}/{r.lcl_plen}"
                   if r.lcl_plen else "any")
            rmt = (f"{ip4_str(int(r.rmt_net))}/{r.rmt_plen}"
                   if r.rmt_plen else "any")
            ns = "" if r.appns_index < 0 else f" ns {r.appns_index}"
            lines.append(
                f"  {scope_name.get(r.scope, r.scope)}{ns} "
                f"proto {r.transport_proto} "
                f"lcl {lcl}:{r.lcl_port or 'any'} "
                f"rmt {rmt}:{r.rmt_port or 'any'} "
                f"-> {act_name.get(r.action, r.action)}"
            )
        if len(rules) > 128:
            lines.append(f"  ... {len(rules) - 128} more")
        return "\n".join(lines)

    def show_nat44(self) -> str:
        dp = self.dp
        b = dp.builder
        lines = ["static mappings:"]
        for s in np.nonzero(np.asarray(b.nat_bcnt) > 0)[0]:
            s = int(s)
            boff, bcnt = int(b.nat_boff[s]), int(b.nat_bcnt[s])
            lines.append(
                f"  {ip4_str(int(b.nat_ext_ip[s]))}:{int(b.nat_ext_port[s])} "
                f"proto {int(b.nat_proto[s])} -> {bcnt} backends:"
            )
            prev = 0
            for j in range(boff, boff + bcnt):
                w = int(b.natb_cumw[j]) - prev
                prev = int(b.natb_cumw[j])
                lines.append(
                    f"    {ip4_str(int(b.natb_ip[j]))}:{int(b.natb_port[j])} "
                    f"weight {w}"
                )
        t = dp.tables
        if t is not None:
            with dp._lock:
                n = int(t.natsess_valid.sum())  # one device reduction
            lines.append(f"nat sessions: {n}")
        return "\n".join(lines)

    def show_services(self) -> str:
        """The svc-plane registry: per-VIP backend sets
        with their sticky hash-way spread, plus the last svc-group
        upload record — the churn blob `overlay_bench` prices as
        svc_churn_bytes."""
        from vpp_tpu_torch.pipeline.tables import svc_capacity

        b = self.dp.builder
        V, B = svc_capacity(b.config)
        if V <= 0:
            return "svc planes off (dataplane.svc_vips is 0)"
        lines = [f"services: {len(b.services)}/{V} VIPs, "
                 f"{B} backend ways each"]
        for key in sorted(b.services):
            e = b.services[key]
            ways: dict = {}
            for m in e["assign"]:
                ways[(m[0], m[1])] = ways.get((m[0], m[1]), 0) + 1
            snat = " self-snat" if e["self_snat"] else ""
            lines.append(
                f"  {ip4_str(key[0])}:{key[1]} proto {key[2]} -> "
                f"{len(e['members'])} backends{snat}:")
            for bip, bport, w in e["members"]:
                lines.append(
                    f"    {ip4_str(bip)}:{bport} weight {w} "
                    f"ways {ways.get((bip, bport), 0)}/{B}")
        up = b.svc_upload
        if up:
            lines.append(
                "last churn: {:.2f} ms, {} B ({} fields + {} B "
                "scatter blob)".format(
                    float(up.get("ms", 0.0)), int(up.get("bytes", 0)),
                    len(up.get("fields", ())),
                    int(up.get("blob_bytes", 0))))
        return "\n".join(lines)

    def show_overlay(self) -> str:
        """Overlay state: the step-form knob, this node's
        VTEP, the on-device VNI -> tenant admission map, and the
        overlay stage counters when a collector is attached."""
        dp = self.dp
        knob = getattr(dp.config, "overlay", "off")
        lines = [f"overlay: {knob}"]
        vtep = getattr(dp, "_vtep", None)
        lines.append("vtep: " + (ip4_str(int(vtep)) if vtep is not None
                                 else "(unset)"))
        vni = np.asarray(dp.builder.tnt["tnt_vni"])
        rows = [(int(t), int(v)) for t, v in enumerate(vni) if v >= 0]
        if rows:
            lines.append("vni -> tenant admission map:")
            for t, v in rows:
                lines.append(f"  vni {v} -> tenant {t}")
        else:
            lines.append("vni admission map: empty (all decap "
                         "fails closed)")
        if self.stats is not None:
            totals = self.stats.totals_snapshot()
            for k in ("ovl_decap", "ovl_encap", "drop_overlay"):
                lines.append(f"{k:<14} {totals.get(k, 0):>12}")
        return "\n".join(lines)

    # route rows rendered without a prefix filter before the page
    # demands one — a 1M-route FIB must never be formatted slot by
    # slot in Python (`show fib <prefix>` narrows)
    FIB_LIST_MAX = 256

    def show_fib(self, args: Optional[List[str]] = None) -> str:
        """Summary-first FIB page: impl/ladder state, route
        histogram by prefix length, ECMP groups with per-member
        forwarded packets, plane bytes and the last churn upload —
        host scalars, no per-slot Python loop. Full route rows render
        only for small tables or under a prefix filter
        (``show fib <prefix[/len]>``: routes covering or covered by
        it), matched with one vectorized NumPy pass."""
        dp = self.dp
        b = dp.builder
        snap = dp.fib_snapshot()
        by_len = " ".join(f"/{L}:{n}"
                          for L, n in sorted(snap["by_length"].items()))
        lines = [
            "FIB: impl {} (knob {}{}), routes {}, plane bytes {}".format(
                snap["impl"], snap["knob"],
                "" if snap["lpm_ok"] else ", lpm ineligible",
                snap["routes"], snap["plane_bytes"]),
            f"routes by length: {by_len or '(none)'}",
        ]
        up = snap.get("upload") or {}
        if up:
            lines.append(
                "last churn: {:.2f} ms, {} B ({} fields + {} B "
                "slot blob)".format(
                    float(up.get("ms", 0.0)), int(up.get("bytes", 0)),
                    len(up.get("fields", ())),
                    int(up.get("blob_bytes", 0))))
        for gid, members in sorted(snap["ecmp_groups"].items()):
            lines.append(f"ecmp group {gid}: {len(members)} members")
            for m in members:
                lines.append(
                    f"  via {ip4_str(m['nh'])} if {m['tx_if']} "
                    f"node {m['node']} ways {len(m['ways'])} "
                    f"pkts {m['pkts']}")
        plen = np.asarray(b.fib_plen)
        live = plen >= 0
        want = None
        if args:
            try:
                import ipaddress as _ipaddress

                net = _ipaddress.ip_network(args[0], strict=False)
            except ValueError as e:
                return f"bad prefix filter: {e}"
            qlen = net.prefixlen
            qmask = np.uint32(
                ((1 << 32) - 1) ^ ((1 << (32 - qlen)) - 1) if qlen else 0)
            qnet = np.uint32(int(net.network_address)) & qmask
            pfx = np.asarray(b.fib_prefix)
            msk = np.asarray(b.fib_mask)
            # route covers the query, or the query covers the route —
            # one vectorized pass, never a per-slot Python loop
            covers = (qnet & msk) == pfx
            inside = (pfx & qmask) == qnet
            want = live & (covers | inside)
        elif int(live.sum()) <= self.FIB_LIST_MAX:
            want = live
        else:
            lines.append(
                f"({int(live.sum())} routes — pass a prefix filter: "
                f"show fib <prefix[/len]>)")
        if want is not None:
            rows = []
            idx = np.nonzero(want)[0]
            shown = idx[:self.FIB_LIST_MAX]
            for i in shown:
                i = int(i)
                disp = Disposition(int(b.fib_disp[i])).name.lower()
                extra = ""
                if int(b.fib_grp[i]) >= 0:
                    extra = f" ecmp-group {int(b.fib_grp[i])}"
                if int(b.fib_node_id[i]) >= 0:
                    extra += f" node {int(b.fib_node_id[i])}"
                if int(b.fib_next_hop[i]):
                    extra += f" via {ip4_str(int(b.fib_next_hop[i]))}"
                rows.append(
                    f"  {ip4_str(int(b.fib_prefix[i]))}/{int(plen[i])} "
                    f"-> if {int(b.fib_tx_if[i])} [{disp}]{extra}"
                )
            lines.extend(sorted(rows))
            if len(idx) > len(shown):
                lines.append(f"  ... {len(idx) - len(shown)} more "
                             f"(narrow the filter)")
        return "\n".join(lines)

    def _resolve_rx_if(self, src_ip: int):
        """Longest-prefix FIB match for ``src_ip`` with a LOCAL
        disposition → that pod's interface is where its traffic enters
        the vswitch (the reference's per-pod rx interface). One
        vectorized NumPy pass — the old per-slot Python loop walked
        every slot, unusable at the 1M-route regime."""
        b = self.dp.builder
        plen = np.asarray(b.fib_plen)
        hit = ((np.uint32(src_ip) & np.asarray(b.fib_mask))
               == np.asarray(b.fib_prefix))
        cand = (plen >= 0) & hit & \
            (np.asarray(b.fib_disp) == int(Disposition.LOCAL))
        if not cand.any():
            return None
        best = int(np.argmax(np.where(cand, plen, -1)))
        return int(b.fib_tx_if[best])

    def test_connectivity(self, args: list) -> str:
        """One-shot connectivity probe — the robot-suite ping/TCP checks
        as a vppctl command: inject a synthetic packet, trace its path
        through the pipeline, report the verdict.

        usage: test connectivity <src-ip> <dst-ip> <tcp|udp|icmp> [dport]
        """
        from vpp_tpu_torch.pipeline.vector import ip4, make_packet_vector
        from vpp_tpu_torch.trace.tracer import PacketTracer

        if len(args) < 3:
            return ("usage: test connectivity <src-ip> <dst-ip> "
                    "<tcp|udp|icmp> [dport] [sport]")
        src_s, dst_s, proto_s = args[0], args[1], args[2]
        proto = {"tcp": 6, "udp": 17, "icmp": 1}.get(proto_s.lower())
        if proto is None:
            return f"unknown protocol {proto_s!r} (tcp|udp|icmp)"
        try:
            # strict validation: ip4() would silently wrap octets > 255
            # into neighboring octets and numpy columns overflow on
            # huge ints — a debug tool must reject typos, not probe a
            # different address and return a confident wrong verdict
            import ipaddress as _ipaddress

            _ipaddress.IPv4Address(src_s)
            _ipaddress.IPv4Address(dst_s)
            dport = int(args[3]) if len(args) > 3 else 80
            sport = int(args[4]) if len(args) > 4 else 40000
            if not (0 <= dport <= 65535 and 0 <= sport <= 65535):
                raise ValueError("port out of range 0-65535")
            src_int = ip4(src_s)
        except (ValueError, IndexError) as e:
            # operator typo must degrade to a message, never a
            # traceback out of run() (every command returns a string)
            return f"bad argument: {e}"
        rx_if = self._resolve_rx_if(src_int)
        if rx_if is None:
            return (f"no LOCAL route covers src {src_s} — the probe "
                    "must originate from a pod this node hosts")
        # on the dataplane's device: the probe steps the live tables
        probe = make_packet_vector([{
            "src": src_s, "dst": dst_s, "proto": proto,
            "sport": sport, "dport": dport, "rx_if": rx_if,
        }], device=self.dp.device)
        try:
            # side-effect-free: no session install, no tracer swap; the
            # step runs under the dataplane's _lock (one whole epoch)
            res = self.dp.probe(probe)
        except RuntimeError as e:  # e.g. cluster staging handle
            return f"probe unavailable: {e}"
        tracer = PacketTracer()
        tracer.add(1)
        tracer.record(res)
        head = torch.stack([res.disp[0], res.tx_if[0]]).tolist()
        disp = Disposition(int(head[0]))
        tx_if = int(head[1])
        verdict = {
            Disposition.LOCAL: f"FORWARDED -> if {tx_if}",
            Disposition.REMOTE: f"FORWARDED -> fabric (if {tx_if})",
            Disposition.HOST: "PUNTED to host stack",
            Disposition.DROP: "DROPPED",
        }.get(disp, disp.name)
        entries = tracer.entries()
        trace = entries[0].format() if entries else "(no trace captured)"
        return (f"{src_s} -> {dst_s} {proto_s}/{dport} via if {rx_if}\n"
                f"{trace}\nverdict: {verdict}")

    def show_fleet(self) -> str:
        """Gateway-fleet one-pager: instances, range
        ownership (with fenced ranges called out — those DROP until
        recovered), epoch high-water, migration totals and the
        conservation ledger the steering tier guarantees exactly."""
        fleet = self.fleet
        if fleet is None:
            return "fleet: not configured (single-instance gateway)"
        fs = fleet.stats_snapshot()
        lines = [
            f"fleet: {fs['instances']} instances, {fs['ranges']} "
            f"hash ranges, epoch high-water {fs['epoch_max']}",
        ]
        by_inst: dict = {}
        for rid, owner in sorted(fs["owners"].items()):
            by_inst.setdefault(owner, []).append(rid)
        for inst in sorted(by_inst):
            rids = by_inst[inst]
            lines.append(
                f"  {inst}: {len(rids)} ranges "
                f"({', '.join(str(r) for r in rids[:12])}"
                f"{', ...' if len(rids) > 12 else ''}), "
                f"steered {fs['steered'].get(inst, 0)}")
        if fs["fenced_ranges"]:
            lines.append(
                f"  FENCED: {fs['fenced_ranges']} ranges mid-migration "
                f"(traffic drops attributed; run recover)")
        lines.append(
            f"migrations: {fs['migrated_ranges']} ranges / "
            f"{fs['migrated_sessions']} sessions across "
            f"{fs['rebalances']} rebalances "
            f"({fs['recovered_ranges']} crash-recovered)")
        offered, accounted = fleet.conservation()
        lines.append(
            f"conservation: offered {offered} == steered "
            f"{sum(fs['steered'].values())} + fenced "
            f"{fs['fenced_drops']} + no-owner {fs['no_owner_drops']}"
            f" -> {'EXACT' if offered == accounted else 'VIOLATED'}")
        if self.fleet_pump is not None:
            ps = self.fleet_pump.stats_snapshot()
            lines.append(
                f"pump: delivered {sum(ps['delivered'].values())}, "
                f"queue drops {sum(ps['queue_drops'].values())}, "
                f"pending {self.fleet_pump.pending()}")
            for inst, aux in sorted(ps["aux"].items()):
                rx = aux.get("rx", 0)
                hits = aux.get("sess_hits", 0)
                lines.append(
                    f"  {inst}: rx {rx}, session hits {hits} "
                    f"({100.0 * hits / rx if rx else 0.0:.1f}%)")
        return "\n".join(lines)

    def show_resilience(self) -> str:
        """Crash-consistency + degraded-mode one-pager: the
        snapshot generation/age, which components are degraded, and
        the live reconnect backoff state — the operator's first stop
        after an incident ('did the table survive, and what are we
        running without right now?')."""
        lines = []
        # degraded components (mirrors vpp_tpu_degraded{component=})
        store = self.store
        kv_deg = bool(getattr(store, "degraded", False))
        ring_deg = bool(getattr(self.pump, "degraded_ring", False))
        snap = self.snapshotter
        snap_deg = bool(getattr(snap, "degraded", False))
        flags = []
        if kv_deg:
            stale = store.staleness_s() if hasattr(store, "staleness_s") \
                else 0.0
            flags.append(f"kvstore (serving last-adopted epoch, "
                         f"stale {stale:.1f}s)")
        if ring_deg:
            flags.append("ring (persistent pump fell back to dispatch "
                         "mode)")
        if snap_deg:
            flags.append("snapshot (last attempt failed)")
        lines.append("degraded: " + (", ".join(flags) if flags
                                     else "none"))
        if kv_deg and hasattr(store, "backoff_state"):
            bo = store.backoff_state()
            if bo:
                lines.append(
                    f"kvstore reconnect backoff: attempt "
                    f"{bo.get('attempt', 0)}, last delay "
                    f"{bo.get('last_delay_s', 0.0)}s "
                    f"(base {bo.get('base_s', 0.0)}s, cap "
                    f"{bo.get('cap_s', 0.0)}s)")
        if ring_deg and self.pump is not None:
            lines.append(
                f"ring faults: "
                f"{getattr(self.pump, '_ring_faults', 0)} "
                f"(limit {getattr(self.pump, 'ring_fault_limit', 0)})")
        if snap is None:
            lines.append("snapshot: not configured")
            return "\n".join(lines)
        s = snap.stats_snapshot()
        age = s["age_s"]
        lines.append(
            f"snapshot: generation {s['generation']}, "
            f"age {'-' if age < 0 else f'{age:.1f}s'}, "
            f"{s['snapshots']} published, "
            f"{s['snapshot_failures']} failed")
        lines.append(
            f"snapshot chunks: {s['chunks_written']} written "
            f"({s['bytes_written']} bytes, "
            f"{s['chunk_seconds']:.3f}s), "
            f"{s['chunks_skipped']} skipped clean")
        restores = {k: v for k, v in s["restores"].items() if v}
        lines.append(
            "restores: " + (", ".join(f"{k} {v}" for k, v in
                                      sorted(restores.items()))
                            if restores else "none attempted"))
        if s["last_error"]:
            lines.append(f"last error: {s['last_error']}")
        return "\n".join(lines)

    def show_store(self) -> str:
        """Cluster-store health as THIS agent experiences it: which
        endpoint it is on, the fencing epoch its writes carry, and the
        failover candidates (the etcdctl endpoint-status analog for
        the fenced HA pair, kvstore/witness.py)."""
        store = self.store
        if store is None:
            return "no store handle attached"
        import time as _time

        lines = []
        if hasattr(store, "endpoints"):  # RemoteKVStore
            t0 = _time.perf_counter()
            up = True
            try:
                store.ping()
                rtt = f"{(_time.perf_counter() - t0) * 1e3:.1f} ms"
            except Exception as e:  # noqa: BLE001 — debug path
                up = False
                rtt = f"UNREACHABLE ({type(e).__name__})"
            lines.append(f"connected: {store.host}:{store.port}  "
                         f"ping {rtt}")
            for host, port in store.endpoints:
                mark = " *" if (host, port) == (store.host,
                                                store.port) else ""
                lines.append(f"  endpoint {host}:{port}{mark}")
            epoch = store.fencing_epoch
            # None is ambiguous by design: a pre-fencing server never
            # answers the epoch op, AND a client mid-failover has
            # nulled it until the new primary answers — don't let the
            # label misdiagnose the exact window this command debugs
            lines.append(
                f"fencing epoch: "
                f"{'unknown (pre-fencing server, or refresh pending after failover)' if epoch is None else epoch}"
            )
            if up:
                try:
                    lines.append(f"revision: {store.revision}")
                except Exception as e:  # noqa: BLE001 — debug path
                    lines.append(
                        f"revision: unavailable ({type(e).__name__})")
            else:
                # the ping already burned its timeout; a second doomed
                # request would double the operator's stall
                lines.append("revision: unavailable (server down)")
        else:  # in-process KVStore
            lines.append("in-process store (no HA pair)")
            lines.append(f"revision: {store.revision}, "
                         f"fencing epoch: {store.fencing_epoch}, "
                         f"keys: {len(store.list_keys(''))}")
        return "\n".join(lines)

    def show_kernels(self) -> str:
        """Per-op kernel rung selection: for each
        gather-bound hot op — classifier, fib, session — the knob the
        operator set, the rung the ladder selected, and WHY (backend
        gate, structure gate, explicit knob). The operator view of
        Dataplane.kernel_snapshot(), twinned with the
        vpp_tpu_kernel_impl info gauge family."""
        snap_fn = getattr(self.dp, "kernel_snapshot", None)
        if not callable(snap_fn):
            return "kernels: no dataplane kernel snapshot available"
        snap = snap_fn()
        lines = [
            "kernel implementation ladders "
            f"(backend: {snap['backend']}, pallas "
            f"{'available' if snap['pallas_available'] else 'unavailable'}):",
            f"  {'op':<12} {'knob':<8} {'selected':<9} why",
        ]
        for op in ("classifier", "fib", "session"):
            s = snap[op]
            lines.append(
                f"  {op:<12} {s['knob']:<8} {s['impl']:<9} {s['why']}")
        return "\n".join(lines)

    def show_fastpath(self) -> str:
        """Two-tier dispatch state (pipeline/graph.py): whether the
        classify-free established-flow kernel is engaged, the gating
        knobs, and how much traffic actually rides it — the `show
        acl-plugin sessions`-grade operator view of the fast path."""
        dp = self.dp
        enabled = getattr(dp, "fastpath_enabled", False)
        engaged = getattr(dp, "_use_fastpath", False)
        min_rules = getattr(dp, "fastpath_min_rules", 0)
        lines = [
            "fastpath: {} (engaged: {})".format(
                "enabled" if enabled else "disabled",
                "yes" if engaged else
                f"no — global rules {dp.builder.glb_nrules} < "
                f"min-rules {min_rules}" if enabled else "no",
            ),
            f"  dispatch predicate: all valid packets hit a live "
            f"reflective session, none DNAT-matches",
            f"  global rules: {dp.builder.glb_nrules}, "
            f"min-rules threshold: {min_rules}",
        ]
        t = dp.tables
        if t is not None:
            # live = valid AND not idle-expired — what the dispatch
            # predicate's lookups actually see (an all-expired table
            # must not read as thousands of live sessions here)
            now = max(getattr(dp, "_now", 0), dp.clock_ticks())
            # aggregate ON device (show_sessions rationale): the table
            # is [n_buckets, W] — slots = size, not the bucket count
            with dp._lock:
                valid = t.sess_valid == 1
                fresh_mask = now - t.sess_time <= t.sess_max_age
                live, nvalid = torch.stack(
                    [(valid & fresh_mask).sum(), valid.sum()]).tolist()
            lines.append(
                f"  sessions: {live} live "
                f"of {t.sess_valid.numel()} slots "
                f"({nvalid} valid)"
            )
        if self.pump is not None:
            s = self.pump.stats
            total = int(s.get("batches", 0))
            fastb = int(s.get("fastpath_batches", 0))
            alive = int(s.get("fastpath_alive", 0))
            hits = int(s.get("fastpath_hits", 0))
            pct = 100.0 * hits / alive if alive else 0.0
            lines.append(
                f"  pump: {fastb}/{total} batches on the fast path, "
                f"session-hit {pct:.1f}% ({hits}/{alive} pkts)"
            )
        return "\n".join(lines)

    def show_ml(self) -> str:
        """Per-packet ML stage state (ops/mlscore.py): the
        configured knob vs the LIVE compiled mode, the staged model's
        geometry/thresholds/policy, the verdict counters, and the
        loader's refusal ledger — the `show acl`-grade operator page
        for the scoring stage."""
        dp = self.dp
        b = dp.builder
        knob = getattr(dp, "ml_stage", "off")
        mode = getattr(dp, "_ml_mode", "off")
        kind_code = int(getattr(b, "ml_kind", 0))
        kind = {0: "none", 1: "mlp", 2: "forest"}.get(kind_code, "?")
        lines = [
            f"ml stage: {mode} (knob {knob}, model {kind})",
        ]
        if kind_code:
            from vpp_tpu_torch.ops.mlscore import ML_ACTION_NAMES

            ml = b.ml
            action = ML_ACTION_NAMES.get(
                int(ml["glb_ml_action"]), "?")
            lines.append(
                f"  model: v{int(ml['glb_ml_version'])}, flag-thresh "
                f"{int(ml['glb_ml_thresh'])}, action {action}"
                + (f" (admit 1/{1 << int(ml['glb_ml_rl_shift'])} "
                   f"flagged flows)" if action == "ratelimit" else ""))
            if kind_code == 1:
                f_dim, h = ml["glb_ml_w1"].shape
                lines.append(
                    f"  mlp: {f_dim} features x {h} hidden, requant "
                    f"shift {int(ml['glb_ml_s1'])}")
            else:
                t, d = ml["glb_ml_f_feat"].shape
                lines.append(
                    f"  forest: {t} trees x depth {d} "
                    f"({ml['glb_ml_f_leaf'].shape[1]} leaves)")
        else:
            lines.append("  no model staged (set ml_model_path, or "
                         "TableBuilder.set_ml_model)")
        if self.stats is not None:
            tot = self.stats.totals_snapshot()
            lines.append(
                f"  verdicts: scored {tot.get('ml_scored', 0)}, "
                f"flagged {tot.get('ml_flagged', 0)}, "
                f"drops {tot.get('ml_drops', 0)}")
        if self.pump is not None:
            s = self.pump.stats
            lines.append(
                f"  pump riders: scored {s.get('ml_scored', 0)}, "
                f"flagged {s.get('ml_flagged', 0)}, "
                f"drops {s.get('ml_drops', 0)}")
        src = self.ml_source
        if src is not None:
            st = src.stats_snapshot()
            outcomes = {k: v for k, v in st["outcomes"].items() if v}
            lines.append(
                f"  loader: {st['path']}, "
                + ("DEGRADED (previous model serving), "
                   if st["degraded"] else "")
                + ("loads " + ", ".join(
                    f"{k} {v}" for k, v in sorted(outcomes.items()))
                   if outcomes else "no loads attempted"))
            if st["last_error"]:
                lines.append(f"  last load error: {st['last_error']}")
        return "\n".join(lines)

    def _tel_snapshot(self):
        """Collect-facing telemetry snapshot: the pump's ring-rider
        copy when one exists (persistent mode — host scalars only,
        nothing crosses the device transport at render time), else the
        dataplane's small-plane fetch."""
        fn = getattr(self.pump, "tel_snapshot", None)
        snap = fn() if callable(fn) else None
        if snap is None:
            fn = getattr(self.dp, "telemetry_snapshot", None)
            snap = fn() if callable(fn) else None
        return snap

    def show_latency(self) -> str:
        """Device wire-latency page (ops/telemetry.py): the
        on-device log2 histogram of per-packet rx-enqueue → tx-append
        latency, with p50/p99/p99.9 derived host-side — the `show
        latency` every reflex-plane decision (ROADMAP item 3's
        governor) reads."""
        mode = getattr(self.dp, "_tel_mode", "off")
        if mode == "off":
            return ("telemetry off (set dataplane.telemetry: "
                    "latency | full)")
        snap = self._tel_snapshot()
        if snap is None:
            return f"telemetry {mode}: no samples yet"
        from vpp_tpu_torch.ops.telemetry import quantiles_from_bins

        bins = np.asarray(snap["bins"], np.int64)
        total = int(bins.sum())
        lines = [f"wire latency (telemetry {mode}): {total} packets "
                 f"observed on device"]
        if total:
            p50, p99, p999 = quantiles_from_bins(bins)
            lines.append(
                f"  p50 {p50:.0f}us  p99 {p99:.0f}us  "
                f"p99.9 {p999:.0f}us")
            lines.append(f"  {'bucket':<16} {'count':>10}  share")
            for b, n in enumerate(bins):
                if not n:
                    continue
                lo = (1 << b) if b else 0
                hi = 1 << (b + 1)
                rng = (f"[{lo}us, {hi}us)" if b < len(bins) - 1
                       else f">= {lo}us")
                lines.append(
                    f"  {rng:<16} {int(n):>10}  "
                    f"{100.0 * int(n) / total:5.1f}%")
        return "\n".join(lines)

    def show_top_flows(self) -> str:
        """Heavy-hitter candidates of the device count-min flow sketch:
        the K elected flows with their estimated packet counts — the
        page that names the flows behind a latency spike or DDoS flag
        without ever shipping the session table."""
        mode = getattr(self.dp, "_tel_mode", "off")
        if mode != "full":
            return ("flow sketch off (set dataplane.telemetry: full)")
        snap = self._tel_snapshot()
        if snap is None:
            return "telemetry full: no samples yet"
        cnt = np.asarray(snap["top_cnt"], np.int64)
        order = np.argsort(-cnt)
        lines = [f"top flows ({int(snap['sketched'])} packets "
                 f"sketched; counts are count-min estimates — "
                 f"over-counting possible, never under)"]
        lines.append(f"  {'#':>2} {'flow':<44} {'est-pkts':>10}")
        shown = 0
        for k in order:
            k = int(k)
            if cnt[k] <= 0:
                continue
            ports = int(snap["top_ports"][k])
            flow = (f"{ip4_str(int(snap['top_src'][k]))}:{ports >> 16}"
                    f" -> {ip4_str(int(snap['top_dst'][k]))}"
                    f":{ports & 0xFFFF}")
            lines.append(f"  {shown:>2} {flow:<44} {int(cnt[k]):>10}")
            shown += 1
        if not shown:
            lines.append("  (no candidates elected yet)")
        return "\n".join(lines)

    def show_governor(self) -> str:
        """Reflex-plane latency governor state (io/governor.py):
        operating mode, the live window shape on the ladder, the last control observation, the priority lane's
        counters and the attributed overload shedding — all host
        scalars (nothing crosses the device
        transport for a debug page)."""
        pump = self.pump
        gov = getattr(pump, "governor", None) if pump is not None \
            else None
        if gov is None:
            return ("no latency governor attached "
                    "(io.latency_slo_us = 0 — open-loop pump)")
        s = gov.snapshot()
        lines = [
            f"governor: mode {s['mode']}"
            + (" (WEDGED — window shape frozen)" if s['wedged'] else "")
            + (", shedding bulk" if s['shedding'] else ""),
            f"slo: {s['slo_us']:.0f}us, hysteresis band "
            f"[{s['slo_us'] * (1 - gov.hysteresis_pct / 100.0):.0f}, "
            f"{s['slo_us']:.0f}]us",
            f"window shape: level {s['level']}/{s['levels'] - 1}, "
            f"fill {s['fill']} slots, inflight {s['inflight']}",
            f"last observation: p99 {s['last_p99_us']:.0f}us, "
            f"queue-est {s['queue_est_us']:.0f}us "
            f"(t_svc {s['t_svc_us']:.0f}us/frame), "
            f"avg window fill {s['fill_avg']:.2f}",
            f"control loop: {s['ticks']} ticks "
            f"({s['tick_errors']} errors), steps "
            f"{s['adjust_down']} down / {s['adjust_up']} up, "
            f"transitions " + ", ".join(
                f"{m} {n}" for m, n in sorted(s["transitions"].items())),
        ]
        ps = pump.stats
        lines.append(
            f"priority lane: {ps.get('priority_frames', 0)} frames / "
            f"{ps.get('priority_pkts', 0)} pkts, "
            f"{ps.get('priority_preempts', 0)} window preempts, "
            f"{ps.get('priority_starved', 0)} starved (fault seam)"
        )
        pf = getattr(pump, "priority", None)
        if pf is not None:
            lines.append(
                f"priority rules: {pf.ports.size} ports, "
                f"{pf.prefix_count()} prefixes, {pf.protos.size} "
                f"protos, {pf.flow_count()} marked flows"
            )
        lines.append(
            f"overload shed: {ps.get('drops_overload', 0)} pkts "
            f"(drops_total{{reason=\"overload\"}})"
        )
        return "\n".join(lines)

    def show_tenants(self) -> str:
        """Multi-tenant gateway page (tenancy/):
        per-tenant config (prefixes, token bucket, capacity slice,
        WFQ weight), live device counters (rx/goodput/rate-limit
        drops/slice failures, bucket fill, slice occupancy) and the
        pump's lane state. Host scalars only — the [T] planes cross
        the transport, never table columns."""
        snap_fn = getattr(self.dp, "tenant_snapshot", None)
        snap = snap_fn() if callable(snap_fn) else None
        if snap is None:
            return "tenancy: off (dataplane.tenancy)"
        lines = ["Multi-tenant gateway (dataplane.tenancy: on)"]
        tio = None
        if self.pump is not None and hasattr(self.pump,
                                             "tenant_io_snapshot"):
            tio = self.pump.tenant_io_snapshot()
        reg = snap["tenants"]
        # tenant 0 always renders: it is the implicit default sink for
        # unmatched traffic, whose counters matter MOST once real
        # tenants are registered
        tids = sorted(set(reg) | {0})
        for tid in tids:
            e = reg.get(tid, {})
            name = e.get("name", f"tenant-{tid}")
            lines.append(f"tenant {tid} ({name}):")
            if e.get("prefixes"):
                lines.append(f"  prefixes     {', '.join(e['prefixes'])}")
            if e.get("vni") is not None:
                lines.append(f"  vni          {e['vni']}")
            rate = int(snap["rate"][tid])
            if rate:
                lines.append(
                    f"  bucket       rate {rate}/tick  burst "
                    f"{int(snap['burst'][tid])}  fill "
                    f"{int(snap['tokens'][tid])}")
            else:
                lines.append("  bucket       unlimited (rate 0)")
            lines.append(
                f"  sessions     {int(snap['occupancy'][tid])} live / "
                f"{int(snap['sess_quota_slots'][tid])} slice slots"
                + ("" if e.get("sess_buckets") else " (unsliced)"))
            lines.append(
                f"  counters     rx {int(snap['rx'][tid])}  goodput "
                f"{int(snap['tx'][tid])}  rl-drops "
                f"{int(snap['rl_drops'][tid])}  slice-fails "
                f"{int(snap['quota_fails'][tid])}")
            if e.get("ml_mode", "inherit") != "inherit" \
                    or e.get("ml_thresh") is not None:
                lines.append(
                    f"  ml           mode {e.get('ml_mode', 'inherit')}"
                    + (f"  thresh {e['ml_thresh']}"
                       if e.get("ml_thresh") is not None else ""))
            if tio is not None:
                io = tio["io"].get(tid)
                q = tio["queued"].get(tid)
                w = tio["weights"].get(tid, 1)
                parts = [f"weight {w}"]
                if io:
                    parts.append(
                        f"frames {io['frames']}  pkts {io['pkts']}  "
                        f"shed {io['shed_pkts']}")
                if q:
                    parts.append(f"queued {q['frames']}f/{q['pkts']}p")
                lines.append("  pump         " + "  ".join(parts))
        if self.pump is not None:
            s = self.pump.stats
            lines.append(
                f"totals: quota-drops "
                f"{s.get('drops_tenant_quota', 0)}  slice-fails "
                f"{s.get('tenant_sess_quota_fails', 0)}  starved "
                f"{s.get('tenant_starved', 0)}")
        return "\n".join(lines)

    def show_io(self) -> str:
        """Pump + IO-daemon counters (the `show interface rx-placement`
        / vector-rates analog for the host IO path)."""
        lines = []
        if self.pump is not None:
            s = self.pump.stats
            lat = self.pump.latency_us()
            mode = getattr(self.pump, "mode", "dispatch")
            lines.append(
                f"pump ({mode}): {s['frames']} frames, {s['pkts']} pkts, "
                f"{s['batches']} batches (max coalesce {s['max_coalesce']}"
                f"), tx-ring-full {s['tx_ring_full']}, "
                f"errors {s['batch_errors']}"
            )
            extra = []
            if s.get("fabric_pkts"):
                extra.append(f"fabric {s['fabric_pkts']} pkts")
            if s.get("icmp_errors"):
                extra.append(f"icmp-errors {s['icmp_errors']}")
            if extra:
                lines.append("pump: " + ", ".join(extra))
            if "inflight_peak" in s:
                lines.append(
                    f"pump overlap: inflight {s.get('inflight', 0)} "
                    f"(peak {s['inflight_peak']}), chained dispatches "
                    f"{s.get('chain_batches', 0)} "
                    f"(max K {s.get('chain_k_peak', 0)})"
                )
            if mode == "persistent":
                # device-resident descriptor rings: all
                # HOST-side scalars — occupancy/lag/fill are counted
                # where the windows are staged, so nothing crosses the
                # device transport for this page
                slots = getattr(self.pump, "ring_slots", 0)
                windows = getattr(self.pump, "ring_windows", 0)
                shipped = int(s.get("ring_windows", 0))
                rframes = int(s.get("ring_frames", 0))
                fill = (100.0 * rframes / (shipped * slots)
                        if shipped and slots else 0.0)
                lines.append(
                    f"pump device-ring: {slots} slots x {windows} "
                    f"windows, {shipped} windows shipped "
                    f"({rframes} frames, fill {fill:.0f}%), "
                    f"in-flight {s.get('ring_inflight', 0)}/{windows}, "
                    f"tx-writeback lag {s.get('ring_lag', 0)}, "
                    f"io-callbacks {s.get('io_callbacks', 0)}"
                )
            drops = {k: int(s.get(k, 0)) for k in
                     ("drops_rx_full", "drops_tx_stall",
                      "drops_shutdown", "drops_error",
                      "drops_overload")}
            if any(drops.values()):
                lines.append(
                    "pump drops by cause (pkts): "
                    f"rx-full {drops['drops_rx_full']}, "
                    f"tx-stall {drops['drops_tx_stall']}, "
                    f"shutdown {drops['drops_shutdown']}, "
                    f"error {drops['drops_error']}, "
                    f"overload {drops['drops_overload']}"
                )
            if "t_pack" in s:
                # stage seconds: fetch_wait is overlapped wait (the
                # ladder hiding the device round trip), fetch the
                # serial result copy
                lines.append(
                    "pump stages (s): "
                    f"pack {s['t_pack']:.3f}, "
                    f"dispatch {s['t_dispatch']:.3f}, "
                    f"fetch-wait {s.get('t_fetch_wait', 0.0):.3f}, "
                    f"fetch {s['t_fetch']:.3f}, "
                    f"write {s.get('t_write', 0.0):.3f}"
                )
            lines.append(
                f"pump batch latency: p50 {lat['p50']:.0f}us "
                f"p99 {lat['p99']:.0f}us over {lat['n']} batches"
            )
        # capture guard (pipeline/capture.py, the port's counterpart of
        # the reference's jit-compile guard): capture-once means each
        # step program shows 1; a RECOMPILED marker is a program
        # captured twice — see /debug/jit for table signatures
        from vpp_tpu_torch.pipeline.capture import (
            capture_counts,
            capture_totals,
        )
        from vpp_tpu_torch.pipeline.transfer import device_transfer_totals

        totals = capture_totals()
        if totals:
            lines.append(
                "jit compiles: "
                + ", ".join(f"{k} {v}" for k, v in sorted(totals.items()))
            )
            recomp = {k: n for k, n in capture_counts().items() if n > 1}
            if recomp:
                lines.append(
                    f"jit RECOMPILED ({len(recomp)} step+shape keys "
                    f"traced >1x — compile-once contract broken)"
                )
        # device-transfer guard: bytes fetched per approved site — the serving-path sites must stay rider/descriptor-sized
        xfer = device_transfer_totals()
        if xfer:
            lines.append(
                "device transfer bytes: "
                + ", ".join(f"{k} {v}" for k, v in sorted(xfer.items()))
            )
        if self.io_ctl is not None:
            # the whole block is guarded: the daemon is another process
            # over a socket, so besides being down it may be a different
            # build whose stats dict lacks keys — degrade, never crash
            # the debug CLI
            try:
                d = self.io_ctl.stats()
                ifs = self.io_ctl.list_interfaces()
                lines.append(
                    "io-daemon: rx {rx_frames}f/{rx_pkts}p "
                    "(ring-full {rx_ring_full}, rx-full drops "
                    "{drops_rx_full}p), tx {tx_frames}f/"
                    "{tx_pkts}p, drops {tx_drops}, punts {tx_punts}, "
                    "trunc {trunc_drops}, vxlan {vxlan_encap}e/"
                    "{vxlan_decap}d".format(
                        **{k: d.get(k, "?") for k in (
                            "rx_frames", "rx_pkts", "rx_ring_full",
                            "drops_rx_full",
                            "tx_frames", "tx_pkts", "tx_drops",
                            "tx_punts", "trunc_drops", "vxlan_encap",
                            "vxlan_decap")}
                    )
                )
                lines.append(
                    "io-daemon interfaces: "
                    + (", ".join(f"{i}:{n}" for i, n in sorted(ifs.items()))
                       or "(none)")
                )
            except Exception as e:  # noqa: BLE001 — daemon may be down
                lines.append(f"io-daemon: unreachable ({e})")
        return "\n".join(lines) if lines else "no IO front-end attached"

    def show_neighbors(self) -> str:
        """The IO daemon's (ip → MAC) neighbor table — the `show ip
        arp` analog (static entries from the control plane are marked
        S, rx-learned entries are unmarked)."""
        if self.io_ctl is None:
            return "no IO front-end attached"
        try:
            entries = self.io_ctl.neighbors()
        except Exception as e:  # noqa: BLE001 — daemon may be down
            return f"io-daemon: unreachable ({e})"
        from vpp_tpu_torch.pipeline.vector import ip4_str

        lines = [f"{'ip':<16} {'mac':<18} flags"]
        for ip, mac, pin in sorted(entries):
            mac_s = ":".join(f"{b:02x}" for b in mac)
            lines.append(f"{ip4_str(ip):<16} {mac_s:<18} {'S' if pin else ''}")
        return "\n".join(lines)

    def _live_tracer(self, create: bool = False):
        """The tracer the DATAPLANE records into — arming anything
        else silently captures nothing. Falls back to an explicitly
        injected tracer (in-process test use); ``create`` attaches one
        to the dataplane on demand."""
        t = self.dp.tracer or self.tracer
        if t is None and create:
            from vpp_tpu_torch.trace.tracer import PacketTracer

            t = self.dp.tracer = PacketTracer()
        return t

    def trace_add(self, args: list) -> str:
        """Arm the packet tracer for the next N valid packets (VPP
        `trace add <node> N`): real traffic through the pump takes the
        traced slow path while armed, then reverts to the fused fast
        path."""
        try:
            n = int(args[0]) if args else 16
            if n <= 0:
                raise ValueError("count must be positive")
        except ValueError as e:
            return f"bad argument: {e}"
        tracer = self._live_tracer(create=True)
        if tracer is not self.dp.tracer:
            self.dp.tracer = tracer  # injected tracer: make it live
        tracer.add(n)
        return f"tracing the next {min(n, tracer.max_entries)} packets"

    def trace_clear(self) -> str:
        tracer = self._live_tracer()
        if tracer is None:
            return "no tracer attached"
        tracer.clear()
        return "trace buffer cleared"

    def show_trace(self) -> str:
        tracer = self._live_tracer()
        if tracer is None:
            return "no tracer attached"
        return tracer.format_trace()

    def show_errors(self) -> str:
        if self.stats is None:
            return "no statscollector attached"
        totals = self.stats.totals_snapshot()
        lines = [f"{'counter':<16} {'count':>12}"]
        for k in ("rx", "tx", "drop_ip4", "drop_acl", "drop_no_route", "punt"):
            lines.append(f"{k:<16} {totals[k]:>12}")
        return "\n".join(lines)


def main(argv=None) -> int:
    """Delegates to vpp-tpu-ctl, the vppctl analog: it speaks the
    running agent's CLI socket (cmd/config.py cli_socket)."""
    from vpp_tpu_torch.cmd.ctl import main as ctl_main

    return ctl_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
