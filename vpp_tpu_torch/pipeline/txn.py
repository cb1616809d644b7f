"""Declarative config transactions: record, apply, journal, replay.

The reference's NB config path is transactional and *recorded*: the
vpp-agent localclient DSL collects Put/Delete ops into a transaction,
applies it as one unit, and VPP's api-trace keeps a replayable record of
every binary-API message (docker/vpp-vswitch/contiv-vswitch.conf:13-15
`api-trace { on }`; mock/localclient's TxnTracker is the test-side
realization — SURVEY.md §4). This module is the declarative record
and replay beside the builder's *apply* side (TableBuilder + epoch
swap), a copy of the reference's ``vpp_tpu/pipeline/txn.py``: the JSONL
journal is byte for byte the same format, so a journal written by
either package replays in the other. A ``ConfigTxn`` is a list of declarative ops
(plain data, JSON-serializable) that maps 1:1 onto TableBuilder
mutators. Ops can be

  * **applied** atomically to a Dataplane (stage all ops + one swap
    under the commit lock),
  * **journaled** to an append-only JSONL file (the api-trace analog:
    every applied txn is replayable and auditable),
  * **replayed** from a journal against a fresh builder — config
    recovery / debugging an exact config history on another machine.

Rule lists serialize through ``rule_to_dict``/``rule_from_dict`` so a
journal is self-contained text.
"""

from __future__ import annotations

import ipaddress
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from vpp_tpu_torch.ir.rule import ANY_PORT, Action, ContivRule, Protocol
from vpp_tpu_torch.pipeline.vector import Disposition
from vpp_tpu_torch.trace import spans


# --- rule (de)serialization ---
def rule_to_dict(r: ContivRule) -> Dict[str, Any]:
    return {
        "action": int(r.action),
        "src": str(r.src_network) if r.src_network is not None else None,
        "dst": str(r.dest_network) if r.dest_network is not None else None,
        "proto": int(r.protocol),
        "sport": r.src_port,
        "dport": r.dest_port,
    }


def rule_from_dict(d: Dict[str, Any]) -> ContivRule:
    return ContivRule(
        action=Action(d["action"]),
        src_network=(ipaddress.ip_network(d["src"])
                     if d.get("src") else None),
        dest_network=(ipaddress.ip_network(d["dst"])
                      if d.get("dst") else None),
        protocol=Protocol(d["proto"]),
        src_port=d.get("sport", ANY_PORT),
        dest_port=d.get("dport", ANY_PORT),
    )


# op name -> TableBuilder method; the txn layer is a thin declarative
# skin over the builder, so the set of legal ops IS the builder API
_OPS = (
    "set_interface", "set_if_local_table", "add_route", "del_route",
    "set_nh_group", "del_nh_group",
    "set_local_table", "clear_local_table", "set_global_table",
    "set_nat_mapping", "clear_nat", "set_snat_ip",
    "set_ml_model", "clear_ml_model",
    "set_tenant", "clear_tenants", "set_tenant_ml",
    "set_service", "del_service", "clear_services", "set_vtep_ip",
)
_RULE_OPS = {"set_local_table", "set_global_table"}


@dataclass
class ConfigTxn:
    """One declarative transaction: ordered ops + optional label."""

    label: str = ""
    ops: List[Dict[str, Any]] = field(default_factory=list)

    def _record(self, op: str, **kw: Any) -> "ConfigTxn":
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}")
        self.ops.append({"op": op, **kw})
        return self

    # --- the DSL (mirrors TableBuilder's mutators) ---
    def set_interface(self, if_index: int, if_type: int,
                      local_table: int = -1,
                      apply_global: bool = False) -> "ConfigTxn":
        return self._record("set_interface", if_index=if_index,
                            if_type=int(if_type),
                            local_table=local_table,
                            apply_global=bool(apply_global))

    def set_if_local_table(self, if_index: int, slot: int) -> "ConfigTxn":
        return self._record("set_if_local_table", if_index=if_index,
                            slot=slot)

    def add_route(self, prefix: str, tx_if: int, disposition: int,
                  next_hop: int = 0, node_id: int = -1,
                  snat: bool = False,
                  slot: Optional[int] = None,
                  group: Optional[int] = None) -> "ConfigTxn":
        """``slot`` pins the FIB slot (recorded from the builder's
        resolved placement, so replay reproduces byte-identical
        tables); None lets replay allocate. ``group`` names an ECMP
        next-hop group."""
        kw = dict(prefix=prefix, tx_if=tx_if,
                  disposition=int(disposition), next_hop=next_hop,
                  node_id=node_id, snat=bool(snat))
        if slot is not None:
            kw["slot"] = int(slot)
        if group is not None:
            kw["group"] = int(group)
        return self._record("add_route", **kw)

    def del_route(self, prefix: str) -> "ConfigTxn":
        return self._record("del_route", prefix=prefix)

    # --- ECMP next-hop groups ---
    def set_nh_group(self, gid: int, members) -> "ConfigTxn":
        """``members`` is the distinct member list as
        TableBuilder.set_nh_group normalizes it — plain JSON rows
        ``[next_hop, tx_if, node_id]``. Replay reruns the sticky way
        fill deterministically (the same registry always compiles the
        same assignment)."""
        return self._record("set_nh_group", gid=int(gid),
                            members=[list(m) for m in members])

    def del_nh_group(self, gid: int) -> "ConfigTxn":
        return self._record("del_nh_group", gid=int(gid))

    def set_local_table(self, slot: int,
                        rules: Sequence[ContivRule]) -> "ConfigTxn":
        return self._record("set_local_table", slot=slot,
                            rules=[rule_to_dict(r) for r in rules])

    def clear_local_table(self, slot: int) -> "ConfigTxn":
        return self._record("clear_local_table", slot=slot)

    def set_global_table(self, rules: Sequence[ContivRule]) -> "ConfigTxn":
        return self._record("set_global_table",
                            rules=[rule_to_dict(r) for r in rules])

    def set_nat_mapping(self, slot: int, ext_ip: int, ext_port: int,
                        proto: int, backends: Sequence[tuple],
                        boff: int, self_snat: bool = False) -> "ConfigTxn":
        return self._record("set_nat_mapping", slot=slot, ext_ip=ext_ip,
                            ext_port=ext_port, proto=proto,
                            backends=[list(b) for b in backends],
                            boff=boff, self_snat=bool(self_snat))

    def clear_nat(self) -> "ConfigTxn":
        return self._record("clear_nat")

    def set_snat_ip(self, ip: int) -> "ConfigTxn":
        return self._record("set_snat_ip", ip=ip)

    # --- VXLAN overlay + service LB ---
    def set_vtep_ip(self, ip: int) -> "ConfigTxn":
        return self._record("set_vtep_ip", ip=ip)

    def set_service(self, vip_ip: int, port: int, proto: int,
                    backends: Sequence[tuple],
                    self_snat: bool = False) -> "ConfigTxn":
        """``backends`` is the distinct backend list as
        TableBuilder.set_service normalizes it — plain JSON rows
        ``[ip, port, weight]``. Replay reruns the sticky way fill
        deterministically (the set_nh_group journaling rationale)."""
        return self._record("set_service", vip_ip=int(vip_ip),
                            port=int(port), proto=int(proto),
                            backends=[list(b) for b in backends],
                            self_snat=bool(self_snat))

    def del_service(self, vip_ip: int, port: int,
                    proto: int) -> "ConfigTxn":
        return self._record("del_service", vip_ip=int(vip_ip),
                            port=int(port), proto=int(proto))

    def clear_services(self) -> "ConfigTxn":
        return self._record("clear_services")

    def set_ml_model(self, model) -> "ConfigTxn":
        """``model`` is an MlModel or its JSON dict form; the journal
        stores the dict (tiny — a few hundred int8 weights), so replay
        reproduces the exact staged blob."""
        if hasattr(model, "to_dict"):
            model = model.to_dict()
        return self._record("set_ml_model", model=model)

    def clear_ml_model(self) -> "ConfigTxn":
        return self._record("clear_ml_model")

    # --- multi-tenant gateway mode ---
    def set_tenant(self, tid: int, **kw: Any) -> "ConfigTxn":
        """``kw`` is the tenant entry as TableBuilder.set_tenant takes
        it (prefixes/vni/rate/burst/slices/weight/ml_*) — plain JSON
        data, so the journal replays the exact staged tenant."""
        return self._record("set_tenant", tid=int(tid), **kw)

    def clear_tenants(self) -> "ConfigTxn":
        return self._record("clear_tenants")

    def set_tenant_ml(self, tid: int, ml_mode: str = "inherit",
                      ml_thresh: Optional[int] = None) -> "ConfigTxn":
        return self._record("set_tenant_ml", tid=int(tid),
                            ml_mode=ml_mode, ml_thresh=ml_thresh)

    # --- apply / serialize ---
    def apply_to_builder(self, builder) -> None:
        """Stage every op on a TableBuilder (no swap — the caller owns
        the commit boundary)."""
        for entry in self.ops:
            op = entry["op"]
            kw = {k: v for k, v in entry.items() if k != "op"}
            if op in _RULE_OPS:
                kw["rules"] = [rule_from_dict(d) for d in kw["rules"]]
            if op in ("set_nat_mapping", "set_service"):
                kw["backends"] = [tuple(b) for b in kw["backends"]]
            if op == "add_route":
                kw["disposition"] = Disposition(kw["disposition"])
            getattr(builder, op)(**kw)

    def to_dict(self) -> Dict[str, Any]:
        return {"label": self.label, "ops": self.ops}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ConfigTxn":
        return cls(label=d.get("label", ""), ops=list(d.get("ops", [])))


class TxnJournal:
    """Append-only JSONL record of applied transactions (api-trace
    analog). Thread-safe; replayable."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._lock = threading.Lock()
        self.applied = 0
        # torn trailing lines tolerated by the last load() (crash
        # mid-append); surfaced by `show config-history`
        self.torn_lines = 0

    def record(self, txn: ConfigTxn, epoch: int) -> None:
        entry = {"t": time.time(), "epoch": epoch, **txn.to_dict()}
        with self._lock:
            self.applied += 1
            if not self.path:
                return
            with open(self.path, "a") as f:
                f.write(json.dumps(entry, separators=(",", ":")) + "\n")
                # fsync: the journal IS the config-recovery record; a
                # crash right after apply_txn must not lose the txn the
                # live dataplane already enforced (same discipline as
                # the kvstore snapshots)
                f.flush()
                os.fsync(f.fileno())

    def load_entries(self) -> List[Dict[str, Any]]:
        """Raw journal entries (t/epoch/label/ops dicts) in file order.

        A torn TRAILING line — the crash-mid-append case: record()
        appends then fsyncs, so a kill between write() and the page
        hitting disk can leave a truncated last line — is tolerated and
        counted in ``torn_lines`` instead of raising. A malformed line
        with valid entries AFTER it is real corruption and still
        raises: silently skipping it would replay a history the live
        dataplane never enforced."""
        self.torn_lines = 0
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            lines = [(i, ln.strip()) for i, ln in enumerate(f, 1)]
        lines = [(i, ln) for i, ln in lines if ln]
        out: List[Dict[str, Any]] = []
        for pos, (lineno, line) in enumerate(lines):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if pos == len(lines) - 1:
                    self.torn_lines = 1
                    break
                raise json.JSONDecodeError(
                    f"corrupt journal line {lineno} (not the trailing "
                    f"line — refusing to skip mid-history)", line, 0)
        return out

    def load(self) -> List[ConfigTxn]:
        return [ConfigTxn.from_dict(d) for d in self.load_entries()]

    def load_tail_entries(self, limit: int,
                          max_bytes: int = 1 << 20) -> List[Dict[str, Any]]:
        """The last ``limit`` raw entries, reading at most ``max_bytes``
        from the file END — the /debug/txns serving path must stay
        O(limit) however large a long-lived agent's journal grows.
        Torn-trailing-line tolerance matches load_entries(); a line cut
        at the seek boundary is discarded (it has complete entries
        after it, so it is a window artifact, not corruption)."""
        self.torn_lines = 0
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            start = max(0, size - max_bytes)
            f.seek(start)
            data = f.read().decode(errors="replace")
        lines = data.splitlines()
        if start > 0 and lines:
            lines = lines[1:]  # first line may start mid-entry
        lines = [ln.strip() for ln in lines if ln.strip()]
        out: List[Dict[str, Any]] = []
        for pos, line in enumerate(lines):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if pos == len(lines) - 1:
                    self.torn_lines = 1
                    break
                raise json.JSONDecodeError(
                    "corrupt journal line in tail window (not the "
                    "trailing line — refusing to skip mid-history)",
                    line, 0)
        return out[-limit:]

    def replay(self, builder) -> int:
        """Re-stage every journaled txn in order onto ``builder``;
        returns the txn count. The caller swaps once at the end —
        replay is a bulk restore, not a re-enactment of every epoch."""
        txns = self.load()
        for txn in txns:
            txn.apply_to_builder(builder)
        return len(txns)


def apply_txn(dataplane, txn: ConfigTxn,
              journal: Optional[TxnJournal] = None) -> int:
    """Apply one declarative transaction atomically: stage all ops and
    publish ONE new epoch under the commit lock (the localclient
    Send().ReceiveReply() analog). Returns the new epoch.

    All-or-nothing: a failing op (FIB full, slot out of range, …) rolls
    the builder back to its pre-txn snapshot, so the next unrelated
    commit can never publish a half-applied transaction. Journaling
    happens INSIDE the commit lock — entries land in epoch order, so a
    replay reconstructs exactly the history the live dataplane enforced.

    The whole stage+swap commit runs under a "txn" span, so an applied
    txn's timeline attributes staging separately from the epoch swap
    (the swap opens its own child span and feeds the
    ``vpp_tpu_txn_commit_seconds`` histogram)."""
    with spans.RECORDER.span(
        "txn", f"apply-txn {txn.label or '(unlabelled)'}",
        ops=len(txn.ops),
    ):
        with dataplane.commit_lock:
            snap = dataplane.builder.state_snapshot()
            try:
                txn.apply_to_builder(dataplane.builder)
            except Exception:
                dataplane.builder.state_restore(snap)
                raise
            epoch = dataplane.swap()
            # a dataplane with its own journal + recording already
            # recorded this txn during swap(); only record here when the
            # caller's journal is a different one (or the dataplane has
            # none)
            if journal is not None and journal is not dataplane.journal:
                journal.record(txn, epoch)
    return epoch
