"""RendererCache: shared cache computing minimal table diffs for renderers.

The cache folds each pod's ingress+egress ContivRules into a single chosen
orientation, groups identical per-pod rule sets into shared *local tables*,
maintains one node-*global table*, and lets a renderer transaction compute
the minimal set of table changes (`get_changes`) needed to reach the new
configuration.

Orientation semantics (from the vswitch point of view):
- INGRESS: tables match traffic *arriving* from interfaces into the vswitch
  (local table rules have src addr/port wildcarded).
- EGRESS: tables match traffic *leaving* the vswitch through interfaces
  (local table rules have dst addr/port wildcarded).

Reference: plugins/policy/renderer/cache/{cache_api.go,cache_impl.go,
local_tables.go,ports.go} — semantics reproduced, implementation re-done
in Python (sorted lists + dict indexes instead of Go slices/maps).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from vpp_tpu_torch.ir.rule import (
    ANY_PORT,
    Action,
    ContivRule,
    IPNetwork,
    PodID,
    Protocol,
    allow_all_tcp,
    allow_all_udp,
    compare_rule_lists,
)
from vpp_tpu_torch.ir.table import GLOBAL_TABLE_ID, ContivRuleTable, TableType
from vpp_tpu_torch.renderer.api import PodConfig


class Orientation(enum.IntEnum):
    INGRESS = 0
    EGRESS = 1


@dataclass
class TxnChange:
    """One table-level change computed by a transaction.

    ``previous_pods`` is the set of pods previously assigned to the table
    (empty for the global table or a newly added local table).
    """

    table: ContivRuleTable
    previous_pods: Set[PodID] = field(default_factory=set)

    def __str__(self) -> str:
        prev = ", ".join(sorted(str(p) for p in self.previous_pods))
        return f"Change <table: {self.table}, prevPods: [{prev}]>"


# --- Port-set algebra (reference: renderer/cache/ports.go) -----------------

ANY_PORTS = frozenset({ANY_PORT})


def _ports_is_subset(p: Set[int], p2: Set[int]) -> bool:
    if ANY_PORT in p2:
        return True
    if ANY_PORT in p:
        return False
    return all(port in p2 for port in p)


def _ports_intersection(p: Set[int], p2: Set[int]) -> Set[int]:
    if ANY_PORT in p:
        return set(p2)
    if ANY_PORT in p2:
        return set(p)
    return {port for port in p if port in p2}


def _get_allowed_egress_ports(
    src_ip: Optional[IPNetwork], egress: List[ContivRule]
) -> Tuple[Set[int], Set[int]]:
    """Allowed destination (TCP, UDP) ports for traffic *from* src_ip wrt.
    the given egress rules. Reference: ports.go getAllowedEgressPorts."""
    tcp: Set[int] = set()
    udp: Set[int] = set()
    has_deny = False
    for rule in egress:
        if rule.action == Action.DENY:
            # Assumes the only deny rule is the default deny-all (TCP&UDP).
            has_deny = True
            continue
        if (
            rule.src_network is not None
            and src_ip is not None
            and src_ip.network_address not in rule.src_network
        ):
            continue
        # The port algebra models TCP/UDP only; ANY contributes to both,
        # ICMP (portless) to neither — ICMP rules are enforced directly by
        # the data-plane tables, not by this fold.
        if rule.protocol in (Protocol.TCP, Protocol.ANY):
            tcp.add(rule.dest_port)
        if rule.protocol in (Protocol.UDP, Protocol.ANY):
            udp.add(rule.dest_port)
    if not has_deny:
        return set(ANY_PORTS), set(ANY_PORTS)
    return tcp, udp


def _get_allowed_ingress_ports(
    dst_ip: Optional[IPNetwork], ingress: List[ContivRule]
) -> Tuple[Set[int], Set[int]]:
    """Allowed destination (TCP, UDP) ports for traffic *to* dst_ip wrt.
    the given ingress rules. Reference: ports.go getAllowedIngressPorts."""
    tcp: Set[int] = set()
    udp: Set[int] = set()
    has_deny = False
    for rule in ingress:
        if rule.action == Action.DENY:
            has_deny = True
            continue
        if (
            rule.dest_network is not None
            and dst_ip is not None
            and dst_ip.network_address not in rule.dest_network
        ):
            continue
        if rule.protocol in (Protocol.TCP, Protocol.ANY):
            tcp.add(rule.dest_port)
        if rule.protocol in (Protocol.UDP, Protocol.ANY):
            udp.add(rule.dest_port)
    if not has_deny:
        return set(ANY_PORTS), set(ANY_PORTS)
    return tcp, udp


# --- Local-table collection (reference: renderer/cache/local_tables.go) ----


class LocalTables:
    """Collection of local tables ordered by rule lists, with ID/pod indexes.

    A pod is assigned to at most one table at any time.
    """

    def __init__(self) -> None:
        self.tables: List[ContivRuleTable] = []
        self.by_id: Dict[str, ContivRuleTable] = {}
        self.by_pod: Dict[PodID, ContivRuleTable] = {}

    def __iter__(self):
        return iter(list(self.tables))

    def _lookup_idx_by_rules(self, rules: List[ContivRule]) -> int:
        lo, hi = 0, len(self.tables)
        while lo < hi:
            mid = (lo + hi) // 2
            if compare_rule_lists(self.tables[mid].rules, rules) < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def insert(self, table: ContivRuleTable) -> bool:
        if table.id in self.by_id:
            return False
        idx = self._lookup_idx_by_rules(table.rules)
        self.tables.insert(idx, table)
        self.by_id[table.id] = table
        for pod in list(table.pods):
            self.unassign_pod(None, pod)
            self.by_pod[pod] = table
        return True

    def remove(self, table: ContivRuleTable) -> bool:
        if table.id not in self.by_id:
            return False
        self.tables.remove(self.by_id[table.id])
        del self.by_id[table.id]
        for pod in table.pods:
            self.by_pod.pop(pod, None)
        return True

    def assign_pod(self, table: ContivRuleTable, pod: PodID) -> None:
        self.unassign_pod(None, pod)
        table.pods.add(pod)
        self.by_pod[pod] = table

    def unassign_pod(self, table: Optional[ContivRuleTable], pod: PodID) -> None:
        if table is not None:
            table.pods.discard(pod)
        assigned = self.by_pod.get(pod)
        if assigned is not None and (table is None or table is assigned):
            assigned.pods.discard(pod)
            del self.by_pod[pod]

    def lookup_by_id(self, table_id: str) -> Optional[ContivRuleTable]:
        return self.by_id.get(table_id)

    def lookup_by_rules(self, rules: List[ContivRule]) -> Optional[ContivRuleTable]:
        idx = self._lookup_idx_by_rules(rules)
        if idx < len(self.tables) and compare_rule_lists(rules, self.tables[idx].rules) == 0:
            return self.tables[idx]
        return None

    def lookup_by_pod(self, pod: PodID) -> Optional[ContivRuleTable]:
        return self.by_pod.get(pod)

    def get_isolated_pods(self) -> Set[PodID]:
        return {pod for pod, table in self.by_pod.items() if table.num_of_rules > 0}


# --- The cache itself -------------------------------------------------------


class RendererCache:
    """See module docstring. Reference: renderer/cache/cache_impl.go."""

    def __init__(self, orientation: Orientation = Orientation.INGRESS):
        self.orientation = orientation
        self._next_table_id = 0
        self.flush()

    def flush(self) -> None:
        self.config: Dict[PodID, PodConfig] = {}
        self.local_tables = LocalTables()
        self.global_table = ContivRuleTable(GLOBAL_TABLE_ID)

    def new_txn(self) -> "RendererCacheTxn":
        return RendererCacheTxn(self)

    def resync(self, tables: Iterable[ContivRuleTable]) -> None:
        """Replace cache content with dumped tables (e.g. from the device).

        Only the set of tracked pods can be reconstructed, not per-pod rule
        configs — follow a resync with a txn updating still-present pods and
        removing the rest.
        """
        config: Dict[PodID, PodConfig] = {}
        allocated: Set[str] = set()
        local = LocalTables()
        global_table = ContivRuleTable(GLOBAL_TABLE_ID)

        for table in tables:
            if table is None:
                continue
            # Copy: the cache must own its tables — later commits mutate pod
            # assignments in place and must not corrupt the caller's dump
            # (or another cache still holding the same objects).
            table = table.copy()
            if table.type == TableType.GLOBAL:
                global_table = table
                continue
            if not table.pods:
                continue
            if table.id in allocated:
                raise ValueError(f"duplicate ContivRuleTable ID: {table.id}")
            allocated.add(table.id)
            for pod in table.pods:
                if pod in config:
                    raise ValueError(f"pod assigned to multiple local tables: {pod}")
                config[pod] = PodConfig()
            local.insert(table)

        self.config = config
        self.local_tables = local
        self.global_table = global_table
        # Never reuse an ID from the dump: bump the generator counter past
        # any counter-shaped IDs (arbitrary foreign IDs cannot collide with
        # the "T%08d" namespace).
        for table_id in allocated:
            if table_id.startswith("T") and table_id[1:].isdigit():
                self._next_table_id = max(self._next_table_id, int(table_id[1:]) + 1)

    # View
    def get_pod_config(self, pod: PodID) -> Optional[PodConfig]:
        return self.config.get(pod)

    def get_all_pods(self) -> Set[PodID]:
        return set(self.config.keys())

    def get_isolated_pods(self) -> Set[PodID]:
        return self.local_tables.get_isolated_pods()

    def get_local_table_by_pod(self, pod: PodID) -> Optional[ContivRuleTable]:
        table = self.local_tables.lookup_by_pod(pod)
        if table is not None and table.num_of_rules == 0:
            return None
        return table

    def get_global_table(self) -> ContivRuleTable:
        return self.global_table

    def _generate_table_id(self) -> str:
        # Monotonic counter: IDs are never reused, so no tracking set is
        # needed (an abandoned transaction merely skips a few IDs).
        table_id = f"T{self._next_table_id:08d}"
        self._next_table_id += 1
        return table_id


class RendererCacheTxn:
    """Transaction over RendererCache; computes tables lazily on demand."""

    def __init__(self, cache: RendererCache):
        self.cache = cache
        self.config: Dict[PodID, PodConfig] = {}
        self.local_tables = LocalTables()
        self.global_table: Optional[ContivRuleTable] = None
        self._up_to_date = False

    # -- updates
    def update(self, pod: PodID, pod_config: PodConfig) -> None:
        self.config[pod] = pod_config
        self._up_to_date = False

    def get_updated_pods(self) -> Set[PodID]:
        return set(self.config.keys())

    def get_removed_pods(self) -> Set[PodID]:
        return {pod for pod, cfg in self.config.items() if cfg.removed}

    # -- view (as-if-committed)
    def get_pod_config(self, pod: PodID) -> Optional[PodConfig]:
        if pod in self.config:
            return self.config[pod]
        return self.cache.get_pod_config(pod)

    def get_all_pods(self) -> Set[PodID]:
        pods = self.cache.get_all_pods()
        for pod, cfg in self.config.items():
            if cfg.removed:
                pods.discard(pod)
            else:
                pods.add(pod)
        return pods

    def get_isolated_pods(self) -> Set[PodID]:
        # After _refresh_tables every tracked pod has an assignment in the
        # txn's table collection, so the txn view is authoritative.
        if not self._up_to_date:
            self._refresh_tables()
        return self.local_tables.get_isolated_pods()

    def get_local_table_by_pod(self, pod: PodID) -> Optional[ContivRuleTable]:
        if not self._up_to_date:
            self._refresh_tables()
        table = self.local_tables.lookup_by_pod(pod)
        if table is None:
            table = self.cache.local_tables.lookup_by_pod(pod)
        if table is not None and table.num_of_rules == 0:
            return None
        return table

    def get_global_table(self) -> ContivRuleTable:
        if not self._up_to_date:
            self._refresh_tables()
        return self.global_table if self.global_table is not None else self.cache.global_table

    # -- diff + commit
    def get_changes(self) -> List[TxnChange]:
        if not self._up_to_date:
            self._refresh_tables()
        changes: List[TxnChange] = []
        for txn_table in self.local_tables:
            orig = self.cache.local_tables.lookup_by_id(txn_table.id)
            if txn_table.num_of_rules == 0:
                continue
            if not txn_table.pods and orig is None:
                continue  # added and removed within the same txn
            if orig is not None and txn_table.pods == orig.pods:
                continue  # unchanged
            changes.append(
                TxnChange(
                    table=txn_table,
                    previous_pods=set(orig.pods) if orig is not None else set(),
                )
            )
        if self.global_table is not None and compare_rule_lists(
            self.global_table.rules, self.cache.global_table.rules
        ):
            changes.append(TxnChange(table=self.global_table))
        return changes

    def commit(self) -> None:
        if not self._up_to_date:
            self._refresh_tables()
        for txn_table in self.local_tables:
            orig = self.cache.local_tables.lookup_by_id(txn_table.id)
            if orig is not None:
                if not txn_table.pods:
                    self.cache.local_tables.remove(orig)
                elif txn_table.pods != orig.pods:
                    for pod in set(orig.pods):
                        if pod not in txn_table.pods:
                            self.cache.local_tables.unassign_pod(orig, pod)
                    for pod in set(txn_table.pods):
                        if pod not in orig.pods:
                            self.cache.local_tables.assign_pod(orig, pod)
                    orig.private = txn_table.private
            else:
                # Rule-less tables (unisolated/removed pods) are never
                # installed; they only exist to carry assignment changes.
                if txn_table.pods and txn_table.num_of_rules > 0:
                    self.cache.local_tables.insert(txn_table)
        if self.global_table is not None and compare_rule_lists(
            self.global_table.rules, self.cache.global_table.rules
        ):
            self.cache.global_table = self.global_table
        for pod, cfg in self.config.items():
            if cfg.removed:
                self.cache.config.pop(pod, None)
                self.cache.local_tables.unassign_pod(None, pod)
            else:
                self.cache.config[pod] = cfg
        # Prune local tables left with no assigned pods.
        for table in list(self.cache.local_tables):
            if not table.pods:
                self.cache.local_tables.remove(table)

    # -- table building (reference: cache_impl.go refreshTables et al.)
    def _refresh_tables(self) -> None:
        for pod in self.get_all_pods() | self.get_removed_pods():
            pod_cfg = self.get_pod_config(pod)
            if pod_cfg is None:
                continue
            new_table = self._build_local_table(pod, pod_cfg)

            # Pull the pod's original table into the txn if not already there.
            orig = self.cache.local_tables.lookup_by_pod(pod)
            if orig is not None and self.local_tables.lookup_by_id(orig.id) is None:
                self.local_tables.insert(orig.copy())

            # Shared with another table already in the txn?
            txn_table = self.local_tables.lookup_by_rules(new_table.rules)
            if txn_table is not None:
                self.local_tables.assign_pod(txn_table, pod)
                continue

            # Shared with a cache table not yet copied into the txn?
            cache_table = self.cache.local_tables.lookup_by_rules(new_table.rules)
            if cache_table is not None:
                updated = cache_table.copy()
                updated.pods.add(pod)
                self.local_tables.insert(updated)
                self.local_tables.assign_pod(updated, pod)
                continue

            self.local_tables.insert(new_table)
            self.local_tables.assign_pod(new_table, pod)

        self._rebuild_global_table()
        self._up_to_date = True

    def _build_local_table(self, dst_pod: PodID, dst_cfg: PodConfig) -> ContivRuleTable:
        table = ContivRuleTable(self.cache._generate_table_id(), TableType.LOCAL)
        table.pods.add(dst_pod)
        if dst_cfg.removed:
            return table

        # Rules already in the cache orientation are copied verbatim.
        own_rules = dst_cfg.egress if self.cache.orientation == Orientation.EGRESS else dst_cfg.ingress
        for rule in own_rules:
            table.insert_rule(rule)

        # Combine with the opposite direction of every pod on the node.
        for src_pod in self.get_all_pods():
            src_cfg = self.get_pod_config(src_pod)
            if src_cfg is not None:
                self._install_local_rules(table, dst_cfg, src_cfg)

        # Explicitly allow traffic not matched by any rule. A rule counts as
        # "total" for its protocol only if every match dimension is
        # wildcarded (the reference omits the src_port check because its
        # configurator never emits src-port rules; our IR allows them, so
        # check it — otherwise a src-port-specific permit would suppress
        # the allow-all append and default-deny everything else).
        if table.rules:
            all_tcp = any(
                r.dest_port == ANY_PORT and r.src_port == ANY_PORT
                and r.src_network is None and r.dest_network is None
                and r.protocol == Protocol.TCP
                for r in table.rules
            )
            all_udp = any(
                r.dest_port == ANY_PORT and r.src_port == ANY_PORT
                and r.src_network is None and r.dest_network is None
                and r.protocol == Protocol.UDP
                for r in table.rules
            )
            if not all_tcp:
                table.insert_rule(allow_all_tcp())
            if not all_udp:
                table.insert_rule(allow_all_udp())
        return table

    def _install_local_rules(
        self, dst_table: ContivRuleTable, dst_cfg: PodConfig, src_cfg: PodConfig
    ) -> None:
        """Fold the opposite-direction rules of src pod into dst pod's table,
        preserving the combined ingress∧egress semantic in one orientation."""
        egress_oriented = self.cache.orientation == Orientation.EGRESS
        if egress_oriented:
            src_tcp, src_udp = _get_allowed_ingress_ports(dst_cfg.pod_ip, src_cfg.ingress)
            dst_tcp, dst_udp = _get_allowed_egress_ports(src_cfg.pod_ip, dst_cfg.egress)
        else:
            src_tcp, src_udp = _get_allowed_egress_ports(dst_cfg.pod_ip, src_cfg.egress)
            dst_tcp, dst_udp = _get_allowed_ingress_ports(src_cfg.pod_ip, dst_cfg.ingress)

        if not _ports_is_subset(dst_tcp, src_tcp):
            self._install_allowed_ports(
                dst_table, src_cfg.pod_ip, _ports_intersection(dst_tcp, src_tcp), Protocol.TCP
            )
        if not _ports_is_subset(dst_udp, src_udp):
            self._install_allowed_ports(
                dst_table, src_cfg.pod_ip, _ports_intersection(dst_udp, src_udp), Protocol.UDP
            )

    def _install_allowed_ports(
        self,
        dst_table: ContivRuleTable,
        src_pod_ip: Optional[IPNetwork],
        allowed_ports: Set[int],
        protocol: Protocol,
    ) -> None:
        egress_oriented = self.cache.orientation == Orientation.EGRESS

        # Remove the rule subtree rooted at the src pod's one-host subnet.
        def against_src_pod(rule: ContivRule) -> bool:
            if rule.protocol != protocol:
                return False
            net = rule.src_network if egress_oriented else rule.dest_network
            if net is None or src_pod_ip is None:
                return False
            return (
                net.prefixlen == net.max_prefixlen
                and net.network_address == src_pod_ip.network_address
            )

        dst_table.remove_by_predicate(against_src_pod)

        # Explicit rule per allowed port + deny-the-rest.
        for port in allowed_ports:
            kwargs = dict(
                action=Action.PERMIT,
                protocol=protocol,
                src_port=ANY_PORT,
                dest_port=port,
            )
            if egress_oriented:
                kwargs["src_network"] = src_pod_ip
            else:
                kwargs["dest_network"] = src_pod_ip
            dst_table.insert_rule(ContivRule(**kwargs))
        kwargs = dict(
            action=Action.DENY,
            protocol=protocol,
            src_port=ANY_PORT,
            dest_port=ANY_PORT,
        )
        if egress_oriented:
            kwargs["src_network"] = src_pod_ip
        else:
            kwargs["dest_network"] = src_pod_ip
        dst_table.insert_rule(ContivRule(**kwargs))

    def _rebuild_global_table(self) -> None:
        self.global_table = ContivRuleTable(GLOBAL_TABLE_ID)
        egress_oriented = self.cache.orientation == Orientation.EGRESS
        for pod in self.get_all_pods():
            cfg = self.get_pod_config(pod)
            if cfg is None:
                continue
            rules = cfg.ingress if egress_oriented else cfg.egress
            for rule in rules:
                if egress_oriented:
                    rule = ContivRule(
                        action=rule.action,
                        src_network=cfg.pod_ip,
                        dest_network=rule.dest_network,
                        protocol=rule.protocol,
                        src_port=rule.src_port,
                        dest_port=rule.dest_port,
                    )
                else:
                    rule = ContivRule(
                        action=rule.action,
                        src_network=rule.src_network,
                        dest_network=cfg.pod_ip,
                        protocol=rule.protocol,
                        src_port=rule.src_port,
                        dest_port=rule.dest_port,
                    )
                self.global_table.insert_rule(rule)
        if self.global_table.num_of_rules > 0:
            self.global_table.insert_rule(allow_all_tcp())
            self.global_table.insert_rule(allow_all_udp())
