"""The VPPTCP renderer: ContivRule tables → host-stack session rules.

Reference analog: plugins/policy/renderer/vpptcp/vpptcp_renderer.go —
the second registered renderer, filtering host-TCP-stack connections
instead of packets. It shares the RendererCache (INGRESS orientation,
:106-192), converts each pod's local table into LOCAL-scope rules in the
pod's app namespace (GetNsIndex via contiv.API) and the node's global
table into GLOBAL-scope rules, and pushes *batched* add/del deltas
(:269-327) — never a full rewrite — to the session layer. Resync
re-imports the engine dump (:195-238).

The 5-tuple orientation follows where each table sits in the path
(ingress orientation): a pod's LOCAL table filters its *outbound
connects*, so the rule's ``src_*`` fields are the pod-local side and
``dest_*`` the remote side; the GLOBAL table filters *inbound accepts*
entering the node, so there ``dest_*`` is the local (accepting) side
and ``src_*`` the remote initiator.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Set

from vpp_tpu_torch.hoststack.session_rules import (
    GLOBAL_NS,
    RuleAction,
    RuleScope,
    SessionRule,
    SessionRuleEngine,
)
from vpp_tpu_torch.ir.rule import ANY_PORT, Action, ContivRule, IPNetwork, PodID, Protocol
from vpp_tpu_torch.ir.table import ContivRuleTable, TableType
from vpp_tpu_torch.renderer.api import PodConfig, PolicyRendererAPI, RendererTxn
from vpp_tpu_torch.renderer.cache import Orientation, RendererCache

# contiv.API GetNsIndex analog: pod → app namespace index
NsIndexFn = Callable[[PodID], int]


def _rules_for_table(
    table: ContivRuleTable, ns_indexes: List[int]
) -> Set[SessionRule]:
    """Expand one ContivRuleTable into wire session rules.

    A local table shared by k pods expands into k copies of its rules,
    one per pod app-namespace (the engine's table is flat); the global
    table expands once with GLOBAL scope.
    """
    out: Set[SessionRule] = set()
    is_global = table.type == TableType.GLOBAL
    scopes = [(RuleScope.GLOBAL, GLOBAL_NS)] if is_global else [
        (RuleScope.LOCAL, ns) for ns in ns_indexes
    ]
    for rule in table.rules:
        if rule.protocol == Protocol.ICMP:
            continue  # session layer is TCP/UDP only
        protos = (
            [6, 17] if rule.protocol == Protocol.ANY else [rule.protocol.ip_proto]
        )
        src_net = int(rule.src_network.network_address) if rule.src_network else 0
        src_plen = rule.src_network.prefixlen if rule.src_network else 0
        dst_net = int(rule.dest_network.network_address) if rule.dest_network else 0
        dst_plen = rule.dest_network.prefixlen if rule.dest_network else 0
        src_port = 0 if rule.src_port == ANY_PORT else rule.src_port
        dst_port = 0 if rule.dest_port == ANY_PORT else rule.dest_port
        if is_global:
            # accept-side: local = destination, remote = initiator
            lcl = (dst_net, dst_plen, dst_port)
            rmt = (src_net, src_plen, src_port)
        else:
            # connect-side: local = the pod (src), remote = destination
            lcl = (src_net, src_plen, src_port)
            rmt = (dst_net, dst_plen, dst_port)
        for scope, ns in scopes:
            for proto in protos:
                out.add(
                    SessionRule(
                        scope=int(scope),
                        appns_index=ns,
                        transport_proto=proto,
                        lcl_net=lcl[0],
                        lcl_plen=lcl[1],
                        rmt_net=rmt[0],
                        rmt_plen=rmt[1],
                        lcl_port=lcl[2],
                        rmt_port=rmt[2],
                        action=int(RuleAction.ALLOW)
                        if rule.action == Action.PERMIT
                        else int(RuleAction.DENY),
                        # tag left empty: rule identity must not depend on
                        # the (rebuild-varying) table id, or deltas between
                        # epochs stop being minimal.
                    )
                )
    return out


class VpptcpRenderer(PolicyRendererAPI):
    def __init__(self, engine: SessionRuleEngine, ns_index: NsIndexFn):
        self.engine = engine
        self.ns_index = ns_index
        self.cache = RendererCache(Orientation.INGRESS)

    def new_txn(self, resync: bool = False) -> "VpptcpRendererTxn":
        return VpptcpRendererTxn(self, resync)

    def desired_rules(self) -> Set[SessionRule]:
        """The full session-rule set implied by the cache state."""
        want: Set[SessionRule] = set()
        for table in self.cache.local_tables:
            ns_list = [self.ns_index(pod) for pod in table.pods]
            ns_list = [n for n in ns_list if n >= 0]
            if ns_list:
                want |= _rules_for_table(table, ns_list)
        want |= _rules_for_table(self.cache.get_global_table(), [])
        return want

    def dump_rules(self) -> List[SessionRule]:
        return self.engine.dump()


class VpptcpRendererTxn(RendererTxn):
    def __init__(self, renderer: VpptcpRenderer, resync: bool):
        self.renderer = renderer
        self.resync = resync
        if resync:
            renderer.cache.flush()
        self.cache_txn = renderer.cache.new_txn()

    def render(
        self,
        pod: PodID,
        pod_ip: Optional[IPNetwork],
        ingress: List[ContivRule],
        egress: List[ContivRule],
        removed: bool = False,
    ) -> "VpptcpRendererTxn":
        self.cache_txn.update(
            pod,
            PodConfig(pod_ip=pod_ip, ingress=ingress, egress=egress, removed=removed),
        )
        return self

    def commit(self) -> None:
        r = self.renderer
        self.cache_txn.commit()
        # Batched minimal delta at the wire level: one apply() regardless
        # of how many rules changed (vpptcp_renderer.go:269-327). On
        # resync the engine may hold stale rules from before the restart;
        # the same diff covers that (dump = installed, cache = desired).
        installed = set(r.engine.dump())
        desired = r.desired_rules()
        add = desired - installed
        delete = installed - desired
        if add or delete:
            r.engine.apply(add=add, delete=delete)
