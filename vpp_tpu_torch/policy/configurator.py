"""PolicyConfigurator: ContivPolicy sets → canonical ContivRules → renderers.

For each pod the txn turns its (unordered) ContivPolicy set into two
ordered ContivRule lists and fans them out to every registered renderer.
Identical policy sets are expanded only once per txn so pods sharing
policies share rule lists (and downstream, renderer tables).

Direction note: policy Matches use the *pod's* point of view, renderer
rules the *vswitch's* — so pod-ingress matches become renderer *egress*
rules and vice versa (reference: configurator_impl.go:182-186).

Reference: plugins/policy/configurator/configurator_impl.go.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from vpp_tpu_torch.ir.rule import (
    ANY_PORT,
    Action,
    ContivRule,
    IPNetwork,
    PodID,
    Protocol as RuleProtocol,
    compare_rules,
    one_host_subnet,
)
from vpp_tpu_torch.policy.cache import PolicyCache
from vpp_tpu_torch.policy.config import ContivPolicy, MatchType, PolicyType
from vpp_tpu_torch.renderer.api import PolicyRendererAPI
from vpp_tpu_torch.trace import spans


def subtract_subnet(subnet: IPNetwork, excluded: IPNetwork) -> List[IPNetwork]:
    """Subnets covering ``subnet`` minus ``excluded``.

    Reference hand-rolls this (configurator_impl.go:563-595); Python's
    ipaddress.address_exclude provides the exact semantics.
    """
    if not (
        subnet.version == excluded.version
        and excluded.subnet_of(subnet)
    ):
        return [subnet]
    if excluded == subnet:
        return []
    return list(subnet.address_exclude(excluded))


class PolicyConfigurator:
    def __init__(self, cache: PolicyCache, parallel_commits: bool = False):
        """``parallel_commits``: commit independent renderers from worker
        threads (reference: the optional parallel renderer commit,
        configurator_impl.go:211-233, flag plugin_impl_policy.go:161).
        Renderers are independent southbound targets, so their commits
        may overlap; errors propagate after all complete."""
        self.cache = cache
        self.renderers: List[PolicyRendererAPI] = []
        self.parallel_commits = parallel_commits
        self._pod_ips: Dict[PodID, IPNetwork] = {}

    def register_renderer(self, renderer: PolicyRendererAPI) -> None:
        self.renderers.append(renderer)

    def new_txn(self, resync: bool = False) -> "PolicyConfiguratorTxn":
        return PolicyConfiguratorTxn(self, resync)


class PolicyConfiguratorTxn:
    def __init__(self, configurator: PolicyConfigurator, resync: bool):
        self.configurator = configurator
        self.resync = resync
        self.config: Dict[PodID, Optional[List[ContivPolicy]]] = {}

    def configure(self, pod: PodID, policies: List[ContivPolicy]) -> "PolicyConfiguratorTxn":
        self.config[pod] = policies
        return self

    def remove(self, pod: PodID) -> "PolicyConfiguratorTxn":
        """Mark the pod as removed (un-configure its policies)."""
        self.config[pod] = None
        return self

    def commit(self) -> None:
        # "render" span: rule expansion + every renderer commit (incl.
        # the epoch swap the device renderer publishes) — the per-stage
        # attribution of the policy path in an applied txn's timeline
        with spans.RECORDER.span(
            "render",
            "policy-resync" if self.resync else "policy-render",
            pods=len(self.config),
        ):
            self._commit_traced()

    def _commit_traced(self) -> None:
        cfg = self.configurator
        processed: List[Tuple[List[ContivPolicy], List[ContivRule], List[ContivRule]]] = []
        renderer_txns = [r.new_txn(self.resync) for r in cfg.renderers]

        for pod, policies in self.config.items():
            ingress: List[ContivRule] = []
            egress: List[ContivRule] = []
            removed = policies is None

            pod_data = cfg.cache.lookup_pod(pod)
            if not removed and (pod_data is None or not pod_data.ip_address):
                if pod in cfg._pod_ips:
                    removed = True
                else:
                    continue  # never configured; nothing to undo

            if removed:
                pod_ip = cfg._pod_ips.pop(pod, None)
            else:
                pod_ip = one_host_subnet(pod_data.ip_address)
                cfg._pod_ips[pod] = pod_ip

                ordered = sorted(policies, key=lambda p: p.sort_key())
                hit = next((p for p in processed if p[0] == ordered), None)
                if hit is not None:
                    _, ingress, egress = hit
                else:
                    # pod-POV ingress -> vswitch egress and vice versa.
                    egress = self._generate_rules(MatchType.INGRESS, ordered)
                    ingress = self._generate_rules(MatchType.EGRESS, ordered)
                    processed.append((ordered, ingress, egress))

            for rtxn in renderer_txns:
                rtxn.render(pod, pod_ip, list(ingress), list(egress), removed)

        if cfg.parallel_commits and len(renderer_txns) > 1:
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(
                max_workers=len(renderer_txns),
                thread_name_prefix="renderer-commit",
            ) as pool:
                futures = [pool.submit(r.commit) for r in renderer_txns]
                for f in futures:
                    f.result()  # re-raise the first renderer error
        else:
            for rtxn in renderer_txns:
                rtxn.commit()

    # --- rule generation (reference: generateRules, :248-479) ---
    def _generate_rules(
        self, direction: MatchType, policies: List[ContivPolicy]
    ) -> List[ContivRule]:
        rules: List[ContivRule] = []
        has_policy = False
        all_allowed = False

        def append(*new_rules: ContivRule) -> None:
            for rule in new_rules:
                if not any(compare_rules(rule, r) == 0 for r in rules):
                    rules.append(rule)

        def permit(
            protocol: RuleProtocol,
            peer_net: Optional[IPNetwork] = None,
            dest_port: int = ANY_PORT,
        ) -> ContivRule:
            kwargs = dict(
                action=Action.PERMIT,
                protocol=protocol,
                src_port=ANY_PORT,
                dest_port=dest_port,
            )
            # The peer is the traffic's source for pod-ingress matches and
            # its destination for pod-egress matches.
            if peer_net is not None:
                if direction == MatchType.INGRESS:
                    kwargs["src_network"] = peer_net
                else:
                    kwargs["dest_network"] = peer_net
            return ContivRule(**kwargs)

        for policy in policies:
            if (policy.type == PolicyType.INGRESS and direction == MatchType.EGRESS) or (
                policy.type == PolicyType.EGRESS and direction == MatchType.INGRESS
            ):
                continue
            has_policy = True

            for match in policy.matches:
                if match.type != direction:
                    continue

                # Resolve peer pods to one-host subnets.
                peer_nets: List[IPNetwork] = []
                for peer in match.pods or []:
                    peer_data = self.configurator.cache.lookup_pod(peer)
                    if peer_data is None or not peer_data.ip_address:
                        continue
                    peer_nets.append(one_host_subnet(peer_data.ip_address))

                # Expand IPBlocks minus their excepts.
                for block in match.ip_blocks or []:
                    subnets = [block.network]
                    for exc in block.except_nets:
                        subnets = [
                            s for sub in subnets for s in subtract_subnet(sub, exc)
                        ]
                    peer_nets.extend(subnets)

                if match.pods is None and match.ip_blocks is None:
                    # L3-unrestricted.
                    if not match.ports:
                        append(permit(RuleProtocol.TCP), permit(RuleProtocol.UDP))
                        all_allowed = True
                    else:
                        for port in match.ports:
                            append(permit(port.protocol.rule_protocol, dest_port=port.number))
                    continue

                for net in peer_nets:
                    if not match.ports:
                        append(
                            permit(RuleProtocol.TCP, net),
                            permit(RuleProtocol.UDP, net),
                        )
                    else:
                        for port in match.ports:
                            append(
                                permit(
                                    port.protocol.rule_protocol, net, dest_port=port.number
                                )
                            )

        if has_policy and not all_allowed:
            append(
                ContivRule(action=Action.DENY, protocol=RuleProtocol.TCP),
                ContivRule(action=Action.DENY, protocol=RuleProtocol.UDP),
            )
        return rules
