"""PolicyProcessor: K8s policy semantics → ContivPolicy, per-pod rerender.

Reacts to cache changes, computes the set of pods whose policy rendering
is outdated, expands each relevant K8s policy into a ContivPolicy
(selectors → concrete pod lists, IPBlocks parsed), filters pods to the
ones on this node, and hands them to the configurator in one txn.

Reference: plugins/policy/processor (processor.go:67-307,
matches_calculator.go).
"""

from __future__ import annotations

import ipaddress
from typing import Callable, Dict, List, Optional, Set

from vpp_tpu_torch.ir.rule import PodID
from vpp_tpu_torch.ksr import model as m
from vpp_tpu_torch.policy.cache import PolicyCache, PolicyCacheWatcher
from vpp_tpu_torch.policy.config import (
    ContivPolicy,
    IPBlock,
    Match,
    MatchType,
    PolicyType,
    Port,
    Protocol,
)


def _policy_type(policy: m.Policy) -> PolicyType:
    if policy.policy_type == m.POLICY_EGRESS:
        return PolicyType.EGRESS
    if policy.policy_type == m.POLICY_BOTH:
        return PolicyType.BOTH
    if policy.policy_type == m.POLICY_INGRESS:
        return PolicyType.INGRESS
    # DEFAULT (unspecified): K8s semantics — ingress always applies, plus
    # egress if egress rules are present. (The reference maps DEFAULT to
    # plain ingress, processor.go:115; we follow the K8s spec instead.)
    return PolicyType.BOTH if policy.egress_rules else PolicyType.INGRESS


class PolicyProcessor(PolicyCacheWatcher):
    def __init__(
        self,
        cache: PolicyCache,
        configurator,
        is_local_pod: Optional[Callable[[PodID], bool]] = None,
    ):
        self.cache = cache
        self.configurator = configurator
        # Node-locality filter (reference filterHostPods checks the pod's
        # host IP against this node's IPs, processor.go:359-383).
        self.is_local_pod = is_local_pod or (lambda pid: True)
        cache.watch(self)

    # --- the core ---
    def process(self, pods: List[PodID], resync: bool = False) -> None:
        """Recalculate and commit policies for the given pods."""
        pods = [p for p in dict.fromkeys(pods) if self.is_local_pod(p)]
        if not pods and not resync:
            return
        txn = self.configurator.new_txn(resync=resync)
        expanded: Dict[tuple, ContivPolicy] = {}
        for pid in pods:
            policies: List[ContivPolicy] = []
            for pkey in self.cache.lookup_policies_by_pod(pid):
                if pkey not in expanded:
                    policy = self.cache.lookup_policy(*pkey)
                    if policy is None:
                        continue
                    expanded[pkey] = ContivPolicy(
                        id=pkey,
                        type=_policy_type(policy),
                        matches=self.calculate_matches(policy),
                    )
                policies.append(expanded[pkey])
            txn.configure(pid, policies)
        txn.commit()

    def resync_all(self) -> None:
        self.process(self.cache.list_all_pods(), resync=True)

    # --- K8s policy expansion (reference: matches_calculator.go) ---
    def calculate_matches(self, policy: m.Policy) -> List[Match]:
        matches: List[Match] = []
        for direction, rules in (
            (MatchType.INGRESS, policy.ingress_rules),
            (MatchType.EGRESS, policy.egress_rules),
        ):
            for rule in rules:
                pods: Optional[List[PodID]] = []
                blocks: Optional[List[IPBlock]] = []
                if not rule.peers:
                    # no peers = unrestricted on L3
                    pods, blocks = None, None
                for peer in rule.peers or []:
                    if peer.pods is not None and peer.namespaces is not None:
                        # K8s: a peer with both selectors selects pods
                        # matching the pod selector within the matching
                        # namespaces.
                        ns_pods = set(
                            self.cache.lookup_pods_by_namespace_selector(peer.namespaces)
                        )
                        for pid in ns_pods:
                            pod = self.cache.lookup_pod(pid)
                            if pod is not None and peer.pods.matches(pod.labels):
                                pods.append(pid)
                    elif peer.pods is not None:
                        pods.extend(
                            self.cache.lookup_pods_by_ns_label_selector(
                                policy.namespace, peer.pods
                            )
                        )
                    elif peer.namespaces is not None:
                        pods.extend(
                            self.cache.lookup_pods_by_namespace_selector(peer.namespaces)
                        )
                    if peer.ip_block is not None and peer.ip_block.cidr:
                        blocks.append(
                            IPBlock(
                                network=ipaddress.ip_network(peer.ip_block.cidr),
                                except_nets=tuple(
                                    ipaddress.ip_network(e)
                                    for e in peer.ip_block.except_cidrs
                                ),
                            )
                        )
                ports = []
                for p in rule.ports:
                    number = p.port
                    if number is None and p.port_name:
                        number = self._resolve_named_port(policy, p.port_name)
                    if number is None:
                        # Unresolvable named port: keep a never-matching
                        # sentinel so the match stays port-restricted
                        # (dropping it would widen the policy to ALL
                        # ports — fail-open).
                        number = -1
                    ports.append(
                        Port(
                            protocol=Protocol.UDP if p.protocol == "UDP" else Protocol.TCP,
                            number=number,
                        )
                    )
                matches.append(
                    Match(type=direction, pods=pods, ip_blocks=blocks, ports=ports)
                )
        return matches

    def _resolve_named_port(self, policy: m.Policy, name: str) -> Optional[int]:
        """Resolve a named port against the container ports of the pods the
        policy selects (K8s resolves named ports on the destination pods).
        Returns None if no selected pod defines the name."""
        for pid, pod in self.cache.pods.items():
            if pid.namespace != policy.namespace or not policy.pods.matches(pod.labels):
                continue
            for container in pod.containers:
                for cp in container.ports:
                    if cp.name == name and cp.container_port:
                        return cp.container_port
        return None

    # --- affected-pod computation per cache event ---
    def _pods_referencing(self, pod: m.Pod) -> Set[PodID]:
        """Pods whose policies name ``pod`` as a peer (their rendering
        embeds its IP, so they must be re-rendered when it changes)."""
        out: Set[PodID] = set()
        ns_labels = (
            self.cache.lookup_namespace(pod.namespace).labels
            if self.cache.lookup_namespace(pod.namespace)
            else {}
        )
        for pkey, policy in self.cache.policies.items():
            referenced = False
            for rule in list(policy.ingress_rules) + list(policy.egress_rules):
                for peer in rule.peers:
                    if peer.pods is not None and peer.namespaces is None:
                        if policy.namespace == pod.namespace and peer.pods.matches(pod.labels):
                            referenced = True
                    elif peer.namespaces is not None:
                        if peer.namespaces.matches(ns_labels) and (
                            peer.pods is None or peer.pods.matches(pod.labels)
                        ):
                            referenced = True
            if referenced:
                out |= {
                    pid
                    for pid in self.cache.pods
                    if pid.namespace == policy.namespace
                    and policy.pods.matches(self.cache.pods[pid].labels)
                }
        return out

    def _pods_selected_by(self, policy: m.Policy) -> Set[PodID]:
        return {
            pid
            for pid, pod in self.cache.pods.items()
            if pid.namespace == policy.namespace and policy.pods.matches(pod.labels)
        }

    # --- PolicyCacheWatcher ---
    def pod_added(self, pod: m.Pod) -> None:
        pid = PodID(pod.namespace, pod.name)
        self.process([pid] + sorted(self._pods_referencing(pod)))

    def pod_updated(self, old: m.Pod, new: m.Pod) -> None:
        pid = PodID(new.namespace, new.name)
        affected = {pid} | self._pods_referencing(old) | self._pods_referencing(new)
        self.process(sorted(affected))

    def pod_deleted(self, pod: m.Pod) -> None:
        pid = PodID(pod.namespace, pod.name)
        affected = self._pods_referencing(pod)
        txn = self.configurator.new_txn(resync=False)
        txn.remove(pid)
        txn.commit()
        self.process(sorted(affected))

    def policy_added(self, policy: m.Policy) -> None:
        self.process(sorted(self._pods_selected_by(policy)))

    def policy_updated(self, old: m.Policy, new: m.Policy) -> None:
        affected = self._pods_selected_by(old) | self._pods_selected_by(new)
        self.process(sorted(affected))

    def policy_deleted(self, policy: m.Policy) -> None:
        self.process(sorted(self._pods_selected_by(policy)))

    def namespace_added(self, ns: m.Namespace) -> None:
        self.resync_all()

    def namespace_updated(self, old: m.Namespace, new: m.Namespace) -> None:
        if old.labels != new.labels:
            # Namespace labels feed namespace selectors everywhere —
            # re-render all pods (coarse but correct).
            self.resync_all()

    def namespace_deleted(self, ns: m.Namespace) -> None:
        self.resync_all()

    def resync(self) -> None:
        self.resync_all()
