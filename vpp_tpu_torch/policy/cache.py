"""PolicyCache: indexed view of pods, policies and namespaces.

Ingests change events (from kvstore watches or directly in tests),
maintains label-selector indexes, answers the lookups the processor
needs, and notifies a watcher about every change so the processor can
compute the affected pods.

Reference: plugins/policy/cache ({cache_api,data_change,data_resync}.go
+ podidx/policyidx/namespaceidx).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from vpp_tpu_torch.ir.rule import PodID
from vpp_tpu_torch.ksr import model as m


class PolicyCacheWatcher:
    """Interface of a cache watcher (implemented by the processor)."""

    def pod_added(self, pod: m.Pod) -> None: ...
    def pod_updated(self, old: m.Pod, new: m.Pod) -> None: ...
    def pod_deleted(self, pod: m.Pod) -> None: ...
    def policy_added(self, policy: m.Policy) -> None: ...
    def policy_updated(self, old: m.Policy, new: m.Policy) -> None: ...
    def policy_deleted(self, policy: m.Policy) -> None: ...
    def namespace_added(self, ns: m.Namespace) -> None: ...
    def namespace_updated(self, old: m.Namespace, new: m.Namespace) -> None: ...
    def namespace_deleted(self, ns: m.Namespace) -> None: ...
    def resync(self) -> None: ...


class PolicyCache:
    def __init__(self) -> None:
        self.pods: Dict[PodID, m.Pod] = {}
        self.policies: Dict[tuple, m.Policy] = {}
        self.namespaces: Dict[str, m.Namespace] = {}
        self._watchers: List[PolicyCacheWatcher] = []

    def watch(self, watcher: PolicyCacheWatcher) -> None:
        self._watchers.append(watcher)

    # --- data change ingestion ---
    def update_pod(self, pod: m.Pod) -> None:
        pid = PodID(pod.namespace, pod.name)
        old = self.pods.get(pid)
        self.pods[pid] = pod
        for w in self._watchers:
            if old is None:
                w.pod_added(pod)
            else:
                w.pod_updated(old, pod)

    def delete_pod(self, pid: PodID) -> None:
        pod = self.pods.pop(pid, None)
        if pod is not None:
            for w in self._watchers:
                w.pod_deleted(pod)

    def update_policy(self, policy: m.Policy) -> None:
        key = (policy.namespace, policy.name)
        old = self.policies.get(key)
        self.policies[key] = policy
        for w in self._watchers:
            if old is None:
                w.policy_added(policy)
            else:
                w.policy_updated(old, policy)

    def delete_policy(self, namespace: str, name: str) -> None:
        policy = self.policies.pop((namespace, name), None)
        if policy is not None:
            for w in self._watchers:
                w.policy_deleted(policy)

    def update_namespace(self, ns: m.Namespace) -> None:
        old = self.namespaces.get(ns.name)
        self.namespaces[ns.name] = ns
        for w in self._watchers:
            if old is None:
                w.namespace_added(ns)
            else:
                w.namespace_updated(old, ns)

    def delete_namespace(self, name: str) -> None:
        ns = self.namespaces.pop(name, None)
        if ns is not None:
            for w in self._watchers:
                w.namespace_deleted(ns)

    def resync(
        self,
        pods: List[m.Pod],
        policies: List[m.Policy],
        namespaces: List[m.Namespace],
    ) -> None:
        """Replace the entire cache content (datasync RESYNC event)."""
        self.pods = {PodID(p.namespace, p.name): p for p in pods}
        self.policies = {(p.namespace, p.name): p for p in policies}
        self.namespaces = {n.name: n for n in namespaces}
        for w in self._watchers:
            w.resync()

    # --- lookups (reference: cache_api.go) ---
    def lookup_pod(self, pid: PodID) -> Optional[m.Pod]:
        return self.pods.get(pid)

    def lookup_policy(self, namespace: str, name: str) -> Optional[m.Policy]:
        return self.policies.get((namespace, name))

    def lookup_namespace(self, name: str) -> Optional[m.Namespace]:
        return self.namespaces.get(name)

    def list_all_pods(self) -> List[PodID]:
        return list(self.pods.keys())

    def lookup_pods_by_ns_label_selector(
        self, namespace: str, selector: m.LabelSelector
    ) -> List[PodID]:
        """Pods within one namespace whose labels match the selector."""
        return [
            pid
            for pid, pod in self.pods.items()
            if pid.namespace == namespace and selector.matches(pod.labels)
        ]

    def lookup_pods_by_namespace_selector(
        self, selector: m.LabelSelector
    ) -> List[PodID]:
        """Pods in any namespace whose *namespace labels* match."""
        matching_ns = {
            name for name, ns in self.namespaces.items() if selector.matches(ns.labels)
        }
        return [pid for pid in self.pods if pid.namespace in matching_ns]

    def lookup_policies_by_pod(self, pid: PodID) -> List[tuple]:
        """Policies whose pod selector matches the pod (same namespace)."""
        pod = self.pods.get(pid)
        if pod is None:
            return []
        out = []
        for key, policy in self.policies.items():
            if policy.namespace != pid.namespace:
                continue
            if policy.pods.matches(pod.labels):
                out.append(key)
        return out
