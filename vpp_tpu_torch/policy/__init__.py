"""The NetworkPolicy engine: Cache → Processor → Configurator → Renderers.

Reference: plugins/policy — the 4-layer pipeline (plugin_impl_policy.go:
47-82). K8s policies flow from the kvstore (reflected by KSR) through:

- ``cache``        — indexes pods/policies/namespaces, label-selector
                     lookups, change notifications.
- ``processor``    — decides which pods need re-rendering per event and
                     expands K8s policies into ContivPolicies (selectors
                     evaluated, namespaces resolved).
- ``configurator`` — turns a pod's ContivPolicy set into canonical
                     ingress/egress ContivRule lists (dedup by policy
                     set, CIDR subtraction for excepts) and fans out to
                     registered renderers.
"""

from vpp_tpu_torch.policy.config import ContivPolicy, IPBlock, Match, MatchType, PolicyType, Port
from vpp_tpu_torch.policy.cache import PolicyCache
from vpp_tpu_torch.policy.processor import PolicyProcessor
from vpp_tpu_torch.policy.configurator import PolicyConfigurator

__all__ = [
    "ContivPolicy",
    "IPBlock",
    "Match",
    "MatchType",
    "PolicyType",
    "Port",
    "PolicyCache",
    "PolicyProcessor",
    "PolicyConfigurator",
]
