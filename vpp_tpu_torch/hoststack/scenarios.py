"""Shared session-rule scenario builders for benches and e2e tests.

The gen-policy-scale filler and the proxy-chain mesh seam are measured
by ``bench.proxy_chain_bench`` AND exercised end-to-end by
``tests/test_proxy_chain_e2e.py`` (the nginx-istio analog, reference
tests/nginx-istio/nginx-envoy.yaml + BASELINE config #5). One
definition keeps both harnesses measuring the SAME policy shape — a
rule-formula change edited in one copy would silently leave bench and
e2e on different rule sets.

A copy of ``vpp_tpu/hoststack/scenarios.py`` over the port's rule
types; the same arguments build the same rules.
"""

from __future__ import annotations

from typing import List

from vpp_tpu_torch.hoststack.session_rules import (
    RuleAction,
    RuleScope,
    SessionRule,
)


def gen_policy_filler(n: int, appns_base: int = 5) -> List[SessionRule]:
    """gen-policy.py-shaped filler: ``n`` CIDR × port rules across pod
    subnets, 5:1 permit:deny, spread over three app namespaces
    (reference tests/policy/gen-policy.py scale shape)."""
    rules = []
    for i in range(n):
        net = ((10 << 24) | ((i // 250) % 64 << 16) | ((i % 250) << 8))
        rules.append(SessionRule(
            scope=int(RuleScope.LOCAL), appns_index=appns_base + (i % 3),
            transport_proto=6, lcl_net=0, lcl_plen=0,
            rmt_net=net, rmt_plen=24,
            lcl_port=0, rmt_port=8000 + i % 40,
            action=int(RuleAction.DENY if i % 6 == 5
                       else RuleAction.ALLOW)))
    return rules


def proxy_chain_rules(loop_ip: int, client_ns: int, proxy_ns: int,
                      pport: int, bport: int) -> List[SessionRule]:
    """The service-mesh seam: client may reach ONLY the proxy, the
    proxy ONLY the backend, deny-all underneath in both the LOCAL
    (connect) and GLOBAL (accept) scopes — every hop of the chain is a
    load-bearing verdict. Index 2 is the proxy→backend upstream permit
    (the e2e revokes it to prove live policy enforcement)."""
    return [
        SessionRule(scope=int(RuleScope.LOCAL), appns_index=client_ns,
                    transport_proto=6, lcl_net=0, lcl_plen=0,
                    rmt_net=loop_ip, rmt_plen=32, lcl_port=0,
                    rmt_port=pport, action=int(RuleAction.ALLOW)),
        SessionRule(scope=int(RuleScope.LOCAL), appns_index=client_ns,
                    transport_proto=6, lcl_net=0, lcl_plen=0,
                    rmt_net=0, rmt_plen=0, lcl_port=0, rmt_port=0,
                    action=int(RuleAction.DENY)),
        SessionRule(scope=int(RuleScope.LOCAL), appns_index=proxy_ns,
                    transport_proto=6, lcl_net=0, lcl_plen=0,
                    rmt_net=loop_ip, rmt_plen=32, lcl_port=0,
                    rmt_port=bport, action=int(RuleAction.ALLOW)),
        SessionRule(scope=int(RuleScope.LOCAL), appns_index=proxy_ns,
                    transport_proto=6, lcl_net=0, lcl_plen=0,
                    rmt_net=0, rmt_plen=0, lcl_port=0, rmt_port=0,
                    action=int(RuleAction.DENY)),
        SessionRule(scope=int(RuleScope.GLOBAL), appns_index=-1,
                    transport_proto=6, lcl_net=loop_ip, lcl_plen=32,
                    rmt_net=0, rmt_plen=0, lcl_port=pport, rmt_port=0,
                    action=int(RuleAction.ALLOW)),
        SessionRule(scope=int(RuleScope.GLOBAL), appns_index=-1,
                    transport_proto=6, lcl_net=loop_ip, lcl_plen=32,
                    rmt_net=0, rmt_plen=0, lcl_port=bport, rmt_port=0,
                    action=int(RuleAction.ALLOW)),
        SessionRule(scope=int(RuleScope.GLOBAL), appns_index=-1,
                    transport_proto=6, lcl_net=0, lcl_plen=0,
                    rmt_net=0, rmt_plen=0, lcl_port=0, rmt_port=0,
                    action=int(RuleAction.DENY)),
    ]
