"""Host-stack session layer: per-namespace connection filtering.

Reference analog: VPP's host-stack session layer + session rule tables
(the VPPTCP renderer's target — plugins/policy/renderer/vpptcp, wire
struct rule/session_rule.go:32-83). Applications using the accelerated
TCP stack have their connect/accept calls filtered against session
rules scoped either to their app namespace (LOCAL) or the whole node
(GLOBAL), instead of per-packet ACLs.
"""

from vpp_tpu_torch.hoststack.session_rules import (
    ConnDirection,
    RuleAction,
    RuleScope,
    SessionRule,
    SessionRuleEngine,
)

__all__ = [
    "ConnDirection",
    "RuleAction",
    "RuleScope",
    "SessionRule",
    "SessionRuleEngine",
]
