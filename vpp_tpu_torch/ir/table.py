"""ContivRuleTable: an ordered rule table (local per-pod-set or node-global).

A copy of the reference's ``vpp_tpu/ir/table.py`` (this package never
imports the JAX package).

Rules are kept sorted by the total order from ``vpp_tpu_torch.ir.rule`` so that a
rule matching a subset of another rule's traffic precedes it — the order a
first-match classifier must evaluate them in.

Reference: plugins/policy/renderer/cache/cache_api.go:199-260 and the
insert/remove logic of ContivRuleTable in the same package.
"""

from __future__ import annotations

import bisect
import enum
from typing import Callable, List, Optional, Set

from vpp_tpu_torch.ir.rule import ContivRule, PodID, compare_rules

# The single node-global table is always identified by this ID.
GLOBAL_TABLE_ID = "NODE-GLOBAL"


class TableType(enum.IntEnum):
    LOCAL = 0
    GLOBAL = 1


class ContivRuleTable:
    """Ordered set of ContivRules + the set of pods the table is assigned to.

    Local tables are immutable once published (a different rule set is a new
    table); the global table is rebuilt per transaction. ``private`` lets a
    renderer attach its device-specific compiled form (e.g. a device
    renderer's packed int32 rule matrix).
    """

    def __init__(self, table_id: str, table_type: Optional[TableType] = None):
        self.id = table_id
        if table_type is None:
            table_type = TableType.GLOBAL if table_id == GLOBAL_TABLE_ID else TableType.LOCAL
        self.type = table_type
        self.rules: List[ContivRule] = []
        self.pods: Set[PodID] = set()
        self.private = None

    @property
    def num_of_rules(self) -> int:
        return len(self.rules)

    def insert_rule(self, rule: ContivRule) -> bool:
        """Insert keeping sort order; returns False if already present."""
        idx = bisect.bisect_left(self.rules, rule)
        if idx < len(self.rules) and compare_rules(self.rules[idx], rule) == 0:
            return False
        self.rules.insert(idx, rule)
        return True

    def remove_by_predicate(self, pred: Callable[[ContivRule], bool]) -> int:
        """Remove all rules matching the predicate; returns removed count."""
        kept = [r for r in self.rules if not pred(r)]
        removed = len(self.rules) - len(kept)
        self.rules = kept
        return removed

    def has_rule(self, rule: ContivRule) -> bool:
        idx = bisect.bisect_left(self.rules, rule)
        return idx < len(self.rules) and compare_rules(self.rules[idx], rule) == 0

    def copy(self) -> "ContivRuleTable":
        """Copy with independent pod set; rules list is copied (entries shared —
        ContivRule is immutable so sharing is safe)."""
        t = ContivRuleTable(self.id, self.type)
        t.rules = list(self.rules)
        t.pods = set(self.pods)
        t.private = self.private
        return t

    def __str__(self) -> str:
        pods = ", ".join(sorted(str(p) for p in self.pods))
        return (
            f"Table <{self.id} {self.type.name} pods=[{pods}] "
            f"rules={[str(r) for r in self.rules]}>"
        )
