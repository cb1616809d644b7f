"""Policy rule IR of the PyTorch data plane (a copy of the reference's
``ir/rule.py``; the package never imports the JAX package)."""

from vpp_tpu_torch.ir.rule import (
    ANY_PORT,
    Action,
    ContivRule,
    PodID,
    Protocol,
    rule_matches,
)

__all__ = ["ANY_PORT", "Action", "ContivRule", "PodID", "Protocol",
           "rule_matches"]
