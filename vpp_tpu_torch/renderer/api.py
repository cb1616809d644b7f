"""PolicyRendererAPI — the southbound contract of the policy engine.

A renderer turns canonical ContivRules into a concrete network stack's
configuration. The policy configurator fans out to every registered
renderer; each renderer decides how rules are installed (for the device
renderer: packed int32 rule tables swapped into the device pipeline).

Reference: plugins/policy/renderer/api.go:33-61.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import List, Optional

from vpp_tpu_torch.ir.rule import ContivRule, IPNetwork, PodID


@dataclass
class PodConfig:
    """Rule configuration of one pod as handed to a renderer / renderer cache.

    Reference: renderer/cache/cache_api.go PodConfig.
    """

    pod_ip: Optional[IPNetwork] = None  # one-host subnet (/32)
    ingress: List[ContivRule] = field(default_factory=list)
    egress: List[ContivRule] = field(default_factory=list)
    removed: bool = False


class RendererTxn(abc.ABC):
    """A single rendering transaction.

    ``render`` calls accumulate per-pod rule updates; ``commit`` propagates
    them into the destination network stack atomically (the device renderer
    performs one epoch table-swap per commit).
    """

    @abc.abstractmethod
    def render(
        self,
        pod: PodID,
        pod_ip: Optional[IPNetwork],
        ingress: List[ContivRule],
        egress: List[ContivRule],
        removed: bool = False,
    ) -> "RendererTxn":
        """Set the ingress & egress rules for a pod (replacing existing ones).

        Traffic direction is from the vswitch point of view: for ingress
        rules the source IP is unset (match-all), for egress rules the
        destination IP is unset. An empty rule list allows all traffic in
        that direction. ``removed=True`` means the pod was deleted (rules
        empty, pod_ip may be None).
        """

    @abc.abstractmethod
    def commit(self) -> None:
        """Propagate the rendered changes into the network stack."""


class PolicyRendererAPI(abc.ABC):
    """Factory of renderer transactions.

    If ``resync`` is True the supplied configuration completely replaces the
    existing one; otherwise changes are incremental (pods not mentioned stay
    untouched).
    """

    @abc.abstractmethod
    def new_txn(self, resync: bool = False) -> RendererTxn:
        ...
