"""K8s Services → NAT44 load balancing.

Reference: plugins/service — Processor merges Service+Endpoints into
ContivService, Configurator renders NAT44 DNAT mappings with weighted
backends (local backends weighted 2x), nodeports and the SNAT pool.
"""

from vpp_tpu_torch.service.config import Backend, ContivService, TrafficPolicy
from vpp_tpu_torch.service.processor import ServiceProcessor
from vpp_tpu_torch.service.configurator import ServiceConfigurator

__all__ = [
    "Backend",
    "ContivService",
    "TrafficPolicy",
    "ServiceProcessor",
    "ServiceConfigurator",
]
