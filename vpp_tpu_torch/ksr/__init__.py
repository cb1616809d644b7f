"""KSR — K8s State Reflector: mirrors cluster state into the kvstore.

The port's copy of ``vpp_tpu/ksr``: the Kubernetes object model the
control plane consumes (``model.py``: pods, namespaces, network
policies, services, endpoints, nodes) and the generic reflector engine
(``reflector.py``: list-watch sources into the store's
``k8s/<type>/...`` keyspace, with mark-and-sweep resync). The
Kubernetes API client (``k8s_client.py``) is not ported yet (ROADMAP
Queue 1 item 12).
"""

from vpp_tpu_torch.ksr import model
from vpp_tpu_torch.ksr.reflector import (
    MockK8sListWatch,
    Reflector,
    ReflectorRegistry,
    make_standard_reflectors,
)

__all__ = [
    "model",
    "MockK8sListWatch",
    "Reflector",
    "ReflectorRegistry",
    "make_standard_reflectors",
]
