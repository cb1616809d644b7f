"""The Kubernetes object model the control plane consumes.

A copy of the reference's ``vpp_tpu/ksr/model.py`` (pods, namespaces,
network policies, services, endpoints, nodes). The reflector and the
Kubernetes client belong to the agent and are not here.
"""

from vpp_tpu_torch.ksr import model

__all__ = ["model"]
