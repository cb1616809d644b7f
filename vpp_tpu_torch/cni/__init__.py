"""CNI subsystem: the pod-wiring path of the framework.

Reference analogs: the contiv plugin's remoteCNIserver
(plugins/contiv/remote_cni_server.go), the containeridx persisted index
(plugins/contiv/containeridx), and the contiv-cni shim executable
(cmd/contiv-cni/contiv_cni.go). kubelet invokes the shim per pod
sandbox; the shim forwards Add/Delete to the node agent's CNI server,
which allocates an IP (IPAM), wires a dataplane interface + route, and
persists the container config for restart resync.
"""

from vpp_tpu_torch._lazy import lazy_exports

__all__ = [
    "CNIReply",
    "CNIRequest",
    "ContainerConfig",
    "ContainerIndex",
    "RemoteCNIServer",
    "ResultCode",
]
# imported at first use (_lazy.py): the IO daemon's process imports no torch
__getattr__ = lazy_exports(__name__, {
    "ContainerConfig": "vpp_tpu_torch.cni.containeridx",
    "ContainerIndex": "vpp_tpu_torch.cni.containeridx",
    "CNIReply": "vpp_tpu_torch.cni.model",
    "CNIRequest": "vpp_tpu_torch.cni.model",
    "ResultCode": "vpp_tpu_torch.cni.model",
    "RemoteCNIServer": "vpp_tpu_torch.cni.server",
})
