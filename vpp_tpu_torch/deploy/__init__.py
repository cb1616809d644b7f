"""The port as Kubernetes deploys it: the manifest of vpp_tpu_torch.

``chart/vpp-tpu-torch.yaml.tmpl`` and ``chart/values.yaml`` follow the
reference's ``k8s/chart/vpp-tpu.yaml.tmpl`` and ``k8s/chart/values.yaml``
object for object: the ConfigMap, the kvstore primary and standby
Deployments and their Services, the witness with its PVC, the vswitch
DaemonSet with its ``cni-install`` init container, the KSR Deployment
and its RBAC. ``render.py`` (``python -m vpp_tpu_torch.deploy.render``)
renders them as ``k8s/render.py`` does; the default render is committed
as ``vpp-tpu-torch.json``, and ``kubectl apply -f
vpp_tpu_torch/deploy/vpp-tpu-torch.json`` deploys the port onto nodes
that expose ``nvidia.com/gpu``.

The render differs from the reference's by these substitutions alone
(``tests/test_torch_deploy.py`` holds the two renders equal after them,
object for object and field for field):

==========================  ==================================  ==========================================
What                        Reference                           Port
==========================  ==================================  ==========================================
container modules           the reference's ``cmd.X`` modules   ``python -m vpp_tpu_torch.cmd.X``
CNI shim                    ``vpp-tpu-cni`` (netconf ``type``,  ``vpp-tpu-torch-cni`` (the console script
                            ``/opt/vpp-tpu/bin/vpp-tpu-cni``)   of ``vpp_tpu_torch.cni.shim:main``)
accelerator limit           ``google.com/tpu: {tpu_count}``     ``nvidia.com/gpu: {gpu_count}``
values of the limit         ``tpu_resource``, ``tpu_count``     ``gpu_resource``, ``gpu_count`` (1, in
                                                                mesh mode too: the port's mesh is a grid
                                                                of positions on one card)
object names and labels     ``vpp-tpu-<x>``                     ``vpp-tpu-torch-<x>``, for ``cfg``,
                                                                ``kvstore``, ``kvstore-standby``,
                                                                ``kvwitness``, ``kvwitness-data``,
                                                                ``vswitch``, ``ksr`` (and the Service DNS
                                                                names made of them)
file format                 a YAML stream; ``contiv.yaml`` and  one JSON ``List``; ``contiv.yaml`` and the
                            the netconf as YAML / JSON text     netconf as JSON text (the same objects)
==========================  ==================================  ==========================================

The host paths (``/run/vpp-tpu``, ``/var/lib/vpp-tpu``, ``/etc/vpp-tpu``,
``/opt/vpp-tpu/bin``), the netconf's file name ``10-vpp-tpu.conf``, the
image and every other value stay the reference's: the port's config
defaults use those paths.

``${NODE_NAME}`` in the ConfigMap is resolved by the port's
``cmd/config.py`` ``load_config`` from the ``NODE_NAME`` the DaemonSet
sets through the downward API (the reference's leaves it as it is).
``vpp_tpu_torch/testing/deploy.py`` turns a render into processes on one
host.
"""
