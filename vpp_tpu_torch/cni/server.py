"""RemoteCNIServer: the agent-side Add/Delete endpoint that wires pods.

Reference analog: remoteCNIserver (plugins/contiv/remote_cni_server.go:
274-283 Add/Delete, :895 configureContainerConnectivity): allocate a pod
IP from IPAM, create the pod's dataplane interface, install the /32
route + gateway, persist the container config (skipping the kvstore echo
via the proxy, :1390-1420), and answer with the CNI result. Requests
arriving before the base vswitch config is ready get TRY_AGAIN (the
reference blocks on vswitchCond, :129-130 — we answer non-blocking so
the shim can retry, same effect for kubelet's retry loop).

Restart resync: `resync()` reloads the persisted container index and
re-wires every interface/route — the reference's resync-from-ETCD path.

The port's copy of ``vpp_tpu/cni/server.py`` over the port's
``Dataplane``; with a ``wirer`` (``cni/wiring.py``) each Add also
creates the pod's kernel veth path and attaches it to the IO daemon.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

from vpp_tpu_torch.cni.containeridx import ContainerConfig, ContainerIndex
from vpp_tpu_torch.cni.model import (
    CNIInterface,
    CNIIpAddress,
    CNIReply,
    CNIRequest,
    CNIRoute,
    ResultCode,
)
from vpp_tpu_torch.ipam.ipam import IPAM
from vpp_tpu_torch.pipeline.dataplane import Dataplane
from vpp_tpu_torch.pipeline.vector import Disposition
from vpp_tpu_torch.trace import spans

log = logging.getLogger("vpp_tpu_torch.cni")


class RemoteCNIServer:
    def __init__(
        self,
        dataplane: Dataplane,
        ipam: IPAM,
        index: Optional[ContainerIndex] = None,
        on_pod_change: Optional[Callable[[], None]] = None,
        wirer=None,
    ):
        self.dp = dataplane
        self.ipam = ipam
        self.index = index or ContainerIndex()
        self._ready = False
        self._lock = threading.RLock()
        # Fired after a pod is wired/unwired and the epoch swapped —
        # the policy/service plugins' cue to re-render (the reference's
        # async ETCD-watch path, SURVEY.md §3.2).
        self.on_pod_change = on_pod_change
        # Optional VethPodWirer (cni/wiring.py): creates the kernel veth
        # path and attaches it to the IO daemon. None = config-only mode
        # (unit tests, cluster simulations without CAP_NET_ADMIN).
        self.wirer = wirer
        # Optional Prometheus Histogram (vpp_tpu_cni_request_seconds,
        # labelled op="add"|"del"): Add/Delete handling duration —
        # kubelet's sandbox-setup latency budget is this number
        self.duration_hist = None

    # --- lifecycle ---
    def set_ready(self) -> None:
        """Base vswitch connectivity configured; start serving Adds."""
        with self._lock:
            self._ready = True

    def resync(self) -> int:
        """Re-wire all persisted containers after an agent restart."""
        with self._lock, self.dp.commit_lock:
            n = 0
            rewire = []
            for cfg in self.index.load_persisted():
                pod = (cfg.pod_namespace, cfg.pod_name)
                if_idx = self.dp.add_pod_interface(pod)
                self.dp.builder.add_route(
                    f"{cfg.ip}/32", if_idx, Disposition.LOCAL
                )
                if if_idx != cfg.if_index:
                    # The fresh dataplane's slot allocator need not hand
                    # back the pre-restart index; re-register so the
                    # persisted config and the ifindex→pod axis (metric
                    # labels) track the live interface.
                    cfg = dataclasses.replace(cfg, if_index=if_idx)
                    self.index.register(cfg)
                rewire.append(cfg)
                n += 1
            if n:
                self.dp.builder.txn_label = f"cni-resync {n} pods"
                self.dp.swap()
            if self.wirer is not None:
                # re-attach surviving veth pairs to the (possibly also
                # restarted) IO daemon; attach is idempotent. A pod
                # whose veth vanished (node reboot) gets re-created —
                # kubelet will eventually re-Add anyway, but traffic
                # for still-running containers must not wait for it.
                from vpp_tpu_torch.cni.wiring import host_ifname

                from vpp_tpu_torch.net import linux

                for cfg in rewire:
                    try:
                        host_if = host_ifname(cfg.container_id)
                        if linux.link_exists(host_if):
                            self.wirer.re_attach(
                                container_id=cfg.container_id,
                                netns=cfg.netns,
                                if_name=cfg.if_name,
                                if_index=cfg.if_index,
                                pod_ip=cfg.ip,
                            )
                        elif cfg.netns:
                            self.wirer.wire(
                                container_id=cfg.container_id,
                                netns=cfg.netns,
                                if_name=cfg.if_name,
                                if_index=cfg.if_index,
                                pod_ip=cfg.ip,
                            )
                    except Exception:  # noqa: BLE001 — per-pod isolation
                        log.exception("resync re-wire failed for %s",
                                      cfg.container_id)
            return n

    # --- CNI protocol ---
    def add(self, req: CNIRequest) -> CNIReply:
        """Wire a pod. Root span ("cni"): a CNI Add is an NB config
        event, so its epoch swap observes the propagation SLO with
        source="cni"; the duration histogram feeds kubelet's
        sandbox-setup latency budget."""
        t0 = time.perf_counter()
        with spans.RECORDER.span(
            "cni", f"cni-add {req.pod_namespace}/{req.pod_name}",
            container=req.container_id,
        ):
            try:
                return self._add(req)
            finally:
                if self.duration_hist is not None:
                    self.duration_hist.observe(
                        time.perf_counter() - t0, op="add")

    def _add(self, req: CNIRequest) -> CNIReply:
        with self._lock:
            if not self._ready:
                return CNIReply(
                    result=ResultCode.TRY_AGAIN,
                    error="vswitch base config not ready",
                )
            existing = self.index.lookup(req.container_id)
            if existing is not None:
                # idempotent re-Add (kubelet retries): answer as success
                return self._reply_for(existing)
            # Sandbox recreation: a new container ID for a pod we already
            # wired. Tear the old container down first so the stale DEL
            # kubelet sends later is a harmless no-op — otherwise old and
            # new would share one interface and the late DEL would cut
            # the live pod's connectivity.
            pod_id = f"{req.pod_namespace}/{req.pod_name}"
            ip = None
            if_idx = None
            pod = (req.pod_namespace, req.pod_name)
            try:
                with self.dp.commit_lock:
                    stale = self.index.lookup_pod(
                        req.pod_namespace, req.pod_name
                    )
                    if stale is not None:
                        self.index.unregister(stale.container_id)
                        self.dp.builder.del_route(f"{stale.ip}/32")
                        self.dp.del_pod_interface(
                            (stale.pod_namespace, stale.pod_name)
                        )
                        self.ipam.release_pod_ip(pod_id)
                        if self.wirer is not None:
                            self.wirer.unwire(
                                container_id=stale.container_id,
                                netns=stale.netns,
                                if_index=stale.if_index,
                                pod_ip=stale.ip,
                            )
                    ip = self.ipam.next_pod_ip(pod_id)
                    if_idx = self.dp.add_pod_interface(pod)
                    self.dp.builder.add_route(
                        f"{ip}/32", if_idx, Disposition.LOCAL
                    )
                    self.dp.builder.txn_label = f"cni-add {pod_id}"
                    self.dp.swap()
                # kernel path: veth pair + netns config + daemon attach
                # (the reference's configurePodInterface step,
                # remote_cni_server.go:1039; rolls itself back on error)
                if self.wirer is not None and req.netns:
                    self.wirer.wire(
                        container_id=req.container_id,
                        netns=req.netns,
                        if_name=req.if_name,
                        if_index=if_idx,
                        pod_ip=str(ip),
                    )
                cfg = ContainerConfig(
                    container_id=req.container_id,
                    pod_name=req.pod_name,
                    pod_namespace=req.pod_namespace,
                    if_index=if_idx,
                    if_name=req.if_name,
                    ip=str(ip),
                    netns=req.netns,
                )
                self.index.register(cfg)
            except Exception as e:  # IPAM full, interface table full, ...
                log.exception("CNI Add failed for %s", req.container_id)
                with self.dp.commit_lock:
                    if if_idx is not None:
                        # unwind the dataplane config so a kubelet retry
                        # starts from a clean slate
                        self.dp.builder.del_route(f"{ip}/32")
                        self.dp.del_pod_interface(pod)
                        self.dp.swap()
                    if ip is not None:
                        # half-configured: release the (persisted)
                        # allocation or every retry leaks another pod IP
                        self.ipam.release_pod_ip(pod_id)
                # IO daemon not (yet) reachable on its control socket —
                # a boot-order transient (vpp-tpu-init starts it after
                # the agent): tell kubelet to retry, not that the pod
                # can never be wired
                if isinstance(e, (FileNotFoundError, ConnectionError)):
                    return CNIReply(result=ResultCode.TRY_AGAIN,
                                    error=str(e))
                return CNIReply(result=ResultCode.ERROR, error=str(e))
        self._notify()
        return self._reply_for(cfg)

    def delete(self, req: CNIRequest) -> CNIReply:
        t0 = time.perf_counter()
        with spans.RECORDER.span(
            "cni", f"cni-del {req.container_id}",
        ):
            try:
                return self._delete(req)
            finally:
                if self.duration_hist is not None:
                    self.duration_hist.observe(
                        time.perf_counter() - t0, op="del")

    def _delete(self, req: CNIRequest) -> CNIReply:
        with self._lock:
            cfg = self.index.unregister(req.container_id)
            if cfg is None:
                # unknown container: CNI DEL must be idempotent
                return CNIReply(result=ResultCode.OK)
            pod = (cfg.pod_namespace, cfg.pod_name)
            with self.dp.commit_lock:
                self.dp.builder.del_route(f"{cfg.ip}/32")
                self.dp.del_pod_interface(pod)
                self.ipam.release_pod_ip(f"{cfg.pod_namespace}/{cfg.pod_name}")
                self.dp.builder.txn_label = (
                    f"cni-del {cfg.pod_namespace}/{cfg.pod_name}"
                )
                self.dp.swap()
            if self.wirer is not None:
                self.wirer.unwire(
                    container_id=cfg.container_id, netns=cfg.netns,
                    if_index=cfg.if_index, pod_ip=cfg.ip,
                )
        self._notify()
        return CNIReply(result=ResultCode.OK)

    # --- helpers ---
    def _notify(self) -> None:
        if self.on_pod_change is not None:
            try:
                self.on_pod_change()
            except Exception:
                log.exception("on_pod_change callback failed")

    def _reply_for(self, cfg: ContainerConfig) -> CNIReply:
        gw = str(self.ipam.pod_gateway_ip())
        return CNIReply(
            result=ResultCode.OK,
            interfaces=[
                CNIInterface(
                    name=cfg.if_name,
                    sandbox=cfg.netns,
                    ip_addresses=[
                        CNIIpAddress(address=f"{cfg.ip}/32", gateway=gw)
                    ],
                )
            ],
            routes=[CNIRoute(dst="0.0.0.0/0", gw=gw)],
        )

    def dispatch(self, method: str, params: dict) -> dict:
        """Transport-level entry: method name + request dict → reply dict."""
        req = CNIRequest.from_dict(params)
        if method == "Add":
            return self.add(req).to_dict()
        if method == "Delete":
            return self.delete(req).to_dict()
        return CNIReply(
            result=ResultCode.ERROR, error=f"unknown method {method!r}"
        ).to_dict()
