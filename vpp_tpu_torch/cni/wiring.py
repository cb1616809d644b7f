"""VethPodWirer: give a CNI Add a real kernel interface path.

The port's copy of ``vpp_tpu/cni/wiring.py``. Without a wirer the CNI
server allocates an interface *index* and routes, but no kernel
interface exists and the IO daemon cannot learn about it. This wirer is the reference's configurePodInterface semantics
(plugins/contiv/pod.go:262-360, remote_cni_server.go:1039-1250) built
for the IO-daemon split:

  * create a veth pair; the host side stays in the agent's netns and is
    attached to the IO daemon as an AF_PACKET endpoint via the control
    channel (io/control.py) — the "plug the TAP into the vswitch" step;
  * the container side moves into the pod's netns, renamed to the CNI
    if_name, configured with the pod /32, link-scope + default routes
    through the virtual gateway, and a static ARP for the gateway MAC
    (pod.go:375-452's static ARP entries);
  * the pod's (ip → MAC) is pushed to the daemon so first packets
    toward the pod never broadcast-flood;
  * unwire detaches + deletes the pair (deleting the host side tears
    down both ends), releasing the bind-mounted netns name if one was
    created.

Wire/unwire are transactional from the CNI server's point of view: any
failure mid-wire rolls back what was created before re-raising.
"""

from __future__ import annotations

import logging

from vpp_tpu_torch.net import linux

log = logging.getLogger("vpp_tpu_torch.cni.wiring")

# gateway MAC the data plane answers from: locally-administered, stable
# (the pod's static ARP entry points here; the daemon rewrites source
# MACs on tx anyway)
GATEWAY_MAC = b"\x02\xfe\x00\x00\x00\x01"


def host_ifname(container_id: str) -> str:
    """Deterministic host-side veth name, kernel-limit safe (<=15). The
    reference's name byte for byte, so an agent of either package finds
    (and cleans up) the other's veths after a restart."""
    return "vpp" + container_id.replace("-", "")[:11]


class HostInterconnectWirer:
    """VPP↔host-stack interconnect: the node's own Linux stack reaches
    pod and service IPs through the data plane, and punted (HOST
    disposition) traffic lands in the kernel.

    Reference: configureVswitchConnectivity's interconnect veth/TAP +
    host routes (plugins/contiv/host.go:105-200
    interconnectVethHost/interconnectVethVpp, :44-86
    routePODsFromHost/routeServicesFromHost) — a veth pair whose host
    end carries the IPAM host-interconnect address and routes for the
    pod + service subnets via the vswitch end, while the vswitch end is
    attached to the IO daemon as the dataplane's host interface.
    """

    def __init__(self, io_ctl, ipam, gateway_mac: bytes = GATEWAY_MAC,
                 host_end: str = "vpptpu-host", vsw_end: str = "vpptpu-vsw"):
        self.io_ctl = io_ctl
        self.ipam = ipam
        self.gateway_mac = gateway_mac
        self.host_end = host_end
        self.vsw_end = vsw_end

    def wire(self, host_if_index: int) -> bytes:
        """Create + attach the interconnect; returns the host-end MAC."""
        vpp_ip = str(self.ipam.veth_vpp_end_ip())
        host_ip = str(self.ipam.veth_host_end_ip())
        plen = self.ipam.vpp_host_network.prefixlen
        try:
            if linux.link_exists(self.host_end):
                # stale pair from a crashed agent: recreate cleanly
                linux.delete_link(self.host_end)
            linux.create_veth(self.host_end, self.vsw_end)
            # v4-only like the reference's interconnect: the data plane
            # punts non-IPv4 ingress back toward the host interface, so
            # the host end must not source IPv6 ND (reflected DAD
            # probes would fail the address)
            linux.ip_cmd("link", "set", self.host_end, "addrgenmode", "none")
            linux.ip_cmd("addr", "add", f"{host_ip}/{plen}",
                         "dev", self.host_end)
            linux.ip_cmd("link", "set", self.host_end, "up")
            linux.ip_cmd("link", "set", self.vsw_end, "up")
            linux.disable_offload(self.host_end)
            self.io_ctl.attach(host_if_index, "afpacket", self.vsw_end)
            # static ARP for the vswitch end (the data plane answers
            # from the gateway MAC; it never speaks ARP itself)
            gw_mac_s = ":".join(f"{b:02x}" for b in self.gateway_mac)
            linux.ip_cmd("neigh", "replace", vpp_ip, "lladdr", gw_mac_s,
                         "dev", self.host_end, "nud", "permanent")
            # host → pods/services via the data plane (routePODsFromHost
            # + routeServicesFromHost)
            for net in (self.ipam.pod_subnet, self.ipam.service_network):
                linux.ip_cmd("route", "replace", str(net), "via", vpp_ip,
                             "dev", self.host_end, "onlink")
            host_mac = linux.get_mac(self.host_end)
            # push (host-end ip → MAC) so the first dataplane→host
            # frames address the kernel directly instead of flooding
            from vpp_tpu_torch.pipeline.vector import ip4

            if self.io_ctl.set_mac(int(ip4(host_ip)), host_mac):
                log.warning(
                    "host interconnect static MAC displaced another "
                    "pinned neighbor entry (table pin pressure)"
                )
            return host_mac
        except Exception:
            log.exception("host interconnect wire failed; rolling back")
            try:
                self.io_ctl.detach(host_if_index)
            except Exception:  # noqa: BLE001 — best-effort rollback
                pass
            linux.delete_link(self.host_end)
            raise

    def unwire(self, host_if_index: int) -> None:
        """Tear the interconnect down (idempotent)."""
        try:
            self.io_ctl.detach(host_if_index)
        except Exception:  # noqa: BLE001 — daemon may be restarting
            log.warning("detach host interconnect if %d failed",
                        host_if_index)
        try:
            from vpp_tpu_torch.pipeline.vector import ip4

            self.io_ctl.del_mac(int(ip4(str(self.ipam.veth_host_end_ip()))))
        except Exception:  # noqa: BLE001 — best-effort cleanup
            log.warning("host interconnect static MAC unpin failed")
        linux.delete_link(self.host_end)


class VethPodWirer:
    """Creates/destroys the kernel path for one pod interface."""

    def __init__(self, io_ctl, gateway_ip: str,
                 gateway_mac: bytes = GATEWAY_MAC):
        self.io_ctl = io_ctl
        self.gateway_ip = gateway_ip
        self.gateway_mac = gateway_mac

    def wire(self, *, container_id: str, netns: str, if_name: str,
             if_index: int, pod_ip: str) -> bytes:
        """Create + attach the pod link; returns the container MAC."""
        host_if = host_ifname(container_id)
        peer = "p" + host_if[:14]
        ns_name = None
        try:
            ns_name = linux.ensure_named_netns(netns)
            if linux.link_exists(host_if):
                # stale pair from a crashed wire (or kubelet retry after
                # partial failure): recreate cleanly
                linux.delete_link(host_if)
            linux.create_veth(host_if, peer)
            linux.move_to_netns(peer, ns_name)
            pod_mac = linux.setup_pod_interface(
                ns_name, peer, if_name, f"{pod_ip}/32",
                self.gateway_ip, self.gateway_mac,
            )
            linux.ip_cmd("link", "set", host_if, "up")
            self.io_ctl.attach(if_index, "afpacket", host_if)
            from vpp_tpu_torch.pipeline.vector import ip4

            if self.io_ctl.set_mac(int(ip4(pod_ip)), pod_mac):
                log.warning(
                    "static MAC for pod %s displaced another pod's "
                    "pinned neighbor entry (table pin pressure)",
                    container_id,
                )
            return pod_mac
        except Exception:
            log.exception("pod wire failed for %s; rolling back",
                          container_id)
            try:
                self.io_ctl.detach(if_index)
            except Exception:  # noqa: BLE001 — best-effort rollback
                pass
            linux.delete_link(host_if)
            if ns_name is not None:
                linux.release_named_netns(netns)
            raise

    def re_attach(self, *, container_id: str, netns: str, if_name: str,
                  if_index: int, pod_ip: str) -> None:
        """Agent/daemon restart path: the veth pair survived, so only
        re-plug the host side into the (possibly fresh) IO daemon and
        re-push the pod's static MAC — a restarted daemon starts with an
        empty (ip → MAC) table and would broadcast-flood toward silent
        pods otherwise."""
        from vpp_tpu_torch.pipeline.vector import ip4

        self.io_ctl.attach(if_index, "afpacket", host_ifname(container_id))
        try:
            if netns:
                ns_name = linux.ensure_named_netns(netns)
                pod_mac = linux.get_mac(if_name, netns=ns_name)
                self.io_ctl.set_mac(int(ip4(pod_ip)), pod_mac)
        except Exception:  # noqa: BLE001 — MAC push is best-effort here;
            # rx learning recovers it on the pod's first transmission
            log.warning("static MAC re-push failed for %s", container_id)

    def unwire(self, *, container_id: str, netns: str,
               if_index: int, pod_ip: str = "") -> None:
        """Tear down the pod link (idempotent — CNI DEL semantics)."""
        try:
            self.io_ctl.detach(if_index)
        except Exception:  # noqa: BLE001 — daemon may be restarting
            log.warning("detach if %d failed during unwire", if_index)
        if pod_ip:
            # unpin the static neighbor entry so it stops holding
            # pin-limited table space for a deleted pod
            try:
                from vpp_tpu_torch.pipeline.vector import ip4

                self.io_ctl.del_mac(int(ip4(pod_ip)))
            except Exception:  # noqa: BLE001 — best-effort cleanup
                log.warning("static MAC unpin failed for %s", container_id)
        linux.delete_link(host_ifname(container_id))
        if netns:
            try:
                linux.release_named_netns(netns)
            except Exception:  # noqa: BLE001
                pass
