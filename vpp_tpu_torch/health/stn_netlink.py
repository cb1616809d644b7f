"""LinuxNetlink: the production NetlinkBackend for the STN daemon.

The port's copy of ``vpp_tpu/health/stn_netlink.py``.

Reference: cmd/contiv-stn records/reverts the NIC's addresses + routes
via netlink (main.go:209-323) and unbinds the PCI driver (pci.go:30-76)
because VPP claims the device through DPDK. This data plane keeps the
kernel netdev and reads it via AF_PACKET, so the steal here is
"take the addressing away from the kernel stack": record then flush
IPs/routes (the kernel stops terminating traffic; the IO daemon owns
the wire), and revert restores exactly what was recorded. PCI
driver unbind/rebind is supported but optional (``pci_unbind=True``) —
with the device unbound there is no netdev for AF_PACKET, so it only
fits a future DMA-class driver.

Implementation shells iproute2/sysfs — same auditable style as
net/linux.py; all state needed for revert lives in the
persisted StolenInterface, so a restarted daemon can still give the
NIC back (reference main.go:486-537 watchdog contract).
"""

from __future__ import annotations

import logging
import os

from vpp_tpu_torch.health.stn import NetlinkBackend, StolenInterface
from vpp_tpu_torch.net.linux import ip_cmd

log = logging.getLogger("vpp_tpu_torch.stn.netlink")


def _sys_net(name: str, *parts: str) -> str:
    return os.path.join("/sys/class/net", name, *parts)


class LinuxNetlink(NetlinkBackend):
    def __init__(self, pci_unbind: bool = False):
        self.pci_unbind = pci_unbind

    # --- discovery ---
    def interface_info(self, name: str) -> StolenInterface:
        addrs = []
        for line in ip_cmd("-o", "-4", "addr", "show", "dev",
                           name).stdout.splitlines():
            toks = line.split()
            if "inet" in toks:
                addrs.append(toks[toks.index("inet") + 1])
        routes = []
        # routes THROUGH this device, incl. the default route — exactly
        # what dies when the addresses are flushed and what revert must
        # put back (reference main.go stores dst+gw the same way)
        for line in ip_cmd("-o", "-4", "route", "show").stdout.splitlines():
            toks = line.split()
            if "dev" not in toks or toks[toks.index("dev") + 1] != name:
                continue
            dst = toks[0]
            gw = toks[toks.index("via") + 1] if "via" in toks else ""
            if dst == "default" or gw:  # connected /prefix routes come
                routes.append({"dst": dst, "gw": gw})  # back with the addr
        pci, driver = "", ""
        dev = _sys_net(name, "device")
        if os.path.islink(dev):
            pci = os.path.basename(os.readlink(dev))
            drv = os.path.join(dev, "driver")
            if os.path.islink(drv):
                driver = os.path.basename(os.readlink(drv))
        return StolenInterface(
            name=name, pci_addr=pci, driver=driver,
            ip_addresses=addrs, routes=routes,
        )

    # --- steal ---
    def unbind(self, iface: StolenInterface) -> None:
        if self.pci_unbind and iface.pci_addr and iface.driver:
            with open(f"/sys/bus/pci/drivers/{iface.driver}/unbind",
                      "w") as f:
                f.write(iface.pci_addr)
            return
        # flush the kernel's addressing; leave the link up + promisc for
        # the IO daemon's AF_PACKET socket
        ip_cmd("addr", "flush", "dev", iface.name)
        ip_cmd("link", "set", iface.name, "up", "promisc", "on")

    # --- give back ---
    def rebind(self, iface: StolenInterface) -> None:
        if self.pci_unbind and iface.pci_addr and iface.driver:
            with open(f"/sys/bus/pci/drivers/{iface.driver}/bind",
                      "w") as f:
                f.write(iface.pci_addr)
            return
        ip_cmd("link", "set", iface.name, "promisc", "off", check=False)
        ip_cmd("link", "set", iface.name, "up")

    def restore_config(self, iface: StolenInterface) -> None:
        for cidr in iface.ip_addresses:
            ip_cmd("addr", "replace", cidr, "dev", iface.name)
        for route in iface.routes:
            args = ["route", "replace", route["dst"]]
            if route.get("gw"):
                args += ["via", route["gw"]]
            args += ["dev", iface.name]
            ip_cmd(*args, check=False)
