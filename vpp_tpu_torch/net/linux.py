"""Kernel network plumbing via the ip(8) command.

The port's copy of ``vpp_tpu/net/linux.py``.

The reference wires pods with netlink through vishvananda/netlink (veth
create + move into the container netns + address/route/ARP config,
plugins/contiv/pod.go:262-360 and the Linux side of the
vpp-agent linuxplugin). Shelling out to iproute2 keeps this dependency-
free and auditable; every helper is a thin, testable wrapper and the
callers treat failures as transactional (rollback on partial wiring).

Netns handling: kubelet hands the CNI a netns *path* (usually
/proc/<pid>/ns/net or /var/run/netns/<name>). iproute2 addresses named
netns under /var/run/netns, so paths outside it are bind-mounted to a
managed name first (the same trick CNI plugins use).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, Optional

NETNS_DIR = "/var/run/netns"


class IpCmdError(RuntimeError):
    def __init__(self, argv: List[str], rc: int, err: str):
        super().__init__(f"{' '.join(argv)!r} rc={rc}: {err.strip()}")
        self.argv = argv
        self.rc = rc
        self.err = err


def ip_cmd(*args: str, netns: Optional[str] = None,
           check: bool = True) -> subprocess.CompletedProcess:
    """Run ip(8), optionally inside a named netns."""
    argv = ["ip"]
    if netns:
        argv += ["-n", netns]
    argv += list(args)
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=30)
    if check and proc.returncode != 0:
        raise IpCmdError(argv, proc.returncode, proc.stderr)
    return proc


def link_exists(name: str, netns: Optional[str] = None) -> bool:
    return ip_cmd("link", "show", name, netns=netns,
                  check=False).returncode == 0


def create_veth(host: str, peer: str) -> None:
    ip_cmd("link", "add", host, "type", "veth", "peer", "name", peer)


def delete_link(name: str, netns: Optional[str] = None) -> bool:
    return ip_cmd("link", "del", name, netns=netns,
                  check=False).returncode == 0


def disable_offload(name: str, netns: Optional[str] = None) -> None:
    """Disable tx/rx checksum offload on a veth end. Over veth the
    kernel leaves TCP/UDP checksums partial (CHECKSUM_PARTIAL) since no
    physical NIC ever fills them in; a userspace data plane forwarding
    raw frames would deliver garbage checksums that the receiving stack
    drops. Best-effort (ethtool may be absent in minimal images)."""
    argv = ["ethtool", "-K", name, "tx", "off", "rx", "off"]
    if netns:
        argv = ["ip", "netns", "exec", netns] + argv
    subprocess.run(argv, capture_output=True, timeout=30)


def get_mac(name: str, netns: Optional[str] = None) -> bytes:
    out = ip_cmd("-o", "link", "show", name, netns=netns).stdout
    # "N: name: ... link/ether aa:bb:cc:dd:ee:ff brd ..."
    tok = out.split("link/ether")
    if len(tok) < 2:
        raise IpCmdError(["ip", "link", "show", name], 0,
                         f"no link/ether in {out!r}")
    return bytes.fromhex(tok[1].split()[0].replace(":", ""))


def ensure_named_netns(netns_path: str) -> str:
    """Return an iproute2-addressable netns name for ``netns_path``.

    A path under /var/run/netns is used as-is; anything else (e.g.
    kubelet's /proc/<pid>/ns/net) is bind-mounted to a managed name —
    the standard CNI-plugin technique for making an anonymous netns
    addressable."""
    netns_path = os.path.abspath(netns_path)
    if os.path.dirname(netns_path) == NETNS_DIR:
        return os.path.basename(netns_path)
    name = "vpp-" + hashlib.sha256(netns_path.encode()).hexdigest()[:12]
    target = os.path.join(NETNS_DIR, name)
    if not os.path.exists(target):
        os.makedirs(NETNS_DIR, exist_ok=True)
        open(target, "w").close()
        proc = subprocess.run(
            ["mount", "--bind", netns_path, target],
            capture_output=True, text=True, timeout=30,
        )
        if proc.returncode != 0:
            try:
                os.unlink(target)
            except OSError:
                pass
            raise IpCmdError(["mount", "--bind", netns_path, target],
                             proc.returncode, proc.stderr)
    return name


def release_named_netns(netns_path: str) -> None:
    """Undo ensure_named_netns for a bind-mounted path (no-op for
    natively named netns)."""
    netns_path = os.path.abspath(netns_path)
    if os.path.dirname(netns_path) == NETNS_DIR:
        return
    name = "vpp-" + hashlib.sha256(netns_path.encode()).hexdigest()[:12]
    target = os.path.join(NETNS_DIR, name)
    if os.path.exists(target):
        subprocess.run(["umount", target], capture_output=True, timeout=30)
        try:
            os.unlink(target)
        except OSError:
            pass


def move_to_netns(ifname: str, netns_name: str) -> None:
    ip_cmd("link", "set", ifname, "netns", netns_name)


def setup_pod_interface(netns_name: str, ifname: str, new_name: str,
                        ip_cidr: str, gw_ip: str, gw_mac: bytes) -> bytes:
    """Configure the container side of a pod link, mirroring the
    reference's pod config (pod.go:262-360 + the ARP/route builders
    :363-452): rename to the CNI-requested name, /32 address, link-scope
    route to the gateway, default route via it, static ARP for the
    gateway (the data plane answers to that MAC). Returns the container
    interface's MAC."""
    ip_cmd("link", "set", ifname, "name", new_name, netns=netns_name)
    ip_cmd("link", "set", "lo", "up", netns=netns_name)
    ip_cmd("link", "set", new_name, "up", netns=netns_name)
    ip_cmd("addr", "add", ip_cidr, "dev", new_name, netns=netns_name)
    gw_mac_s = ":".join(f"{b:02x}" for b in gw_mac)
    ip_cmd("route", "add", gw_ip, "dev", new_name, "scope", "link",
           netns=netns_name)
    ip_cmd("route", "add", "default", "via", gw_ip, "dev", new_name,
           "onlink", netns=netns_name)
    ip_cmd("neigh", "replace", gw_ip, "lladdr", gw_mac_s, "dev", new_name,
           "nud", "permanent", netns=netns_name)
    # The reference's VPP negotiates checksum offload on its TAP /
    # af_packet interfaces instead; a userspace plane must turn it off.
    disable_offload(new_name, netns=netns_name)
    return get_mac(new_name, netns=netns_name)
