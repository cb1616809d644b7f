"""Packet transports: how raw frames enter and leave the IO daemon.

The port's copy of ``vpp_tpu/io/transport.py``.

Production transports are AF_PACKET (bind a kernel interface, the
af-packet-input analog) and TAP (/dev/net/tun, the tapcli-rx analog);
tests and unprivileged dev use SOCK_DGRAM socketpairs which preserve
frame boundaries. All expose fileno() so the daemon can select() across
every interface at once.

Reference: VPP's af_packet/tap drivers configured by the vswitch
(contiv-vswitch.conf:8-11, pod TAP/veth+af_packet builders
plugins/contiv/pod.go:262-360).
"""

from __future__ import annotations

import fcntl
import os
import socket
import struct
from typing import List, Optional, Tuple

ETH_P_ALL = 0x0003
TUNSETIFF = 0x400454CA
IFF_TAP = 0x0002
IFF_NO_PI = 0x1000
SIOCGIFHWADDR = 0x8927

BROADCAST_MAC = b"\xff\xff\xff\xff\xff\xff"


class Transport:
    """One packet endpoint (an "interface" of the data plane)."""

    name: str = ""
    mac: bytes = b"\x02\x00\x00\x00\x00\x00"

    @property
    def batch_fd(self) -> Optional[int]:
        """Socket fd usable with sendmmsg/recvmmsg (the native batch
        path, native/pkt_io.cpp), or None — TAP is a char device whose
        fd the mmsg syscalls reject, so it keeps the per-frame path."""
        return None

    def fileno(self) -> int:
        raise NotImplementedError

    def recv_frames(self, max_frames: int) -> List[bytes]:
        """Drain up to max_frames raw frames without blocking."""
        raise NotImplementedError

    def send_frame(self, frame: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


def _drain_fd_socket(sock: socket.socket, max_frames: int,
                     bufsize: int = 65535) -> List[bytes]:
    out: List[bytes] = []
    while len(out) < max_frames:
        try:
            data = sock.recv(bufsize)
        except BlockingIOError:
            break
        except OSError:
            break
        if not data:
            break
        out.append(data)
    return out


class AfPacketTransport(Transport):
    """Raw L2 socket bound to a kernel interface (requires CAP_NET_RAW)."""

    def __init__(self, ifname: str, rcvbuf: int = 64 << 20):
        self.name = ifname
        self.sock = socket.socket(
            socket.AF_PACKET, socket.SOCK_RAW, socket.htons(ETH_P_ALL)
        )
        # deep rx queue: the daemon drains in bursts (select → recvmmsg
        # batches) while sharing a core with the pump; the default
        # ~200 KB socket buffer drops entire line-rate bursts between
        # drains. RCVBUFFORCE pierces rmem_max under CAP_NET_ADMIN
        # (which af_packet needs anyway); fall back to the clamped set.
        SO_RCVBUFFORCE = 33
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, SO_RCVBUFFORCE, rcvbuf)
        except OSError:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 rcvbuf)
        # Never receive our OWN transmissions: without this every frame
        # the daemon sends on an interface is looped back into its rx
        # path (PACKET_OUTGOING), re-enters the pipeline, and — for
        # LOCAL-delivered traffic — re-transmits out the same interface
        # until TTL exhausts: ~60 wasted pipeline passes per delivered
        # packet, the dominant (hidden) cost of a wire path.
        SOL_PACKET, PACKET_IGNORE_OUTGOING = 263, 23
        try:
            self.sock.setsockopt(SOL_PACKET, PACKET_IGNORE_OUTGOING, 1)
        except OSError:
            pass  # pre-4.20 kernel: loop suppressed by TTL only
        self.sock.bind((ifname, 0))
        self.sock.setblocking(False)
        info = fcntl.ioctl(
            self.sock.fileno(), SIOCGIFHWADDR,
            struct.pack("256s", ifname.encode()[:15]),
        )
        self.mac = info[18:24]

    @property
    def batch_fd(self):
        return self.sock.fileno()

    def fileno(self) -> int:
        return self.sock.fileno()

    def recv_frames(self, max_frames: int) -> List[bytes]:
        return _drain_fd_socket(self.sock, max_frames)

    def send_frame(self, frame: bytes) -> None:
        try:
            self.sock.send(frame)
        except (BlockingIOError, OSError):
            pass  # tx queue full: drop (counted by the daemon)

    def close(self) -> None:
        self.sock.close()


class TapTransport(Transport):
    """TAP device via /dev/net/tun (requires CAP_NET_ADMIN)."""

    def __init__(self, name: str):
        self.name = name
        self.fd = os.open("/dev/net/tun", os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH22s", name.encode()[:15],
                          IFF_TAP | IFF_NO_PI, b"")
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        self.mac = b"\x02" + os.urandom(5)

    def fileno(self) -> int:
        return self.fd

    def recv_frames(self, max_frames: int) -> List[bytes]:
        out: List[bytes] = []
        while len(out) < max_frames:
            try:
                data = os.read(self.fd, 65535)
            except BlockingIOError:
                break
            except OSError:
                break
            if not data:
                break
            out.append(data)
        return out

    def send_frame(self, frame: bytes) -> None:
        try:
            os.write(self.fd, frame)
        except (BlockingIOError, OSError):
            pass

    def close(self) -> None:
        os.close(self.fd)


def make_transport(kind: str, arg: str) -> Transport:
    """Transport factory used by the daemon CLI and the control channel
    (attach): afpacket:IFNAME | tap:NAME | fd:N."""
    if kind == "afpacket":
        return AfPacketTransport(arg)
    if kind == "tap":
        return TapTransport(arg)
    if kind == "fd":
        return SocketPairTransport(
            socket.socket(fileno=int(arg)), name=f"fd{arg}"
        )
    raise ValueError(f"unknown transport kind {kind!r}")


class SocketPairTransport(Transport):
    """Frame transport over a SOCK_DGRAM socketpair (tests / dev).

    ``pair()`` returns (inside, outside): `inside` is the daemon's side;
    `outside` plays the wire — tests send/receive raw frames through it.
    """

    def __init__(self, sock: socket.socket, name: str = "pair"):
        self.name = name
        self.sock = sock
        self.sock.setblocking(False)
        self.mac = b"\x02" + os.urandom(5)

    @classmethod
    def pair(cls, name: str = "pair") -> Tuple["SocketPairTransport",
                                               "SocketPairTransport"]:
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
        for s in (a, b):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
            except OSError:
                pass
        return cls(a, f"{name}-in"), cls(b, f"{name}-out")

    @property
    def batch_fd(self):
        return self.sock.fileno()

    def fileno(self) -> int:
        return self.sock.fileno()

    def recv_frames(self, max_frames: int) -> List[bytes]:
        return _drain_fd_socket(self.sock, max_frames)

    def send_frame(self, frame: bytes) -> None:
        try:
            self.sock.send(frame)
        except (BlockingIOError, OSError):
            pass

    def close(self) -> None:
        self.sock.close()
