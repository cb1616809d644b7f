"""Packet IO: transports, the IO daemon, the frame rings and the pump.

The port's counterpart of ``vpp_tpu/io``: real packets in from the wire,
through the native codec into shared-memory frame rings, across the data
plane on the card, and back out rewritten.

  wire -> Transport.recv -> PacketCodec.parse -> rx IORing
       -> DataplanePump -> Dataplane.process (card) -> tx IORing
       -> PacketCodec.rewrite (+ VXLAN encap) -> Transport.send -> wire

The transports (``io/transport.py``: AF_PACKET, TAP, socketpairs), the
IO daemon (``io/daemon.py``, its own process under
``cmd/io_daemon.py``) and its control channel (``io/control.py``) are
host code; the shared-memory frame rings (``IORing`` / ``IORingPair``,
over the native SPSC ring of ``native/frame_ring.cpp``), the device
descriptor rings' host half (``DeviceDescRing``), the ``DataplanePump``
in both modes (the dispatch ladder and the persistent ring,
pipeline/persistent.py), the latency governor and priority lane
(``LatencyGovernor``, ``PriorityFilter``) and host ICMP error
generation (io/icmp.py) serve the agent's side; the ``FleetPump``
(io/fleet.py) fronts a gateway fleet's instances, and the
``ClusterPump`` (io/cluster_pump.py) bridges a mesh's per-node rings.
"""

from vpp_tpu_torch._lazy import lazy_exports

__all__ = ["AfPacketTransport", "DataplanePump", "DeviceDescRing",
           "IODaemon", "IORing", "IORingPair", "LatencyGovernor",
           "PriorityFilter", "SocketPairTransport", "TapTransport",
           "Transport"]
# imported at first use (_lazy.py): the IO daemon's process imports no torch
__getattr__ = lazy_exports(__name__, {
    "IODaemon": "vpp_tpu_torch.io.daemon",
    "LatencyGovernor": "vpp_tpu_torch.io.governor",
    "PriorityFilter": "vpp_tpu_torch.io.governor",
    "DataplanePump": "vpp_tpu_torch.io.pump",
    "DeviceDescRing": "vpp_tpu_torch.io.rings",
    "IORing": "vpp_tpu_torch.io.rings",
    "IORingPair": "vpp_tpu_torch.io.rings",
    "AfPacketTransport": "vpp_tpu_torch.io.transport",
    "SocketPairTransport": "vpp_tpu_torch.io.transport",
    "TapTransport": "vpp_tpu_torch.io.transport",
    "Transport": "vpp_tpu_torch.io.transport",
})
