"""The IO pump: frame rings in, the data plane on the card, frames out.

The port's counterpart of ``vpp_tpu/io``: the shared-memory frame rings
(``IORing`` / ``IORingPair``, over the native SPSC ring of
``native/frame_ring.cpp``), the device descriptor rings' host half
(``DeviceDescRing``), the ``DataplanePump`` in both modes (the dispatch
ladder and the persistent ring, pipeline/persistent.py), the latency
governor and priority lane (``LatencyGovernor``, ``PriorityFilter``) and
host ICMP error generation (io/icmp.py). The IO daemon and its
transports are not ported yet (ROADMAP Queue 1 item 12).
"""

from vpp_tpu_torch.io.governor import LatencyGovernor, PriorityFilter
from vpp_tpu_torch.io.pump import DataplanePump
from vpp_tpu_torch.io.rings import DeviceDescRing, IORing, IORingPair

__all__ = ["DataplanePump", "DeviceDescRing", "IORing", "IORingPair",
           "LatencyGovernor", "PriorityFilter"]
