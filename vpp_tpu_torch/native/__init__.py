"""Native (C++) runtime components.

The per-packet IO path between the NIC-facing process and the agent is
native, like the reference's govpp shared-memory transport + VPP vlib
frames (SURVEY.md §2.3) — Python only maps committed frames as numpy
views and hands them to the pipeline. The port's copy of
``vpp_tpu/native``; ``g++`` builds each library at first use into
``native/build/``.
"""

from vpp_tpu_torch.native.ring import FrameRing, RING_COLUMNS, build_library

__all__ = ["FrameRing", "RING_COLUMNS", "build_library"]
