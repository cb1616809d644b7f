"""Distributed node-local IPAM (no central allocator)."""

from vpp_tpu_torch.ipam.ipam import IPAM, IpamConfig

__all__ = ["IPAM", "IpamConfig"]
