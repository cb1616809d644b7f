"""vpp_tpu_torch — the PyTorch/CUDA data plane.

A second implementation of ``vpp_tpu``'s packet path for one NVIDIA
H100: the same fused step ([VXLAN decap] -> ip4-input -> [tenant
stage] -> reflective sessions -> NAT44 reverse/DNAT (mappings and
service VIPs) -> ACL classify -> FIB (ECMP groups) -> SNAT ->
session/NAT record -> [VXLAN encap], with the per-packet ML scoring
stage, the telemetry plane and tenant-sliced session tables) and its
two-tier established-flow dispatcher, the same table layout and the
same results bit for bit, with the TPU's Pallas kernels rewritten as
CUDA kernels for Hopper (``csrc/``).

The package imports torch and numpy only — never jax, never vpp_tpu.
Entry points run on the card unless the caller asks for the CPU.
"""
