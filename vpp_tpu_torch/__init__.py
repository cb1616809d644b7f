"""vpp_tpu_torch — the PyTorch/CUDA data plane.

A second implementation of ``vpp_tpu``'s packet path for one NVIDIA
H100: the same fused step (ip4-input -> reflective sessions -> NAT44
reverse/DNAT -> ACL classify -> FIB -> SNAT -> session/NAT record,
with the per-packet ML scoring stage and the telemetry plane) and its
two-tier established-flow dispatcher, the same table layout and the
same results bit for bit, with the TPU's Pallas kernels rewritten as
CUDA kernels for Hopper (``csrc/``).

The package imports torch and numpy only — never jax, never vpp_tpu.
Entry points run on the card unless the caller asks for the CPU.
"""
