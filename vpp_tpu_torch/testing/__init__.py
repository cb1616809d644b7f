"""Test seams of vpp_tpu_torch (fault injection)."""
