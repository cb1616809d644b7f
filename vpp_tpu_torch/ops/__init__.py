"""Data-plane ops on torch tensors, one module per VPP graph-node
family; the four hot kernels live beside their plain versions in
``session``, ``acl_bv``, ``acl_mxu`` and ``lpm`` and are built by
``_cuda``."""
