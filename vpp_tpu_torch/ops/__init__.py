"""Data-plane ops on torch tensors, one module per VPP graph-node
family; the five hot kernels live beside their plain versions in
``session``, ``acl_bv``, ``acl_mxu``, ``lpm`` and ``mlscore`` and are
built by ``_cuda``."""
