"""The fused packet pipeline on torch tensors: packet vectors, device
tables, the step and the Dataplane wrapper."""
