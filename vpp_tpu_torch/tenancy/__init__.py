"""Multi-tenant gateway mode: tenant derivation, token buckets and the
per-tenant accounting planes on the device (``derive``), and the
configuration checks of a ``tenants:`` list (``sched``, which imports
no torch at module load)."""
