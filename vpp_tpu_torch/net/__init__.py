"""Host networking helpers: the shared retry pacing policy
(``net/backoff.py``, the port's copy of ``vpp_tpu/net/backoff.py``)."""

from vpp_tpu_torch.net.backoff import Backoff, backoff_with_jitter

__all__ = ["Backoff", "backoff_with_jitter"]
