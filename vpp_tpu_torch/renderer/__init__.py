"""The renderer boundary: pluggable southbound policy-rendering backends.

Reference: plugins/policy/renderer (api.go + cache/).
"""

from vpp_tpu_torch.renderer.api import PodConfig, PolicyRendererAPI, RendererTxn
from vpp_tpu_torch.renderer.cache import Orientation, RendererCache, TxnChange

__all__ = [
    "PodConfig",
    "PolicyRendererAPI",
    "RendererTxn",
    "Orientation",
    "RendererCache",
    "TxnChange",
]
