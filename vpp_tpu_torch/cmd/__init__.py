"""Process entry points and DI wiring ("flavors").

Reference analogs: flavors/contiv (plugin set + Inject,
contiv_flavor.go:70-191), cmd/contiv-agent/main.go (event loop +
SIGTERM close), flavors/ksr + cmd/contiv-ksr.
"""

from vpp_tpu_torch._lazy import lazy_exports

__all__ = ["AgentConfig", "ContivAgent", "load_config"]
# imported at first use (_lazy.py): the IO daemon's process imports no torch
__getattr__ = lazy_exports(__name__, {
    "AgentConfig": "vpp_tpu_torch.cmd.config",
    "load_config": "vpp_tpu_torch.cmd.config",
    "ContivAgent": "vpp_tpu_torch.cmd.agent",
})
