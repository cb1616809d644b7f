"""Process entry points and DI wiring ("flavors").

Reference analogs: flavors/contiv (plugin set + Inject,
contiv_flavor.go:70-191), cmd/contiv-agent/main.go (event loop +
SIGTERM close), flavors/ksr + cmd/contiv-ksr.
"""

from vpp_tpu_torch.cmd.config import AgentConfig, load_config
from vpp_tpu_torch.cmd.agent import ContivAgent

__all__ = ["AgentConfig", "ContivAgent", "load_config"]
