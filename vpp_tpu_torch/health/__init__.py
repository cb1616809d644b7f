"""Failure detection & recovery.

Reference analogs: cn-infra's statuscheck plugin (per-plugin liveness
aggregated into agent state, probe HTTP endpoints — wired in
flavors/contiv/contiv_flavor.go:124-126) and the contiv-stn host daemon
(cmd/contiv-stn/main.go — NIC stealing with a watchdog that reverts the
NIC to the kernel when the agent stops answering its health port).
"""

from vpp_tpu_torch.health.statuscheck import PluginState, StatusCheck
from vpp_tpu_torch.health.stn import FakeNetlink, STNDaemon, StolenInterface

__all__ = [
    "FakeNetlink",
    "PluginState",
    "STNDaemon",
    "StatusCheck",
    "StolenInterface",
]
