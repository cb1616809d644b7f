"""Host networking helpers: veth / netns plumbing over ip(8)
(``net/linux.py``) and the shared retry pacing policy
(``net/backoff.py``), the port's copies of ``vpp_tpu/net``."""

from vpp_tpu_torch.net.backoff import Backoff, backoff_with_jitter
from vpp_tpu_torch.net.linux import (
    IpCmdError,
    create_veth,
    delete_link,
    ensure_named_netns,
    get_mac,
    ip_cmd,
    link_exists,
    move_to_netns,
    release_named_netns,
    setup_pod_interface,
)

__all__ = ["Backoff", "IpCmdError", "backoff_with_jitter", "create_veth",
           "delete_link", "ensure_named_netns", "get_mac", "ip_cmd",
           "link_exists", "move_to_netns", "release_named_netns",
           "setup_pod_interface"]
