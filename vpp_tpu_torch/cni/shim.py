"""The CNI plugin shim: what kubelet execs per pod sandbox.

Reference analog: cmd/contiv-cni/contiv_cni.go — parse the CNI config
from stdin + CNI_* environment, forward Add/Delete to the agent
(:34-104), translate the agent reply into a CNI spec result (:107-163).
Errors come back as CNI error objects with the spec's error codes.

`run()` is pure (env + stdin bytes → stdout json + exit code) so tests
exercise the full shim without exec'ing a process; `main()` wraps it for
the actual executable entry point (setup.py console script).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Tuple

from vpp_tpu_torch.cni.transport import cni_call

CNI_VERSION = "0.3.1"
DEFAULT_SOCKET = "/run/vpp-tpu/cni.sock"

# CNI spec error codes
ERR_INCOMPATIBLE_VERSION = 1
ERR_UNSUPPORTED_FIELD = 2
ERR_UNKNOWN_CONTAINER = 3
ERR_INVALID_ENV = 4
ERR_IO = 5
ERR_DECODE = 6
ERR_INTERNAL = 7
ERR_TRY_AGAIN = 11


def _parse_cni_args(args: str) -> Dict[str, str]:
    """CNI_ARGS is ';'-separated K=V (K8S_POD_NAME etc.)."""
    out: Dict[str, str] = {}
    for part in args.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _error(code: int, msg: str) -> Tuple[str, int]:
    return (
        json.dumps({"cniVersion": CNI_VERSION, "code": code, "msg": msg}),
        1,
    )


def run(env: Dict[str, str], stdin_data: bytes, call=cni_call) -> Tuple[str, int]:
    """Execute one CNI command. Returns (stdout_json, exit_code)."""
    command = env.get("CNI_COMMAND", "")
    if command == "VERSION":
        return (
            json.dumps(
                {
                    "cniVersion": CNI_VERSION,
                    "supportedVersions": ["0.2.0", "0.3.0", "0.3.1"],
                }
            ),
            0,
        )
    container_id = env.get("CNI_CONTAINERID", "")
    if not container_id:
        return _error(ERR_INVALID_ENV, "CNI_CONTAINERID not set")
    if command not in ("ADD", "DEL"):
        return _error(ERR_INVALID_ENV, f"unsupported CNI_COMMAND {command!r}")
    try:
        conf = json.loads(stdin_data or b"{}")
    except ValueError as e:
        return _error(ERR_DECODE, f"bad netconf: {e}")
    socket_path = conf.get("grpcServer", env.get("CNI_VPP_TPU_SOCKET", DEFAULT_SOCKET))

    params = {
        "container_id": container_id,
        "netns": env.get("CNI_NETNS", ""),
        "if_name": env.get("CNI_IFNAME", "eth0"),
        "extra_args": _parse_cni_args(env.get("CNI_ARGS", "")),
    }
    try:
        reply = call(socket_path, "Add" if command == "ADD" else "Delete", params)
    except OSError as e:
        return _error(ERR_IO, f"agent unreachable at {socket_path}: {e}")

    result = reply.get("result", 1)
    if result == 11:
        return _error(ERR_TRY_AGAIN, reply.get("error", "agent not ready"))
    if result != 0:
        return _error(ERR_INTERNAL, reply.get("error", "agent error"))
    if command == "DEL":
        return ("", 0)

    # translate agent reply → CNI result (contiv_cni.go:107-163)
    ips = []
    interfaces = []
    for i, iface in enumerate(reply.get("interfaces", [])):
        interfaces.append(
            {"name": iface["name"], "sandbox": iface.get("sandbox", "")}
        )
        for addr in iface.get("ip_addresses", []):
            ips.append(
                {
                    "version": "4" if addr.get("version", 4) == 4 else "6",
                    "address": addr["address"],
                    "gateway": addr.get("gateway", ""),
                    "interface": i,
                }
            )
    routes = [
        {"dst": r["dst"], "gw": r.get("gw", "")} for r in reply.get("routes", [])
    ]
    return (
        json.dumps(
            {
                "cniVersion": CNI_VERSION,
                "interfaces": interfaces,
                "ips": ips,
                "routes": routes,
            }
        ),
        0,
    )


def main() -> int:
    out, code = run(dict(os.environ), sys.stdin.buffer.read())
    if out:
        sys.stdout.write(out + "\n")
    return code


if __name__ == "__main__":
    sys.exit(main())
