"""vpp-tpu-torch-ctl: the vppctl analog — debug commands against a
RUNNING agent (the port's copy of ``vpp_tpu/cmd/ctl.py``).

The reference's operators live in `vppctl` (`show interface`, `show
acl`, `trace`, ... — docs/VPP_PACKET_TRACING_K8S.md); this client
speaks the agent's CLI socket (cmd/config.py `cli_socket`, served by
the agent's DebugCLI):

    vpp-tpu-torch-ctl show interface
    vpp-tpu-torch-ctl test connectivity 10.1.1.2 10.1.1.3 tcp 80
    vpp-tpu-torch-ctl                       # interactive REPL
"""

from __future__ import annotations

import argparse
import sys

from vpp_tpu_torch.cni.transport import cni_call


def run_line(socket_path: str, line: str, timeout: float) -> str:
    reply = cni_call(socket_path, "run", {"line": line}, timeout=timeout)
    if reply.get("result") != 0:
        raise RuntimeError(reply.get("error") or "command failed")
    return reply.get("output", "")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vpp-tpu-torch-ctl",
        description="debug CLI against a running vpp-tpu agent"
    )
    parser.add_argument("--socket", default="/run/vpp-tpu/cli.sock")
    parser.add_argument("--timeout", type=float, default=30.0)
    parser.add_argument("words", nargs="*",
                        help="command (omit for an interactive REPL)")
    args = parser.parse_args(argv)

    if args.words:
        try:
            print(run_line(args.socket, " ".join(args.words), args.timeout))
        except (OSError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        return 0

    # REPL
    while True:
        try:
            line = input("vpp-tpu# ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if line in ("quit", "exit"):
            return 0
        if not line:
            continue
        try:
            print(run_line(args.socket, line, args.timeout))
        except (OSError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
