"""vpp-tpu-torch-init: node bootstrap + supervisor (the contiv-init analog).

The port's copy of ``vpp_tpu/cmd/init_main.py``: it starts the port's
agent (``vpp_tpu_torch.cmd.agent``, the data plane on the card) and the
port's IO daemon (``vpp_tpu_torch.cmd.io_daemon``) on the agent's rings.
A ``mesh:`` section starts the port's mesh agent
(``vpp_tpu_torch.cmd.mesh_main``) and one IO daemon per mesh node, each
on its node's plan (``plan_path.<n>``). With ``mesh.coordinator`` set
it is one host's rank of a multi-host mesh: the mesh agent runs its
``--coordinator`` form and the supervisor waits for the plans of the
rows this host owns (the set of plan files stops growing).

Reference: cmd/contiv-init is PID 1 of the vswitch container
(main.go:201-273): parse the STN config, optionally steal the NIC,
start the data plane, pre-configure the uplink over the binary API
(vppcfg.go:74-559 — static IP or DHCP, default route, proxy ARP),
persist that pre-config to the store, then start and supervise the
agent.

This analog sequences the process pair of this framework:

  1. load the agent YAML config;
  2. optional STN steal of the uplink NIC (LinuxNetlink backend —
     addresses/routes recorded + flushed; the STN watchdog contract
     gives them back if we die);
  3. uplink bring-up: link up, static address or DHCP client, proxy-ARP
     sysctl (vppcfg.go's interface pre-configuration);
  4. persist the uplink pre-config to the kvstore (``init/<node>/…``,
     the persistVppConfig analog);
  5. start **vpp-tpu-torch-agent** (creates the shm rings + pump, writes the
     IO plan file);
  6. wait for the plan file, start **vpp-tpu-torch-io** with matching
     geometry + the control socket;
  7. supervise both with restart backoff; SIGTERM tears down in
     reverse order.

``InitSupervisor`` takes injectable process/netlink/store hooks so the
whole bootstrap is unit-testable without root or real processes.
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from vpp_tpu_torch.cmd.config import AgentConfig, load_config

log = logging.getLogger("vpp_tpu_torch.init")


def configure_uplink(cfg: AgentConfig, run=subprocess.run) -> dict:
    """Bring the uplink NIC up: static IP or DHCP + proxy ARP.
    Returns the applied pre-config (persisted to the store).
    Reference: vppcfg.go:74-559 (interface address, DHCP lease wait,
    proxy-ARP ranges)."""
    io = cfg.io
    name = io.uplink_interface
    applied = {"interface": name, "ip": "", "dhcp": False,
               "proxy_arp": False}
    if not name:
        return applied

    def sh(*args: str, timeout: float = 30.0):
        return run(list(args), capture_output=True, text=True,
                   timeout=timeout)

    sh("ip", "link", "set", name, "up")
    if io.uplink_ip:
        sh("ip", "addr", "replace", io.uplink_ip, "dev", name)
        applied["ip"] = io.uplink_ip
    elif io.uplink_dhcp:
        # reference waits for the DHCP lease before proceeding
        # (vppcfg.go DHCP handling); try the common clients
        client = shutil.which("dhclient") or shutil.which("udhcpc")
        if client is None:
            log.error("uplink_dhcp set but no DHCP client on this host")
        elif client.endswith("dhclient"):
            sh(client, "-1", name, timeout=60.0)
            applied["dhcp"] = True
        else:
            sh(client, "-i", name, "-n", "-q", timeout=60.0)
            applied["dhcp"] = True
    if io.proxy_arp:
        sh("sysctl", "-w", f"net.ipv4.conf.{name}.proxy_arp=1")
        applied["proxy_arp"] = True
    return applied


class InitSupervisor:
    """Start + babysit the agent and IO-daemon processes."""

    RESTART_BACKOFF_S = (1.0, 2.0, 5.0, 10.0)

    def __init__(
        self,
        config: AgentConfig,
        config_path: Optional[str],
        spawn: Callable[[List[str]], "subprocess.Popen"] = None,
        plan_timeout_s: float = 60.0,
    ):
        self.config = config
        self.config_path = config_path
        self.spawn = spawn or (lambda argv: subprocess.Popen(argv))
        self.plan_timeout_s = plan_timeout_s
        self.procs: Dict[str, "subprocess.Popen"] = {}
        self.restarts: Dict[str, int] = collections.defaultdict(int)
        self._stop = threading.Event()

    # --- child argv builders (also what the unit tests assert on) ---
    def _is_mesh(self) -> bool:
        m = self.config.mesh
        return bool(m.enabled or m.nodes or m.coordinator
                    or m.rule_shards > 1)

    def agent_argv(self) -> List[str]:
        # a mesh: section means the vswitch is the mesh agent: the same
        # supervision contract, one process driving every mesh node
        module = ("vpp_tpu_torch.cmd.mesh_main" if self._is_mesh()
                  else "vpp_tpu_torch.cmd.agent")
        argv = [sys.executable, "-m", module]
        if self.config_path:
            argv += ["--config", self.config_path]
        return argv

    def io_argv(self, plan: dict) -> List[str]:
        argv = [
            sys.executable, "-m", "vpp_tpu_torch.cmd.io_daemon",
            "--shm", plan["shm"],
            "--slots", str(plan["slots"]),
            "--snap", str(plan["snap"]),
            "--uplink", str(plan["uplink_if"]),
            "--vtep", str(plan["vtep"]),
            "--vni", str(plan["vni"]),
        ]
        if plan.get("host_if") is not None:
            argv += ["--host-if", str(plan["host_if"])]
        if plan.get("uplink_interface"):
            argv += ["--if",
                     f"{plan['uplink_if']}:afpacket:{plan['uplink_interface']}"]
        if plan.get("control_socket"):
            argv += ["--control", plan["control_socket"]]
        return argv

    def _plan_files(self) -> List[str]:
        """Plan files the running agent has written: ONE at plan_path
        for a standalone agent; plan_path.<node> per mesh node (the
        runtimes suffix per-node endpoints, parallel/runtime.py)."""
        import glob as _glob

        base = self.config.io.plan_path
        if not self._is_mesh():
            return [base] if os.path.exists(base) else []
        # ONLY digit suffixes are node plans (plan_path.<n>); anything
        # else — the agents' atomic-write temp files especially — must
        # not become a phantom io daemon sharing a live daemon's rings
        return sorted(p for p in _glob.glob(base + ".*")
                      if p[len(base) + 1:].isdigit())

    def read_plans(self) -> dict:
        """Wait for the agent's IO plan file(s); returns
        {proc_name: (path, plan)}. With a KNOWN node count
        (mesh.nodes > 0) we wait for exactly that many plans — a
        settle heuristic would commit to a partial set whenever node
        boots straggle (e.g. a host-interconnect wire wait between
        them), leaving later nodes without io daemons. Only the
        auto-size mode (nodes=0) falls back to waiting for the set to
        stop growing. Multi-host (mesh.coordinator set) also settles:
        mesh.nodes counts the WHOLE cluster's rows but this host's
        MultiHostRuntime writes plan_path.<n> only for the rows its rank
        owns — waiting for the global count would time out on every
        host and leave the deployment with no io daemons at all."""
        deadline = time.monotonic() + self.plan_timeout_s
        mesh = self.config.mesh
        if not self._is_mesh():
            want = 1
        elif mesh.coordinator:
            want = 0  # per-host row count is decided by the rank at
            #           runtime, not config — settle
        else:
            want = mesh.nodes
        seen: List[str] = []
        stable_since = 0.0
        while time.monotonic() < deadline and not self._stop.is_set():
            paths = self._plan_files()
            if paths and not self._is_mesh():
                with open(paths[0]) as f:
                    return {"io": (paths[0], json.load(f))}
            done = False
            if paths and want > 0:
                done = len(paths) >= want
            elif paths:
                if paths != seen:
                    seen = paths
                    stable_since = time.monotonic()
                else:
                    done = time.monotonic() - stable_since > 1.5
            if done:
                out = {}
                for p in paths:
                    with open(p) as f:
                        out[f"io:{p.rsplit('.', 1)[1]}"] = (
                            p, json.load(f))
                return out
            time.sleep(0.2)
        raise TimeoutError(
            f"agent never wrote IO plan at {self.config.io.plan_path}")

    def _clear_plan(self) -> None:
        """Remove any stale plan file(s) BEFORE (re)spawning the agent,
        so read_plans() waits for the plans of the agent actually
        running — a leftover from a previous boot would describe dead
        rings."""
        import glob as _glob

        base = self.config.io.plan_path
        for p in [base] + _glob.glob(base + ".*"):
            try:
                os.remove(p)
            except OSError:
                pass

    def _spawn_agent(self) -> None:
        self._clear_plan()
        self.procs["agent"] = self.spawn(self.agent_argv())

    def _io_names(self) -> List[str]:
        return [n for n in self.procs
                if n == "io" or n.startswith("io:")]

    def _spawn_io(self) -> bool:
        try:
            plans = self.read_plans()
        except TimeoutError:
            log.error("io start blocked: no plan file")
            return False
        self._io_plan_paths = {n: p for n, (p, _) in plans.items()}
        for name, (_, plan) in plans.items():
            self.procs[name] = self.spawn(self.io_argv(plan))
        return True

    def _respawn_one_io(self, name: str) -> None:
        """One io daemon died on its own: respawn it from ITS plan
        (still on disk — the agent only rewrites plans on restart).
        NEVER falls back to a full _spawn_io(): that would spawn
        duplicates of the still-healthy daemons onto live rings."""
        path = getattr(self, "_io_plan_paths", {}).get(name)
        if not path or not os.path.exists(path):
            # the supervisor loop retries with backoff; the plan
            # reappears after the next agent (re)boot
            log.error("no plan on disk for %s; will retry", name)
            return
        with open(path) as f:
            self.procs[name] = self.spawn(self.io_argv(json.load(f)))

    # --- lifecycle ---
    def start(self) -> None:
        self._spawn_agent()
        if self.config.io.enabled and self.config.io.plan_path:
            if not self._spawn_io():
                # first boot must fail loudly — the container supervisor
                # (k8s) restarts us; silently running without a data
                # plane would pass health checks while moving no packets
                raise TimeoutError(
                    f"agent never wrote IO plan at {self.config.io.plan_path}"
                )

    def supervise(self) -> None:
        """Restart children that die until stop() — the supervisord role
        in the reference's vswitch pod (supervisord.conf:18-22).

        An agent death restarts the IO daemon too: the replacement agent
        reclaims + recreates the shm rings, and an IO daemon still
        mapping the orphaned segment would pump disjoint memory — both
        processes healthy, zero packets moving."""
        while not self._stop.wait(0.5):
            for name, proc in list(self.procs.items()):
                if proc.poll() is None:
                    continue
                n = self.restarts[name]
                self.restarts[name] = n + 1
                delay = self.RESTART_BACKOFF_S[
                    min(n, len(self.RESTART_BACKOFF_S) - 1)
                ]
                log.error("%s exited rc=%s; restart #%d in %.1fs",
                          name, proc.returncode, n + 1, delay)
                if self._stop.wait(delay):
                    return
                if name == "agent":
                    for io_name in self._io_names():
                        io = self.procs.get(io_name)
                        if io is not None and io.poll() is None:
                            io.terminate()
                            try:
                                io.wait(timeout=10)
                            except subprocess.TimeoutExpired:
                                io.kill()
                    self._spawn_agent()
                    if self.config.io.enabled and self.config.io.plan_path:
                        self._spawn_io()
                elif self.procs.get(name) is proc:
                    # skip if the agent-restart path above already
                    # replaced this io process within this loop pass
                    self._respawn_one_io(name)

    def stop(self, term_timeout: float = 15.0) -> None:
        """Reverse-order teardown: IO daemon first (drains endpoints),
        then the agent (owns the rings)."""
        self._stop.set()
        for name in self._io_names() + ["agent"]:
            proc = self.procs.get(name)
            if proc is None or proc.poll() is not None:
                continue
            proc.terminate()
            try:
                proc.wait(timeout=term_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()


def persist_preconfig(cfg: AgentConfig, applied: dict) -> None:
    """persistVppConfig analog (vppcfg.go:312): record what bootstrap
    did to the uplink so operators/debuggers can see it in the store."""
    if not cfg.store_url:
        return
    from vpp_tpu_torch.kvstore.client import connect_store

    try:
        store = connect_store(cfg.store_url)
    except Exception:
        log.exception("pre-config persist skipped: store unreachable")
        return
    try:
        store.put(f"init/{cfg.node_name}/uplink", applied)
    finally:
        close = getattr(store, "close", None)
        if callable(close):
            close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vpp-tpu-torch-init")
    parser.add_argument("--config", default=None,
                        help="agent YAML (also passed to the agent)")
    parser.add_argument("--stn", action="store_true",
                        help="steal the uplink NIC before bring-up "
                             "(records + flushes kernel addressing)")
    parser.add_argument("--stn-persist", default="/run/vpp-tpu/stn.json")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfg = load_config(args.config)

    # 2. optional STN steal (reference main.go:66-119)
    if args.stn and cfg.io.uplink_interface:
        from vpp_tpu_torch.health.stn import STNDaemon
        from vpp_tpu_torch.health.stn_netlink import LinuxNetlink

        stn = STNDaemon(LinuxNetlink(), persist_path=args.stn_persist)
        info = stn.steal(cfg.io.uplink_interface)
        log.info("stole %s (%d addrs, %d routes recorded)",
                 info.name, len(info.ip_addresses), len(info.routes))

    # 3.+4. uplink bring-up + persist the pre-config
    applied = configure_uplink(cfg)
    persist_preconfig(cfg, applied)

    # 5.-7. start children, supervise, tear down on SIGTERM
    sup = InitSupervisor(cfg, args.config)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: sup.stop())
    sup.start()
    sup.supervise()
    sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
