"""Rank programs of a multi-host mesh, and their launcher.

The reference's multi-process scenarios (``tests/test_multihost.py``:
its workers ``tests/mh_*.py`` and their ``tests/mh_common.py``) as
scenarios of the port. A scenario is one rank of a ``torch.distributed``
process group (parallel/multihost.py, backend gloo) and prints one line
``VERDICT {json}``, which the caller holds to the reference's
assertions. Run a rank as

    python -m vpp_tpu_torch.testing.multihost [--device cpu|cuda] \\
        [--timeout S] SCENARIO RANK WORLD HOST:PORT [ARGS...]

(``HOST:PORT`` is the coordinator, served by rank 0; a rank runs on the
card unless ``--device`` names another device, and raises without one).
The scenarios:

* ``fabric`` (mh_worker): a 4-node cluster over the ranks, a global
  table on node 3, two steps: traffic and ACL drops across the process
  boundary, then the reply riding the session it installed.
* ``lockstep KV_PORT [NODE]`` (mh_lockstep_worker): the last rank stages
  a deny-all on node NODE (the reference's 2) and requests a commit
  through the store; both ranks publish on the same tick, the flow from
  node 0 is cut that tick; a stale stop counter does not halt the fleet,
  a fresh one stops it (``stop`` in the verdict).
* ``lockstep_failover STORE_URL`` (mh_lockstep_failover_worker): the
  same across a fenced store pair's failover.
* ``runtime KV_PORT`` (mh_runtime_worker): ``MultiHostRuntime`` with
  ContivAgents on each rank over a shared store: CNI adds, node events,
  fabric delivery, a renderer policy cut.
* ``wire KV_PORT`` (mh_wire_worker): the same with ``io.enabled``: wire
  frames through the rings, the tick-driven ``ClusterPump``.
* ``mxu`` (mh_mxu_worker): the fleet agrees on the MXU classifier at 640
  rules and its verdicts equal a dense-forced twin's.
* ``replay SPEC_DIR...``: per directory, a cluster staged by a named
  stager steps the spec's recorded vectors; each rank writes its rows of
  every result and the state planes (the differentials' ranks, and the
  card's in phase 4n).

``Ranks`` starts a run's processes (each with its own timeout), reaps
every one when one fails or the time is up, and raises on a nonzero
exit; ``run_ranks`` runs a scenario on a coordinator port the kernel
hands out. The tests and ``chip_smoke.py`` phase 4n run them.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import ipaddress
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
VERDICT = "VERDICT "


# --- the launcher ------------------------------------------------------------


def free_port() -> int:
    """A port the kernel hands out (bound, read, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankFailed(RuntimeError):
    """A rank exited nonzero, printed no verdict, or ran out of time."""


def child_env() -> dict:
    """The environment of a rank: this process's, with this checkout and
    its ``tests/`` (where a replay's stager may live) on ``PYTHONPATH``,
    and two CPU threads a rank unless set."""
    env = dict(os.environ)
    path = [str(ROOT), str(ROOT / "tests")] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(path)
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


class Ranks:
    """The processes of one multi-rank run, ``argvs`` one each, started
    from this checkout; their output goes to temporary files. ``wait``
    returns every (stdout, stderr) once all exited 0, and raises
    ``RankFailed`` as soon as one exits nonzero or ``timeout`` passes;
    either way every process still alive is killed and reaped (the
    output files go with the object)."""

    def __init__(self, argvs: Sequence[Sequence[str]]):
        self.procs: List[subprocess.Popen] = []
        self.files = []
        env = child_env()
        try:
            for argv in argvs:
                out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
                self.files.append((out, err))
                self.procs.append(subprocess.Popen(
                    list(argv), stdout=out, stderr=err, env=env,
                    cwd=str(ROOT)))
        except BaseException:
            self.kill()
            raise

    def output(self, i: int):
        """Rank ``i``'s (stdout, stderr) so far."""
        return self._read(i)

    def _read(self, i: int):
        out = []
        for f in self.files[i]:
            f.seek(0)
            out.append(f.read().decode(errors="replace"))
        return tuple(out)

    def wait(self, timeout: float):
        deadline = time.monotonic() + timeout
        try:
            while True:
                rcs = [p.poll() for p in self.procs]
                bad = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
                if bad:
                    # the first to fail names the fault; its peers then
                    # fail inside their collectives
                    first = min(bad, key=lambda i: self.procs[i].returncode
                                is None)
                    raise RankFailed(
                        f"rank {first} exited {rcs[first]}: "
                        f"{self._read(first)[1][-3000:]}")
                if all(rc == 0 for rc in rcs):
                    return [self._read(i) for i in range(len(self.procs))]
                if time.monotonic() > deadline:
                    raise RankFailed(
                        f"ranks still running after {timeout:.0f} s "
                        f"(exit codes {rcs}): " + " | ".join(
                            self._read(i)[1][-1500:]
                            for i in range(len(self.procs))))
                time.sleep(0.05)
        finally:
            self.kill()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


def verdict_of(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith(VERDICT)]
    if not lines:
        raise RankFailed(f"a rank printed no verdict: {stdout[-1500:]}")
    return json.loads(lines[-1][len(VERDICT):])


def write_spec(spec_dir, spec: dict, inputs: dict) -> Path:
    """A replay spec: ``spec.json`` and the recorded ``inputs.npz``."""
    d = Path(spec_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "spec.json").write_text(json.dumps(spec))
    np.savez(d / "inputs.npz", **inputs)
    return d


def replay_rows(spec_dir, rank: int) -> dict:
    """What rank ``rank`` of a replay wrote: ``<step>.<field>`` ->
    its rows."""
    with np.load(Path(spec_dir) / f"out.{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def rank_argv(scenario: str, rank: int, world: int, coordinator: str,
              args: Sequence = (), device: Optional[str] = None,
              group_timeout: float = 120.0) -> List[str]:
    """One rank's command line. ``device`` None leaves the rank on the
    card (it raises without one)."""
    # the options first: the positionals then form one block, which
    # every argparse reads alike
    dev = [] if device is None else ["--device", str(device)]
    return [sys.executable, "-m", "vpp_tpu_torch.testing.multihost",
            *dev, "--timeout", str(group_timeout), scenario,
            str(rank), str(world), coordinator, *map(str, args)]


def start_ranks(scenario: str, world: int = 2, args: Sequence = (),
                device: Optional[str] = None,
                group_timeout: float = 120.0) -> Ranks:
    coordinator = f"127.0.0.1:{free_port()}"
    return Ranks([rank_argv(scenario, r, world, coordinator, args, device,
                            group_timeout) for r in range(world)])


def run_ranks(scenario: str, world: int = 2, args: Sequence = (),
              device: Optional[str] = None, timeout: float = 240.0,
              group_timeout: float = 120.0) -> List[dict]:
    """Run ``scenario`` on ``world`` ranks; their verdicts, rank order."""
    ranks = start_ranks(scenario, world, args, device, group_timeout)
    return [verdict_of(out) for out, _ in ranks.wait(timeout)]


@contextlib.contextmanager
def store_process(tmp_dir, module: str = "vpp_tpu_torch.cmd.kvserver",
                  args: Sequence = (), name: str = "kv"):
    """A KV server (or witness: ``module``) as its own process on a port
    the kernel hands out, its port file under ``tmp_dir``; yields (the
    process, its port) and kills it on exit."""
    pf = Path(tmp_dir) / f"{name}.port"
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--host", "127.0.0.1", "--port", "0",
         "--port-file", str(pf), *map(str, args)],
        env=child_env(), cwd=str(ROOT))
    try:
        deadline = time.monotonic() + 60
        while not pf.exists() or not pf.read_text().strip():
            if proc.poll() is not None:
                raise RankFailed(f"{module} exited {proc.returncode} at "
                                 "startup")
            if time.monotonic() > deadline:
                raise RankFailed(f"{module} never wrote its port")
            time.sleep(0.1)
        yield proc, int(pf.read_text())
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


# --- shared scaffolding (the reference's tests/mh_common.py) ---------------


def stage_full_mesh(cluster):
    """Uplink + one pod + full-mesh fabric routes on every LOCAL node;
    returns {nid: pod_if}. Pod addressing is the deterministic IPAM
    arithmetic, so every process can recompute any pod's IP."""
    from vpp_tpu_torch.ipam import IPAM
    from vpp_tpu_torch.pipeline.vector import Disposition

    pod_if = {}
    for nid in cluster.local_nodes:
        node = cluster.node(nid)
        uplink = node.add_uplink()
        ipam = IPAM(nid + 1)
        ip = ipam.next_pod_ip(f"ns/pod{nid}")
        pod_if[nid] = node.add_pod_interface(f"ns/pod{nid}")
        node.builder.add_route(f"{ip}/32", pod_if[nid], Disposition.LOCAL)
        for other in range(cluster.n_nodes):
            if other != nid:
                node.builder.add_route(
                    str(ipam.other_node_pod_network(other + 1)),
                    uplink, Disposition.REMOTE, node_id=other)
    return pod_if


def pod_ips(n_nodes):
    from vpp_tpu_torch.ipam import IPAM

    return {n: str(IPAM(n + 1).next_pod_ip(f"ns/pod{n}"))
            for n in range(n_nodes)}


LOCKSTEP_N_NODES = 4


def lockstep_config():
    """The DataplaneConfig both lockstep scenarios build their 4-node
    cluster with (one literal for the baseline and the failover)."""
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig

    return DataplaneConfig(
        max_tables=4, max_rules=16, max_global_rules=32, max_ifaces=8,
        fib_slots=32, sess_slots=256, nat_mappings=4, nat_backends=16)


def _row_of(cluster, node: int):
    """(the rank that owns mesh row ``node``, its local row there)."""
    n_local = len(cluster.local_nodes)
    return node // n_local, node % n_local


def lockstep_frames(cluster, all_pod_ip, pod_if, sport, target: int = 2):
    """pod0 (rank 0) -> the pod of node ``target``; a fresh sport each
    tick so no tick rides the previous tick's reflective session."""
    f = [[] for _ in cluster.local_nodes]
    if 0 in cluster.local_nodes:
        f[0] = [dict(src=all_pod_ip[0], dst=all_pod_ip[target], proto=6,
                     sport=sport, dport=8080, rx_if=pod_if[0])]
    return f


def lockstep_deliveries(cluster, res, target: int = 2):
    """Delivered count on node ``target``'s row; -1 on the ranks that
    don't own it."""
    if target not in cluster.local_nodes:
        return -1
    from vpp_tpu_torch.pipeline.vector import Disposition

    disp = cluster.local_rows(res.delivered.disp)
    return int((disp[_row_of(cluster, target)[1]]
                == int(Disposition.LOCAL)).sum())


def udp_frame(src: str, dst: str, sport: int, dport: int,
              payload: bytes) -> bytes:
    """Ethernet + IPv4 + UDP with valid IPv4 and UDP checksums."""
    eth = b"\x02\x00\x00\x00\x00\x02\x02\x00\x00\x00\x00\x01\x08\x00"
    l4 = struct.pack("!HHHH", sport, dport, 8 + len(payload), 0) + payload
    src_b = ipaddress.ip_address(src).packed
    dst_b = ipaddress.ip_address(dst).packed
    hdr = struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(l4), 1, 0x4000, 64,
                      17, 0, src_b, dst_b)
    hdr = hdr[:10] + struct.pack("!H", ~_sum16(hdr) & 0xFFFF) + hdr[12:]
    pseudo = src_b + dst_b + struct.pack("!BBH", 0, 17, len(l4))
    ck = (~_sum16(pseudo + l4 + b"\x00" * (len(l4) % 2)) & 0xFFFF) or 0xFFFF
    return eth + hdr + l4[:6] + struct.pack("!H", ck) + l4[8:]


def _sum16(data: bytes) -> int:
    s = sum(struct.unpack(f"!{len(data) // 2}H", data))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return s


def wait_for(pred, what: str, deadline_s: float = 60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise TimeoutError(f"waiting for {what}")


def add_pod(agent, cid: str, name: str) -> str:
    from vpp_tpu_torch.cni.model import CNIRequest

    reply = agent.cni_server.add(CNIRequest(
        container_id=cid,
        extra_args={"K8S_POD_NAME": name, "K8S_POD_NAMESPACE": "default"}))
    assert reply.result == 0, reply
    return reply.interfaces[0].ip_addresses[0].address.split("/")[0]


def load_stager(name: str):
    """``module:function``: the stager a replay spec names."""
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


# --- the scenarios ------------------------------------------------------------


class Ctx:
    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, device


def scenario_fabric(ctx: Ctx, args) -> dict:
    """The reference's mh_worker: the fabric across the processes."""
    from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol
    from vpp_tpu_torch.parallel.multihost import MultiHostCluster, barrier
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig
    from vpp_tpu_torch.pipeline.vector import Disposition

    n_nodes = 4
    cfg = DataplaneConfig(
        max_tables=4, max_rules=16, max_global_rules=32, max_ifaces=8,
        fib_slots=32, sess_slots=256, nat_mappings=4, nat_backends=16)
    cluster = MultiHostCluster(n_nodes, cfg, device=ctx.device)
    pod_if = stage_full_mesh(cluster)
    # node 3 carries a deny-all-but-TCP/80 global table: fabric traffic
    # enters through its uplink and must be filtered
    if 3 in cluster.local_nodes:
        cluster.node(3).builder.set_global_table([
            ContivRule(action=Action.PERMIT, protocol=Protocol.TCP,
                       dest_port=80),
            ContivRule(action=Action.DENY)])
    barrier("staged")
    cluster.publish()
    ip = pod_ips(n_nodes)
    frames = [[] for _ in cluster.local_nodes]
    if 0 in cluster.local_nodes:
        frames[0] = [dict(src=ip[0], dst=ip[2], proto=6, sport=1000,
                          dport=8080, rx_if=pod_if[0])]
        frames[1] = [
            dict(src=ip[1], dst=ip[3], proto=6, sport=1001, dport=80,
                 rx_if=pod_if[1]),
            dict(src=ip[1], dst=ip[3], proto=6, sport=1002, dport=22,
                 rx_if=pod_if[1])]
    res = cluster.step(cluster.make_frames(frames, n=8), now=1)
    deliv_disp = cluster.local_rows(res.delivered.disp)
    deliv_dst = cluster.local_rows(res.delivered.pkts.dst_ip)
    deliv_txif = cluster.local_rows(res.delivered.tx_if)
    drop_acl = cluster.local_rows(res.stats.drop_acl)
    verdict = {"proc": ctx.rank, "local_nodes": cluster.local_nodes}
    local = int(Disposition.LOCAL)
    if 2 in cluster.local_nodes:
        # row 0 = node 2, row 1 = node 3 (this rank's rows)
        n2 = np.nonzero(deliv_disp[0] == local)[0]
        n3 = np.nonzero(deliv_disp[1] == local)[0]
        verdict.update(
            pod2_delivered=len(n2),
            pod2_txif_ok=bool((deliv_txif[0][n2] == pod_if[2]).all()),
            pod2_dst_ok=bool((deliv_dst[0][n2].astype(np.uint32)
                              == int(ipaddress.ip_address(ip[2]))).all()),
            pod3_delivered=len(n3),
            node3_acl_drops=int(drop_acl[1]))
    else:
        local_disp = cluster.local_rows(res.local.disp)
        remote = int(Disposition.REMOTE)
        verdict.update(sent_remote=int((local_disp[0][:1] == remote).sum()
                                       + (local_disp[1][:2] == remote).sum()))
    # step 2: the reply pod2 -> pod0 rides the session installed at
    # delivery: sessions persist in the tables across collective steps
    frames2 = [[] for _ in cluster.local_nodes]
    if 2 in cluster.local_nodes:
        frames2[0] = [dict(src=ip[2], dst=ip[0], proto=6, sport=8080,
                           dport=1000, rx_if=pod_if[2])]
    res2 = cluster.step(cluster.make_frames(frames2, n=8), now=2)
    if 0 in cluster.local_nodes:
        d = cluster.local_rows(res2.delivered.disp)
        verdict["reply_delivered"] = int((d[0] == local).sum())
    barrier("done")
    return verdict


def _lockstep(ctx: Ctx, store, target: int, failover_wait=None):
    """The lockstep scenarios' body: tick, (failover), commit, tick."""
    from vpp_tpu_torch.ir.rule import Action, ContivRule
    from vpp_tpu_torch.parallel.multihost import (LockstepDriver,
                                                  MultiHostCluster, barrier)

    cluster = MultiHostCluster(LOCKSTEP_N_NODES, lockstep_config(),
                               device=ctx.device)
    # expire_every=3: tick 3 runs the aging pass too
    driver = LockstepDriver(cluster, store, expire_every=3)
    pod_if = stage_full_mesh(cluster)
    barrier("staged")
    cluster.publish()
    ip = pod_ips(LOCKSTEP_N_NODES)
    last = ctx.world - 1

    def tick(sport):
        return driver.tick(lockstep_frames(cluster, ip, pod_if, sport,
                                           target), n=8)

    verdict = {"proc": ctx.rank}
    res = tick(1000)
    verdict["t1_delivered"] = lockstep_deliveries(cluster, res, target)
    k = 2
    if failover_wait is not None:
        failover_wait()
        barrier("failover-done")
        # the cluster keeps forwarding on the failed-over store
        res = tick(1001)
        verdict["t2_delivered"] = lockstep_deliveries(cluster, res, target)
        k = 3
    # the last rank stages a deny-all on node ``target`` (its own row)
    # and asks the fleet to commit
    if ctx.rank == last:
        cluster.node(target).builder.set_global_table(
            [ContivRule(action=Action.DENY)])
        driver.request_commit()
    barrier("change-requested")   # every rank sees the request
    res = tick(1000 + k)
    verdict[f"t{k}_delivered"] = lockstep_deliveries(cluster, res, target)
    verdict[f"t{k}_epoch"] = cluster.epoch
    if target in cluster.local_nodes:
        verdict[f"t{k}_acl_drops"] = int(cluster.local_rows(
            res.stats.drop_acl)[_row_of(cluster, target)[1]])
    if failover_wait is None:
        res = tick(1000 + k + 1)
        verdict[f"t{k + 1}_delivered"] = lockstep_deliveries(cluster, res,
                                                             target)
    verdict["applied"] = driver.applied
    verdict["ticks"] = driver.ticks
    return verdict, driver


def scenario_lockstep(ctx: Ctx, args) -> dict:
    """The reference's mh_lockstep_worker (argv: KV_PORT [NODE]), then
    the stop protocol: the store still holds the stop counter of this
    fleet's previous run (bumped by the last rank before its driver was
    built, so the baseline agreement absorbs it) — it does not halt the
    ticks; a fresh request_stop halts every rank on the same tick."""
    from vpp_tpu_torch.kvstore.client import connect_store
    from vpp_tpu_torch.parallel.multihost import barrier

    store = connect_store(f"tcp://127.0.0.1:{args[0]}")
    target = int(args[1]) if len(args) > 1 else 2
    if ctx.rank == ctx.world - 1:
        store.put("/mesh/epoch/stop_req",
                  int(store.get("/mesh/epoch/stop_req") or 0) + 5)
    barrier("stale-stop")
    verdict, driver = _lockstep(ctx, store, target)
    barrier("ticked")
    if ctx.rank == 0:
        driver.request_stop()
    barrier("stop-requested")
    out = driver.tick_fabric(lambda t: "stepped", has_work=True)
    verdict["stop"] = out is driver._STOPPED
    verdict["stop_base"] = driver._stop_base
    barrier("done")
    store.close()
    return verdict


def scenario_lockstep_failover(ctx: Ctx, args) -> dict:
    """The reference's mh_lockstep_failover_worker (argv: STORE_URL): the
    caller kills the store's primary once both ranks wrote
    ``mhf/ready/<rank>`` and writes ``mhf/go`` on the new primary."""
    from vpp_tpu_torch.kvstore.client import connect_store

    # generous timeouts: a get / put issued INSIDE the failover window
    # must ride the endpoint rotation and the promotion within one call
    store = connect_store(args[0], request_timeout=90.0,
                          reconnect_timeout=90.0)

    def failover_wait():
        store.put(f"mhf/ready/{ctx.rank}", 1)
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            try:
                if store.get("mhf/go") == 1:
                    return
            except Exception:  # noqa: BLE001 — mid-failover transient
                pass
            time.sleep(0.5)
        raise SystemExit("the caller never signalled go")

    verdict, _ = _lockstep(ctx, store, 2, failover_wait)
    # the client's fencing epoch refreshes on its first WRITE against the
    # new primary: write once so the verdict shows this rank's writes
    # ride the post-failover history
    store.put(f"mhf/done/{ctx.rank}", 1)
    verdict["fence_epoch"] = store.fencing_epoch
    from vpp_tpu_torch.parallel.multihost import barrier

    barrier("done")
    store.close()
    return verdict


def scenario_runtime(ctx: Ctx, args) -> dict:
    """The reference's mh_runtime_worker (argv: KV_PORT)."""
    from vpp_tpu_torch.cmd import AgentConfig
    from vpp_tpu_torch.parallel.multihost import MultiHostRuntime
    from vpp_tpu_torch.pipeline.vector import Disposition

    class Collector:
        """Per-tick accumulation of this rank's delivered / drop
        counters (the tick thread calls it)."""

        def __init__(self):
            self.lock = threading.Lock()
            self.delivered_dst = {}
            self.drop_acl = 0
            self.runtime = None

        def __call__(self, res):
            rt = self.runtime
            disp = rt.cluster.local_rows(res.delivered.disp)
            dst = rt.cluster.local_rows(res.delivered.pkts.dst_ip)
            acl = rt.cluster.local_rows(res.stats.drop_acl)
            local = disp == int(Disposition.LOCAL)
            with self.lock:
                for d in dst[local].astype(np.uint32):
                    self.delivered_dst[int(d)] = \
                        self.delivered_dst.get(int(d), 0) + 1
                self.drop_acl += int(acl.sum())

        def count_for(self, ip: str) -> int:
            with self.lock:
                return self.delivered_dst.get(
                    int(ipaddress.ip_address(ip)), 0)

    collector = Collector()
    cfg = AgentConfig(node_name="mh", serve_http=False,
                      store_url=f"tcp://127.0.0.1:{args[0]}",
                      node_liveness_ttl_s=120.0)
    runtime = MultiHostRuntime(4, cfg, tick_interval=0.02, frame_n=8,
                               on_result=collector, device=ctx.device)
    collector.runtime = runtime
    store = runtime.store
    runtime.start()
    try:
        verdict = _runtime_body(ctx, runtime, store, collector)
    finally:
        runtime.close()
    if runtime.failed is not None:
        raise runtime.failed
    return verdict


def _runtime_body(ctx, runtime, store, collector):
    from vpp_tpu_torch.ir.rule import Action, ContivRule

    verdict = {"proc": ctx.rank, "local_nodes": runtime.cluster.local_nodes}
    my_agent = runtime.agents[0]
    pod_name = f"pod{runtime.cluster.local_nodes[0]}"
    my_ip = add_pod(my_agent, f"cid-{pod_name}", pod_name)
    store.put(f"/test/{pod_name}_ip", my_ip)
    wait_for(lambda: store.get("/test/pod0_ip"), "pod0 ip")
    ip2 = wait_for(lambda: store.get("/test/pod2_ip"), "pod2 ip")
    # both ranks' commits (CNI adds + node-event routes) applied
    # fleet-wide, then a few more ticks
    wait_for(lambda: runtime.driver.applied >= 1, "first epoch")
    base_ticks = runtime.driver.ticks
    wait_for(lambda: runtime.driver.ticks > base_ticks + 5, "tick settle")
    if ctx.rank == 0:
        pod_if0 = my_agent.dataplane.pod_if[("default", "pod0")]

        def send(sport, dport=80):
            runtime.inject(runtime.cluster.local_nodes[0], [dict(
                src=my_ip, dst=ip2, proto=6, sport=sport, dport=dport,
                rx_if=pod_if0)])

        # stage 1: flowing (retry injection: the peer's node-event
        # routes race the first packets)
        def delivered():
            send(2000 + runtime.driver.ticks % 500)
            time.sleep(0.1)
            return int(store.get("/test/stage1_count") or 0) > 0

        wait_for(delivered, "stage-1 delivery", 120)
        verdict["stage1_ok"] = True
        wait_for(lambda: store.get("/test/stage2_ready"), "policy commit")
        start_ticks = runtime.driver.ticks
        for i in range(30):
            send(3000 + i)
            time.sleep(0.05)
        wait_for(lambda: runtime.driver.ticks > start_ticks + 10,
                 "stage-2 ticks")
        store.put("/test/stage2_sent", True)
        # the peer still needs live ticks to evaluate stage 2
        wait_for(lambda: store.get("/test/p1_done"), "peer verdict", 120)
    else:
        def got_one():
            n = collector.count_for(my_ip)
            if n:
                store.put("/test/stage1_count", n)
            return n

        wait_for(got_one, "stage-1 delivery at pod2", 120)
        verdict["stage1_delivered"] = collector.count_for(my_ip)
        # a deny-all for pod2 on ITS node handle (the policy path:
        # renderer txn -> commit -> epoch)
        from vpp_tpu_torch.renderer.tpu import TpuRenderer

        renderer = TpuRenderer(my_agent.dataplane)
        txn = renderer.new_txn()
        txn.render(("default", "pod2"), ipaddress.ip_network(f"{my_ip}/32"),
                   ingress=[], egress=[ContivRule(action=Action.DENY)])
        txn.commit()
        # the commit request this commit made (or a later one): the tick
        # thread may publish it before this thread reads anything back
        req = int(store.get(runtime.driver.req_key) or 0)
        wait_for(lambda: runtime.driver.applied >= req,
                 "policy epoch applied")
        pre_count = collector.count_for(my_ip)
        pre_drops = collector.drop_acl
        store.put("/test/stage2_ready", True)
        wait_for(lambda: store.get("/test/stage2_sent"), "stage-2 sent", 120)
        base_ticks = runtime.driver.ticks
        wait_for(lambda: runtime.driver.ticks > base_ticks + 5,
                 "stage-2 settle")
        verdict["stage2_new_deliveries"] = \
            collector.count_for(my_ip) - pre_count
        verdict["stage2_acl_drops"] = collector.drop_acl - pre_drops
        from vpp_tpu_torch.cli import DebugCLI

        verdict["show_mesh"] = DebugCLI(
            my_agent.dataplane, mesh_runtime=runtime).run("show mesh")
        store.put("/test/p1_done", True)
    return verdict


def scenario_wire(ctx: Ctx, args) -> dict:
    """The reference's mh_wire_worker (argv: KV_PORT)."""
    from vpp_tpu_torch.cmd import AgentConfig
    from vpp_tpu_torch.cmd.config import IOConfig
    from vpp_tpu_torch.parallel.multihost import MultiHostRuntime

    cfg = AgentConfig(node_name="mhw", serve_http=False,
                      store_url=f"tcp://127.0.0.1:{args[0]}",
                      node_liveness_ttl_s=120.0,
                      io=IOConfig(enabled=True, n_slots=16, snap=256))
    runtime = MultiHostRuntime(4, cfg, tick_interval=0.02,
                               device=ctx.device)
    runtime.start()
    try:
        verdict = _wire_body(ctx, runtime, runtime.store)
    finally:
        runtime.close()
    if runtime.failed is not None:
        raise runtime.failed
    return verdict


def _wire_body(ctx, runtime, store):
    from vpp_tpu_torch.native.pktio import PacketCodec
    from vpp_tpu_torch.pipeline.vector import Disposition

    snap = 256
    verdict = {"proc": ctx.rank, "local_nodes": runtime.cluster.local_nodes}
    my_agent = runtime.agents[0]
    pod_name = f"pod{runtime.cluster.local_nodes[0]}"
    my_ip = add_pod(my_agent, f"cid-{pod_name}", pod_name)
    store.put(f"/test/{pod_name}_ip", my_ip)
    ip0 = wait_for(lambda: store.get("/test/pod0_ip"), "pod0 ip")
    ip2 = wait_for(lambda: store.get("/test/pod2_ip"), "pod2 ip")
    wait_for(lambda: runtime.driver.applied >= 1, "first epoch")
    codec = PacketCodec(snap=snap)

    def push_wire(sport):
        """One UDP wire frame pod0 -> pod2 into node 0's rx ring."""
        scratch = np.zeros((snap, snap), np.uint8)
        lens = np.zeros(snap, np.uint32)
        f = udp_frame(ip0, ip2, sport, 5000, b"vppt" + b"x" * 28)
        scratch[0, :len(f)] = np.frombuffer(f, np.uint8)
        lens[0] = len(f)
        if_a = my_agent.dataplane.pod_if[("default", "pod0")]
        cols, k = codec.parse_inplace(scratch, lens, 1, if_a)
        assert runtime.ring_pairs[0].rx.push(cols, k, payload=scratch)

    def drain_tx_count(ip_dst):
        """Pop node 2's tx ring; count the frames delivered to ip_dst
        with their UDP payload bytes intact."""
        want = int(ipaddress.ip_address(ip_dst))
        got = 0
        while True:
            fr = runtime.ring_pairs[0].tx.peek()
            if fr is None:
                return got
            for s_ in range(fr.n):
                if (int(fr.cols["dst_ip"][s_]) == want
                        and fr.cols["disp"][s_] == int(Disposition.LOCAL)
                        and fr.cols["proto"][s_] == 17):
                    assert bytes(fr.payload[s_, 42:46]) == b"vppt", \
                        bytes(fr.payload[s_, 40:60])
                    got += 1
            runtime.ring_pairs[0].tx.release()

    if ctx.rank == 0:
        seq = iter(range(20000, 29000))

        def delivered():
            # a unique sport per push: a repeated 5-tuple would install a
            # session that (correctly) outlives the later policy
            push_wire(next(seq))
            time.sleep(0.1)
            return int(store.get("/test/wire1_count") or 0) > 0

        wait_for(delivered, "wire delivery", 120)
        verdict["stage1_ok"] = True
        # let the retry loop's backlog flush (one frame a ring a tick)
        base = runtime.driver.ticks
        wait_for(lambda: runtime.driver.ticks > base + 24, "backlog drain")
        # a fleet-idle window: ticks advance WITHOUT device steps
        s0 = runtime.cluster_pump.stats["steps"]
        t0 = runtime.driver.ticks
        wait_for(lambda: runtime.driver.ticks > t0 + 8, "idle ticks")
        verdict["idle_steps_flat"] = runtime.cluster_pump.stats["steps"] == s0
        store.put("/test/stage1_drained", True)
        sport = iter(range(30000, 60000))
        acked = 0
        deadline = time.monotonic() + 150
        while time.monotonic() < deadline:
            if store.get("/test/p1_done"):
                break
            req = int(store.get("/test/wave_req") or 0)
            if req > acked:
                base = runtime.driver.ticks
                for _ in range(4):
                    push_wire(next(sport))
                wait_for(lambda: runtime.driver.ticks > base + 5,
                         "wave ticks", 60)
                acked = req
                store.put("/test/wave_ack", acked)
            else:
                time.sleep(0.1)
    else:
        total = [0]

        def got_wire():
            total[0] += drain_tx_count(my_ip)
            if total[0]:
                store.put("/test/wire1_count", total[0])
            return total[0]

        wait_for(got_wire, "wire delivery at pod2", 120)
        verdict["wire_delivered"] = total[0]
        wait_for(lambda: store.get("/test/stage1_drained"),
                 "sender backlog drained", 120)
        # isolate pod2 through the agent's policy machinery: a KSR Pod
        # and an ingress NetworkPolicy with no rules written to the
        # shared store, as contiv-ksr would
        from vpp_tpu_torch.cmd.ksr_main import KsrAgent
        from vpp_tpu_torch.ksr import model as m

        steps_before_commit = runtime.cluster_pump.stats["steps"]
        # read before the objects go in: the agents may render and the
        # fleet publish before this thread reads anything back
        applied0 = runtime.driver.applied
        ksr = KsrAgent(store=store, serve_http=False)
        ksr.start()
        try:
            ksr.sources[m.Pod.TYPE].add("default/pod2", m.Pod(
                name="pod2", namespace="default", labels={"app": "pod2"},
                ip_address=my_ip))
            ksr.sources[m.Policy.TYPE].add("default/iso", m.Policy(
                name="iso", namespace="default",
                pods=m.LabelSelector(match_labels={"app": "pod2"}),
                policy_type=m.POLICY_INGRESS, ingress_rules=[]))
            # a commit tick must STEP even on an idle fleet
            wait_for(lambda: runtime.driver.applied > applied0,
                     "policy epoch applied", 120)
            wait_for(lambda: runtime.cluster_pump.stats["steps"]
                     > steps_before_commit, "commit-tick step", 60)
            verdict["commit_stepped"] = True
            # converge: waves of fresh-sport frames until one FULL wave
            # yields no delivery
            cut = False
            deadline = time.monotonic() + 120
            wave = 0
            while time.monotonic() < deadline and not cut:
                drain_tx_count(my_ip)      # discard anything in flight
                wave += 1
                store.put("/test/wave_req", wave)
                wait_for(lambda: int(store.get("/test/wave_ack") or 0)
                         >= wave, f"wave {wave} ack", 60)
                base = runtime.driver.ticks
                wait_for(lambda: runtime.driver.ticks > base + 6,
                         "wave settle", 60)
                cut = drain_tx_count(my_ip) == 0
            verdict["stage2_cut"] = cut
        finally:
            ksr.close()
        store.put("/test/p1_done", True)
    return verdict


def scenario_mxu(ctx: Ctx, args) -> dict:
    """The reference's mh_mxu_worker over the ranks: at 640 bit-plane-
    compatible global rules publish() agrees on the MXU classifier, and
    its verdicts equal a dense-forced twin's on the same frames (each
    rank holds its rows of both)."""
    from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol
    from vpp_tpu_torch.parallel.multihost import MultiHostCluster
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig
    from vpp_tpu_torch.pipeline.vector import Disposition

    n_rules = 640
    rules = []
    for i in range(n_rules - 1):
        net = ipaddress.ip_network(
            f"172.{16 + (i % 1000) // 256}.{(i % 1000) % 256}.0/24")
        rules.append(ContivRule(
            action=Action.DENY if i % 6 == 5 else Action.PERMIT,
            src_network=net, protocol=Protocol.TCP,
            dest_port=8000 + i % 20))
    rules.append(ContivRule(action=Action.DENY))
    cfg = DataplaneConfig(
        max_tables=4, max_rules=16, max_global_rules=n_rules, max_ifaces=8,
        fib_slots=32, sess_slots=256, nat_mappings=4, nat_backends=16)

    def build(force_dense: bool) -> MultiHostCluster:
        cl = MultiHostCluster(2, cfg, device=ctx.device)
        if force_dense:
            cl.mxu_threshold = 1 << 30
        for nid in cl.local_nodes:
            n = cl.node(nid)
            up = n.add_uplink()
            pi = n.add_pod_interface(("d", f"p{nid}"))
            n.builder.add_route(f"10.{nid + 1}.0.2/32", pi, Disposition.LOCAL)
            other = 1 - nid
            n.builder.add_route(f"10.{other + 1}.0.0/24", up,
                                Disposition.REMOTE, node_id=other)
            n.builder.set_global_table(list(rules))
        cl.publish()
        return cl

    def frames(cl):
        rng = np.random.default_rng(3)
        pkts = []
        for k in range(32):
            blk = int(rng.integers(0, 1000))
            pkts.append(dict(
                src=f"172.{16 + blk // 256}.{blk % 256}.{1 + k % 250}",
                dst="10.2.0.2", proto=6, sport=1000 + k,
                dport=8000 + int(rng.integers(0, 20))))
        if 0 not in cl.local_nodes:
            return cl.make_frames([[] for _ in cl.local_nodes], n=64)
        rx_if = cl.node(0).pod_if[("d", "p0")]
        return cl.make_frames([[dict(p, rx_if=rx_if) for p in pkts]]
                              + [[]] * (len(cl.local_nodes) - 1), n=64)

    mxu = build(force_dense=False)
    dense = build(force_dense=True)
    r_m = mxu.step(frames(mxu), now=1)
    r_d = dense.step(frames(dense), now=1)
    same = all(np.array_equal(mxu.local_rows(getattr(r_m, side).disp),
                              dense.local_rows(getattr(r_d, side).disp))
               for side in ("local", "delivered"))
    return {"proc": ctx.rank, "mxu_selected": bool(mxu._use_mxu),
            "dense_selected": not dense._use_mxu,
            "verdicts_equal": bool(same),
            "drop_acl": int(mxu.local_rows(r_m.stats.drop_acl).sum()),
            "delivered": int((mxu.local_rows(r_m.delivered.disp)
                              == int(Disposition.LOCAL)).sum())}


def scenario_replay(ctx: Ctx, args) -> dict:
    """Every spec directory of ``args`` in turn (``replay_one``); the
    verdict holds each one's under its directory's name."""
    return {"proc": ctx.rank,
            "cases": {Path(d).name: replay_one(ctx, d) for d in args}}


def replay_one(ctx: Ctx, spec_dir) -> dict:
    """The spec of ``spec_dir`` (``spec.json``, ``inputs.npz``): a cluster
    of ``n_nodes`` x ``rule_shards`` over the ranks, its rows staged by
    ``stager`` (``module:function``, called ``stager(node, row,
    n_nodes, **stage_args)``), published, steps every recorded input
    (``cols.<k>``: the ``[N, 9, P]`` columns of step k, ``payload.<k>``
    its bytes for a wire step) and writes its rows of every result
    field and of ``state_fields`` after each step to ``out.<rank>.npz``;
    then times the ``timing`` cells (this rank's view). The verdict:
    the selection, the kernels' launches over the recorded steps, the
    timings, the exchange's host costs."""
    import torch

    from vpp_tpu_torch.interop import (cluster_result_to_numpy,
                                       cluster_tables_to_numpy)
    from vpp_tpu_torch.parallel.multihost import MultiHostCluster, barrier
    from vpp_tpu_torch.pipeline import capture
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig
    from vpp_tpu_torch.pipeline.vector import PacketVector

    d = Path(spec_dir)
    spec = json.loads((d / "spec.json").read_text())
    inputs = np.load(d / "inputs.npz")
    cl = MultiHostCluster(spec["n_nodes"], DataplaneConfig(**spec["config"]),
                          spec["rule_shards"], device=ctx.device)
    stager = load_stager(spec["stager"])
    t0 = time.perf_counter()
    for i in cl.local_nodes:
        stager(cl.node(i), i, spec["n_nodes"], **spec.get("stage_args", {}))
    stage_s = time.perf_counter() - t0
    barrier("staged")
    t0 = time.perf_counter()
    cl.publish()
    publish_s = time.perf_counter() - t0
    rows = slice(cl.local_nodes[0], cl.local_nodes[-1] + 1)
    dev = cl.device

    def vector(key):
        cols = torch.from_numpy(np.ascontiguousarray(inputs[key][rows]))
        return PacketVector(*cols.to(dev).unbind(1))

    def step(k, meta):
        pkts = vector(f"cols.{k}")
        if f"payload.{k}" in inputs.files:
            pay = torch.from_numpy(np.ascontiguousarray(
                inputs[f"payload.{k}"][rows])).to(dev)
            return cl.step_wire(pkts, pay, now=meta["now"],
                                budget=meta.get("budget", 0))
        return cl.step(pkts, now=meta["now"],
                       budget=meta.get("budget", 0)), None

    names = {w: getattr(w, "__name__", str(w)) for w in capture.WRAPPERS}
    for w in names:
        w.launches = 0
    out = {}
    fields = spec.get("state_fields", [])
    for k, meta in enumerate(spec["steps"]):
        res, pay = step(k, meta)
        for f, a in cluster_result_to_numpy(res).items():
            out[f"{k}.{f}"] = a
        for f, a in cluster_tables_to_numpy(cl.tables, fields).items():
            out[f"{k}.state.{f}"] = a
        if pay is not None:
            out[f"{k}.payload"] = pay.cpu().numpy()
    launches = {n: w.launches for w, n in names.items()}
    np.savez(d / f"out.{ctx.rank}.npz", **out)
    verdict = {"local_nodes": cl.local_nodes,
               "classifier": cl.classifier_impl,
               "fast": bool(cl.plane.fastpath_selected),
               "fib": cl.fib_impl, "ml": cl.plane.ml_selected,
               "launches": launches, "stage_s": stage_s,
               "publish_s": publish_s, "steps": len(spec["steps"])}
    verdict["timing"] = _replay_timing(cl, spec.get("timing", []), vector,
                                       dev)
    barrier("done")
    return verdict


def _replay_timing(cl, cells, vector, dev) -> dict:
    """Median ms of a cluster step per cell (CUDA events on the card, the
    host clock on the CPU), with the exchange's host hops, the bytes
    sent to other ranks, graph launches and host syncs per step."""
    import torch

    cuda = dev.type == "cuda"
    out = {}
    for cell in cells:
        cl.graphs = cell.get("graphs", True)
        pkts = vector(cell["input"])
        now = cell["now"]
        if "label" not in cell:   # a priming step: its sessions, no time
            cl.step(pkts, now=now)
            continue
        for _ in range(2):
            cl.step(pkts, now=now)
            now += 1
        if cuda:
            torch.cuda.synchronize()
        if cl.fabric is not None:
            cl.fabric.settle()
        fab = dict(cl.fabric.stats) if cl.fabric is not None else None
        progs = cl.plane.programs()
        replays = sum(p.replays for prog in progs for p in prog.parts)
        reads = sum(prog.host_reads for prog in progs)
        ms = []
        for _ in range(cell["steps"]):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                cl.step(pkts, now=now)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            else:
                t = time.perf_counter()
                cl.step(pkts, now=now)
                ms.append((time.perf_counter() - t) * 1e3)
            now += 1
        n = cell["steps"]
        row = {"ms": float(np.median(ms)), "ms_all": ms}
        if cl.graphs:
            progs = cl.plane.programs()
            row["graph_launches"] = (sum(p.replays for prog in progs
                                         for p in prog.parts)
                                     - replays) / n
            syncs = sum(prog.host_reads for prog in progs) - reads
            if fab is not None:
                syncs += cl.fabric.stats["swaps"] - fab["swaps"]
            row["host_syncs"] = syncs / n
        if fab is not None:
            if cuda:
                torch.cuda.synchronize()
            cl.fabric.settle()
            st = cl.fabric.stats
            for k in ("wait_s", "d2h_s", "all_to_all_s", "h2d_s"):
                row[k[:-2] + "_ms"] = (st[k] - fab[k]) * 1e3 / n
            row["bytes_sent"] = (st["bytes_sent"] - fab["bytes_sent"]) / n
        out[cell["label"]] = row
    cl.graphs = True
    return out


SCENARIOS = {
    "fabric": scenario_fabric,
    "lockstep": scenario_lockstep,
    "lockstep_failover": scenario_lockstep_failover,
    "runtime": scenario_runtime,
    "wire": scenario_wire,
    "mxu": scenario_mxu,
    "replay": scenario_replay,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vpp_tpu_torch.testing.multihost",
        description="one rank of a multi-host mesh scenario")
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("coordinator", help="host:port, served by rank 0")
    ap.add_argument("--device", default=None,
                    help="where this rank's mesh rows live (default: the "
                         "card; without one the rank raises)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="the process group's timeout, seconds")
    ap.add_argument("args", nargs="*", help="the scenario's arguments")
    a = ap.parse_args(argv)
    from vpp_tpu_torch.pipeline.tables import resolve_device

    device = resolve_device(a.device)
    if device.type == "cpu":
        import torch

        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    from vpp_tpu_torch.parallel.multihost import (init_multihost,
                                                  shutdown_multihost)

    init_multihost(a.coordinator, a.world, a.rank,
                   heartbeat_timeout_s=int(a.timeout))
    verdict = SCENARIOS[a.scenario](Ctx(a.rank, a.world, device), a.args)
    print(VERDICT + json.dumps(verdict), flush=True)
    shutdown_multihost()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
