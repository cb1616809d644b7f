"""The multi-host mesh across real processes: the reference's scenarios
(``tests/test_multihost.py``) on the port, each as a 2-rank ``gloo``
run of ``vpp_tpu_torch.testing.multihost`` with the reference's
assertions.

* The fabric: a 4-node cluster over two ranks; traffic, ACL drops and a
  reply's session across the process boundary.
* The lockstep commit: the last rank stages a deny and requests a
  commit through a KV server process; both ranks publish on the same
  tick and the cross-rank flow is cut on it. The stop protocol: a stale
  stop counter does not halt the new fleet, ``request_stop`` stops both.
* The deployed runtime: ``MultiHostRuntime`` with ContivAgents on each
  rank over the shared store: CNI adds, node events resolving peers to
  mesh rows across processes, fabric delivery, a renderer policy cut.
* The wire: ``io.enabled``, wire frames into one rank's rx ring out of
  the other's tx ring with their UDP bodies intact, the idle skip, the
  commit tick that steps, a NetworkPolicy cutting the path.
* MXU selection: the fleet agrees on the MXU classifier at 640 rules and
  its verdicts equal a dense-forced twin's (the reference runs this one
  in one process; here it is two ranks of one node each).
* The lockstep across a fenced store pair's failover (witness, primary,
  standby as processes; the primary SIGKILLed mid-run).

And the launcher's discipline: a rank that exits nonzero fails the run
at once and its peers are reaped; a peer that never joins makes a rank
raise at the process group's timeout instead of hanging. Every rank is
a subprocess with a timeout of its own, on a coordinator port the kernel
hands out, its files under the test's temporary directory.

Every quantity compared is an integer, a bool or a string: the tolerance
is exact equality.
"""

from __future__ import annotations

import contextlib
import json
import signal
import sys
import time

import pytest

from vpp_tpu_torch.testing import multihost as mh


def _run(tmp_path, scenario, *args, timeout=240):
    with mh.store_process(tmp_path) as (_, kv_port):
        return mh.run_ranks(scenario, 2, [kv_port, *args], device="cpu",
                            timeout=timeout)


def test_two_process_fabric():
    outs = mh.run_ranks("fabric", 2, device="cpu", timeout=180)
    # rank 0 fabric-routed all three packets
    assert outs[0]["local_nodes"] == [0, 1]
    assert outs[0]["sent_remote"] == 3
    # rank 1: pod2 got its packet on the right interface; node 3's
    # global table let port 80 through and dropped port 22
    assert outs[1]["local_nodes"] == [2, 3]
    assert outs[1]["pod2_delivered"] == 1
    assert outs[1]["pod2_txif_ok"] and outs[1]["pod2_dst_ok"]
    assert outs[1]["pod3_delivered"] == 1
    assert outs[1]["node3_acl_drops"] == 1
    # step 2: the reply crossed back rank 1 -> rank 0
    assert outs[0]["reply_delivered"] == 1


def test_lockstep_commit_across_processes(tmp_path):
    outs = _run(tmp_path, "lockstep")
    v = outs[1]
    assert v["t1_delivered"] == 1          # flowing before the commit
    assert v["t2_epoch"] == 2              # both published on tick 2
    assert outs[0]["t2_epoch"] == 2
    assert v["t2_delivered"] == 0          # cut off the same tick
    assert v["t2_acl_drops"] == 1
    assert v["t3_delivered"] == 0
    assert outs[0]["applied"] == 1 and outs[1]["applied"] == 1
    # the previous fleet's stop counter (5) is the agreed baseline: the
    # ticks ran, and a fresh request stopped both ranks on one tick
    for o in outs:
        assert o["stop_base"] == 5 and o["ticks"] == 3 and o["stop"]


def test_deployed_runtime_across_processes(tmp_path):
    outs = _run(tmp_path, "runtime")
    assert outs[0]["stage1_ok"] is True
    assert outs[1]["stage1_delivered"] >= 1       # fabric worked
    assert outs[1]["stage2_new_deliveries"] == 0  # policy cut it off
    assert outs[1]["stage2_acl_drops"] >= 1
    # `show mesh` of a live runtime: the rows this rank drives, the
    # lockstep counters and its agents
    page = outs[1]["show_mesh"].splitlines()
    assert page[0].startswith("cluster: 4 nodes, epoch ")
    assert page[1] == "local mesh rows: [2, 3]"
    assert page[2].startswith("lockstep: tick ")
    assert page[3].startswith("agents: mh-2(id ")


def test_wire_path_across_processes(tmp_path):
    outs = _run(tmp_path, "wire")
    assert outs[0]["stage1_ok"] is True
    assert outs[0]["idle_steps_flat"] is True   # fleet-idle skips steps
    assert outs[1]["wire_delivered"] >= 1
    assert outs[1]["commit_stepped"] is True    # commit tick always steps
    assert outs[1]["stage2_cut"] is True


def test_mxu_selection_and_equivalence():
    outs = mh.run_ranks("mxu", 2, device="cpu", timeout=180)
    assert all(v["mxu_selected"] and v["dense_selected"] for v in outs)
    assert all(v["verdicts_equal"] for v in outs)
    assert sum(v["drop_acl"] for v in outs) >= 1   # some flows denied
    assert sum(v["delivered"] for v in outs) >= 1  # and some delivered


def test_lockstep_survives_store_failover(tmp_path):
    """The fleet's store dies mid-lockstep: the witness promotes the
    standby, the ranks' clients fail over, and a commit requested
    through the NEW primary still publishes on the same tick on both
    ranks."""
    from vpp_tpu_torch.kvstore.client import RemoteKVStore
    from vpp_tpu_torch.kvstore.witness import WitnessClient

    server = "vpp_tpu_torch.cmd.kvserver"
    with contextlib.ExitStack() as stack:
        _, w_port = stack.enter_context(mh.store_process(
            tmp_path, "vpp_tpu_torch.cmd.kvwitness", name="w"))
        primary, kv_port = stack.enter_context(mh.store_process(
            tmp_path, server, ["--witness", f"127.0.0.1:{w_port}",
                               "--fence-ttl", "6"], name="kv"))
        _, sb_port = stack.enter_context(mh.store_process(
            tmp_path, server, ["--follow", f"127.0.0.1:{kv_port}",
                               "--witness", f"127.0.0.1:{w_port}",
                               "--fence-ttl", "6", "--promote-after", "3"],
            name="sb"))
        url = f"tcp://127.0.0.1:{kv_port},127.0.0.1:{sb_port}"
        ranks = mh.start_ranks("lockstep_failover", 2, [url], device="cpu")
        stack.callback(ranks.kill)
        cli = RemoteKVStore("127.0.0.1", kv_port, request_timeout=60.0,
                            reconnect_timeout=60.0,
                            fallbacks=[("127.0.0.1", sb_port)])
        stack.callback(cli.close)
        # both ranks mid-run (tick 1 done) before the kill
        deadline = time.monotonic() + 120
        while not (cli.get("mhf/ready/0") == 1
                   and cli.get("mhf/ready/1") == 1):
            assert all(p.poll() is None for p in ranks.procs), \
                "a rank died before the failover"
            assert time.monotonic() < deadline, "ranks never got ready"
            time.sleep(0.2)
        primary.send_signal(signal.SIGKILL)
        primary.wait(timeout=15)
        wc = WitnessClient(f"127.0.0.1:{w_port}")
        deadline = time.monotonic() + 60
        while True:
            st = wc.status()
            if st["primary"] == f"127.0.0.1:{sb_port}" and st["epoch"] >= 1:
                break
            assert time.monotonic() < deadline, f"no promotion: {st}"
            time.sleep(0.2)
        cli.put("mhf/go", 1)   # lands on the NEW primary, fenced
        outs = [mh.verdict_of(o) for o, _ in ranks.wait(timeout=240)]
    for v in outs:
        # exactly ONE promotion: the standby's claim bumped the fencing
        # epoch to 1 and both ranks' writes carry it
        assert v["fence_epoch"] == 1
        assert v["applied"] == 1          # the commit applied once
        assert v["t3_epoch"] == 2         # on the same tick, both ranks
    v = outs[1]
    assert v["t1_delivered"] == 1         # flowing before the failover
    assert v["t2_delivered"] == 1         # still flowing right after it
    assert v["t3_delivered"] == 0         # cut by the post-failover commit


def test_a_failed_rank_fails_the_run_and_its_peers_are_reaped():
    t0 = time.monotonic()
    ranks = mh.Ranks([[sys.executable, "-c", "import sys; sys.exit(3)"],
                      [sys.executable, "-c", "import time; time.sleep(120)"]])
    with pytest.raises(mh.RankFailed, match="rank 0 exited 3"):
        ranks.wait(timeout=60)
    assert time.monotonic() - t0 < 30
    assert [p.poll() for p in ranks.procs][1] is not None


def test_a_peer_that_never_joins_raises_at_the_group_timeout():
    """Rank 1 of a world of 2 never starts: rank 0's process group gives
    up at its timeout (5 s here) and the rank exits nonzero, no hang."""
    argv = mh.rank_argv("fabric", 0, 2, f"127.0.0.1:{mh.free_port()}",
                        device="cpu", group_timeout=5)
    ranks = mh.Ranks([argv])
    t0 = time.monotonic()
    with pytest.raises(mh.RankFailed, match="rank 0 exited"):
        ranks.wait(timeout=90)
    assert time.monotonic() - t0 < 60


def test_mesh_agents_boot_as_two_ranks(tmp_path):
    """``vpp-tpu-torch-mesh-agent --coordinator ... --num-processes 2
    --process-id r`` boots each rank (one node per rank: ``nodes: 0``)
    over a KV server process; each rank's agent publishes its mesh row
    in the store; SIGTERM on rank 0 stops the fleet: both exit 0."""
    from vpp_tpu_torch.kvstore.client import RemoteKVStore

    with mh.store_process(tmp_path) as (_, kv_port):
        cfg = tmp_path / "mesh.json"
        cfg.write_text(json.dumps({
            "node_name": "mha", "serve_http": False,
            "store_url": f"tcp://127.0.0.1:{kv_port}",
            "dataplane": {"max_tables": 4, "max_rules": 16,
                          "max_global_rules": 32, "max_ifaces": 8,
                          "fib_slots": 32, "sess_slots": 256,
                          "nat_mappings": 4, "nat_backends": 16}}))
        coord = f"127.0.0.1:{mh.free_port()}"
        ranks = mh.Ranks([
            [sys.executable, "-m", "vpp_tpu_torch.cmd.mesh_main", "--config",
             str(cfg), "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(r), "--device", "cpu"] for r in range(2)])
        try:
            deadline = time.monotonic() + 120
            while not all("mesh agent up" in ranks.output(r)[1]
                          for r in range(2)):
                assert all(p.poll() is None for p in ranks.procs), \
                    [ranks.output(r)[1][-2000:] for r in range(2)]
                assert time.monotonic() < deadline, "the ranks never booted"
                time.sleep(0.2)
            cli = RemoteKVStore("127.0.0.1", kv_port)
            try:
                rows = sorted(int(v) for v in
                              cli.list_values("/mesh/pos/").values())
            finally:
                cli.close()
            assert rows == [0, 1]
            ranks.procs[0].send_signal(signal.SIGTERM)
            outs = ranks.wait(timeout=90)
        finally:
            ranks.kill()
    for _, err in outs:
        assert "mesh agent up: 2 nodes x 1 rule shards" in err
