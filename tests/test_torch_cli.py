"""The debug CLI: vpp_tpu_torch's DebugCLI and vpp-tpu-torch-ctl vs
vpp_tpu's.

* The reference's own cases (``tests/test_cli.py``) run as written on
  the port through ``test_torch_kvserver.run_port_case`` (the port's
  Dataplane on the CPU). ``test_show_io_with_pump_and_daemon`` and
  ``test_show_neighbors_lists_static_and_learned`` run the port's pump,
  IO daemon, control socket and CLI.
* A differential: one seeded world staged alike in both packages (pods,
  routes, an ECMP group, local and global tables, a NAT mapping, a
  service VIP, an MLP model, telemetry, session rules, a store) and the
  same traffic; every command of the reference's ``run`` table gives
  the same text on the port's CPU dataplane as on the reference's, line
  for line, but for the lines ``DIFFERS`` names (each with its reason).
* ``vpp-tpu-torch-ctl``: ``run_line`` and ``main`` over a served CLI
  socket answer what the CLI answers in process.

Every quantity compared is a text line: the tolerance is exact
equality, with the timings inside a line (a build's or an upload's
milliseconds) left out.
"""

from __future__ import annotations

import ipaddress
import re
import types

import numpy as np
import pytest

import test_cli as jcli_tests
from test_torch_agent import CpuDataplane, CpuSessionRuleEngine, case_names
from test_torch_kvserver import run_port_case

CLI_CASES = case_names(jcli_tests)


def test_cli_case_list():
    """Every case of tests/test_cli.py runs here."""
    assert len(CLI_CASES) == 10


@pytest.mark.parametrize("case", CLI_CASES)
def test_reference_cli_cases(case, request):
    run_port_case(jcli_tests, case, request)


# --- the differential --------------------------------------------------

def _package(port: bool) -> types.SimpleNamespace:
    if port:
        from vpp_tpu_torch import cli
        from vpp_tpu_torch.hoststack import session_rules as sr
        from vpp_tpu_torch.ir import rule
        from vpp_tpu_torch.kvstore.store import KVStore
        from vpp_tpu_torch.ml.train import train_and_pack
        from vpp_tpu_torch.pipeline import tables, vector
        from vpp_tpu_torch.stats.collector import StatsCollector
        from vpp_tpu_torch.trace import spans

        return types.SimpleNamespace(
            cli=cli, sr=sr, rule=rule, KVStore=KVStore, tables=tables,
            spans=spans,
            vector=vector, StatsCollector=StatsCollector,
            train_and_pack=train_and_pack, Dataplane=CpuDataplane,
            SessionRuleEngine=CpuSessionRuleEngine)
    from vpp_tpu import cli
    from vpp_tpu.hoststack import session_rules as sr
    from vpp_tpu.ir import rule
    from vpp_tpu.kvstore.store import KVStore
    from vpp_tpu.ml.train import train_and_pack
    from vpp_tpu.pipeline import tables, vector
    from vpp_tpu.pipeline.dataplane import Dataplane
    from vpp_tpu.stats.collector import StatsCollector
    from vpp_tpu.trace import spans

    return types.SimpleNamespace(
        cli=cli, sr=sr, rule=rule, KVStore=KVStore, tables=tables,
        spans=spans,
        vector=vector, StatsCollector=StatsCollector,
        train_and_pack=train_and_pack, Dataplane=Dataplane,
        SessionRuleEngine=sr.SessionRuleEngine)


def _traffic(P, pods, rng, n: int = 48):
    """Seeded packets from the pods and the uplink (rx_if, src) toward
    pods, the service VIP, the NAT mapping and remote prefixes."""
    dsts = ["10.1.1.2", "10.1.1.3", "10.1.1.4", "10.96.0.9", "10.96.0.20",
            "10.2.3.4", "8.8.8.8"]
    rows = []
    for _ in range(n):
        rx_if, src = pods[int(rng.integers(len(pods)))]
        rows.append(dict(src=src, dst=dsts[int(rng.integers(len(dsts)))],
                         proto=int(rng.choice([6, 17])),
                         sport=int(rng.integers(1024, 65535)),
                         dport=int(rng.choice([80, 443, 53, 8080])),
                         len=int(rng.choice([64, 700, 1400])),
                         rx_if=rx_if))
    return P.vector.make_packet_vector(rows)


def _world(P, seed: int):
    """The staged world of one package: (cli, dataplane, stats, pods)."""
    R = P.rule
    Disp = P.vector.Disposition
    ip4 = P.vector.ip4
    dp = P.Dataplane(P.tables.DataplaneConfig(
        sess_slots=256, telemetry="full", ml_stage="score", svc_vips=4,
        fib_ecmp_groups=2))
    uplink = dp.add_uplink()
    dp.add_host_interface()
    a = dp.add_pod_interface(("default", "web"))
    b = dp.add_pod_interface(("default", "db"))
    c = dp.add_pod_interface(("prod", "api"))
    b_ = dp.builder
    b_.add_route("10.1.1.2/32", a, Disp.LOCAL)
    b_.add_route("10.1.1.3/32", b, Disp.LOCAL)
    b_.add_route("10.1.1.4/32", c, Disp.LOCAL)
    b_.set_nh_group(1, [(ip4("192.168.16.2"), uplink, 2),
                        (ip4("192.168.16.3"), uplink, 3)])
    b_.add_route("10.2.0.0/16", uplink, Disp.REMOTE,
                 next_hop=ip4("192.168.16.2"), node_id=2, group=1)
    b_.add_route("0.0.0.0/0", uplink, Disp.REMOTE,
                 next_hop=ip4("192.168.16.1"), snat=True)
    slot = dp.alloc_table_slot("T1")
    b_.set_local_table(slot, [
        R.ContivRule(action=R.Action.PERMIT,
                     dest_network=ipaddress.ip_network("10.1.1.3/32"),
                     protocol=R.Protocol.TCP, dest_port=80),
        R.ContivRule(action=R.Action.PERMIT, protocol=R.Protocol.UDP,
                     dest_port=53),
        R.ContivRule(action=R.Action.DENY),
    ])
    dp.assign_pod_table(("default", "web"), "T1")
    b_.set_global_table([
        R.ContivRule(action=R.Action.DENY, protocol=R.Protocol.TCP,
                     dest_port=443),
        R.ContivRule(action=R.Action.PERMIT,
                     src_network=ipaddress.ip_network("10.0.0.0/8")),
        R.ContivRule(action=R.Action.PERMIT),
    ])
    b_.set_nat_mapping(
        0, ext_ip=ip4("10.96.0.9"), ext_port=80, proto=6,
        backends=[(ip4("10.1.1.2"), 8080, 2), (ip4("10.1.1.3"), 8080, 1)],
        boff=0)
    b_.set_service(ip4("10.96.0.20"), 53, 17,
                   [(ip4("10.1.1.4"), 5353, 1), (ip4("10.1.1.3"), 5353, 3)])
    model, _ = P.train_and_pack(kind="mlp", hidden=16, samples=512,
                                seed=seed)
    b_.set_ml_model(model)
    dp.swap()
    eng = P.SessionRuleEngine()
    eng.apply(add=[
        P.sr.SessionRule(scope=int(P.sr.RuleScope.LOCAL), appns_index=a,
                         transport_proto=6, lcl_net=0, lcl_plen=0,
                         rmt_net=ip4("10.1.1.9"), rmt_plen=32,
                         lcl_port=0, rmt_port=443,
                         action=int(P.sr.RuleAction.DENY))])
    store = P.KVStore()
    store.put("ksr/k8s/pod/web/namespace/default", {"ip": "10.1.1.2"})
    stats = P.StatsCollector(dp)
    cli = P.cli.DebugCLI(dp, stats=stats, session_engine=eng, store=store)
    pods = [(a, "10.1.1.2"), (b, "10.1.1.3"), (c, "10.1.1.4"),
            (uplink, "172.16.5.5")]
    return cli, dp, stats, pods


# every command of the reference's ``run`` table, in its order
COMMANDS = [
    "show interface", "show acl", "show sessions", "show session",
    "show session-rules", "show mesh", "show partitions", "show nat44",
    "show services", "show overlay", "show trace", "show errors",
    "show fastpath", "show kernels", "show ml", "show latency",
    "show top-flows", "show governor", "show tenants", "show io",
    "show neighbors", "show store", "show resilience", "show fleet",
    "help", "show fib", "show fib 10.2.0.0/16", "show config-history",
    "show spans 3", "test connectivity 10.1.1.2 10.1.1.3 tcp 80",
    "test connectivity 10.1.1.2 10.1.1.3 tcp 443",
    "test connectivity 10.1.1.2 10.96.0.9 tcp 80 41000",
    "trace clear", "config replay", "bogus command",
]

# (command, line prefix) -> why the port's line differs; every other
# line is compared
DIFFERS = {
    ("show partitions", "  [      rule] ^glb_mxu_op$"):
        "the port's derived MXU operand has a rule of its own",
    ("show partitions", "  [replicated] ^fib_lpm_(lens|stk_cnt"):
        "the port's derived LPM stack has a rule of its own",
    ("show kernels", "kernel implementation ladders"):
        "names the card (or cpu) and the CUDA kernels, where the "
        "reference names the jax backend and Pallas",
    ("show kernels", "  classifier"): "the why of a rung names the device",
    ("show kernels", "  fib"): "the why of a rung names the device",
    ("show kernels", "  session"): "the why of a rung names the device",
    ("show io", "jit compiles:"): "the port lists its captured step "
                                  "programs, the reference its XLA "
                                  "compiles (process-wide)",
    ("show io", "device transfer bytes:"): "process-wide transfer "
                                           "counters of each package",
}


# a timing inside a line (a build, a churn upload): timings are not
# compared
_TIMING = re.compile(r" *\d+\.\d+ ?ms\b")


# a span trace's id: a process-wide counter of each package
_TRACE_ID = re.compile(r"\bt\d{6}\b")


# commands whose lines are compared as a sorted list, and why
ORDER_FREE = {
    "show partitions": "its rule groups follow each package's "
                       "DataplaneTables field order, which differ",
}


def _compared(cmd: str, text: str) -> list:
    lines = [_TRACE_ID.sub("t<id>", _TIMING.sub(" <t> ms", ln))
             for ln in text.splitlines()
             if not any(c == cmd and ln.startswith(p)
                        for c, p in DIFFERS)]
    return sorted(lines) if cmd in ORDER_FREE else lines


def _session_of(port: bool, seed: int = 0) -> dict:
    P = _package(port)
    P.spans.RECORDER.clear()  # process-global: this session's spans only
    cli, dp, stats, pods = _world(P, seed)
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(2):
        res = dp.process(_traffic(P, pods, rng), now=100 + k)
        stats.update(res.stats)
    out["trace add 8"] = cli.run("trace add 8")
    res = dp.process(_traffic(P, pods, rng), now=103)
    stats.update(res.stats)
    for cmd in COMMANDS:
        out[cmd] = cli.run(cmd)
    return out


def test_every_command_prints_what_the_reference_prints():
    """The port's CLI prints the reference's text, command by command
    and line by line, on the same world and traffic (``DIFFERS`` lists
    the lines that name a device or a program)."""
    ref, port = _session_of(False), _session_of(True)
    assert list(port) == list(ref)
    for cmd in ref:
        assert _compared(cmd, port[cmd]) == _compared(cmd, ref[cmd]), cmd
    # the session pages read real state: sessions were installed
    assert "0 established" not in ref["show session"]
    assert "verdict: FORWARDED" in ref[COMMANDS[-6]]
    assert "verdict: DROPPED" in ref[COMMANDS[-5]]
    assert "Packet (frame 0, slot 7)" in ref["show trace"]
    for cmd, _ in DIFFERS:
        assert port[cmd] and cmd in COMMANDS


def test_show_partitions_names_the_mesh_item():
    """The port's `show partitions` of a standalone dataplane lists the
    canonical placements, the port's derived fields under their own
    rules, and cites no ROADMAP item (the mesh is ported)."""
    P = _package(True)
    cli, dp, _, _ = _world(P, 0)
    out = cli.run("show partitions")
    assert out.startswith("standalone dataplane (no mesh attached)")
    assert "^glb_mxu_op$  (1 fields)" in out
    assert "^fib_lpm_(lens|stk_cnt|stk_pfx|stk_slot)$  (4 fields)" in out
    assert "ROADMAP" not in out


def test_ctl_runs_lines_over_a_served_socket(tmp_path, capsys):
    """``vpp-tpu-torch-ctl`` over a CLI socket served like the agent's
    answers what the CLI answers in process; a dead socket exits 1."""
    from vpp_tpu_torch.cmd import ctl
    from vpp_tpu_torch.cni.transport import CNITransportServer

    P = _package(True)
    cli, dp, _, _ = _world(P, 0)

    def dispatch(method, params):
        return {"result": 0, "output": cli.run(params.get("line", ""))}

    sock = str(tmp_path / "cli.sock")
    srv = CNITransportServer(sock, dispatch)
    srv.start()
    try:
        for line in ("show interface", "show fib", "show ml",
                     "test connectivity 10.1.1.2 10.1.1.3 tcp 80"):
            assert ctl.run_line(sock, line, 10.0) == cli.run(line)
        assert ctl.main(["--socket", sock, "show", "interface"]) == 0
        assert capsys.readouterr().out == cli.run("show interface") + "\n"
    finally:
        srv.close()
    assert ctl.main(["--socket", str(tmp_path / "none.sock"),
                     "show", "interface"]) == 1


def test_interface_type_is_the_reference_enum():
    """``InterfaceType`` is an ``IntEnum`` as the reference's is, so
    ``InterfaceType(code).name`` (what `show interface` prints) works
    on the port (it was a plain class there: ``InterfaceType(2)``
    raised ``TypeError``)."""
    from vpp_tpu.pipeline import tables as jtables
    from vpp_tpu_torch.pipeline import tables as ttables

    assert [(m.name, int(m)) for m in ttables.InterfaceType] == \
        [(m.name, int(m)) for m in jtables.InterfaceType]
    assert ttables.InterfaceType(2).name == "UPLINK"
