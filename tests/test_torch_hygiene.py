"""Package hygiene of vpp_tpu_torch: what it imports and where it runs.

* An AST scan of every module of ``vpp_tpu_torch`` (the IO pump's
  ``io/``, ``native/`` and ``net/``, the control plane's ``ksr/``,
  ``policy/``, ``renderer/``, ``service/`` and ``trace/``, the node
  agent's ``cmd/``, ``cni/``, ``kvstore/``, ``stats/``, ``health/``,
  ``hoststack/``, ``agent/`` and ``ipam/``, and its remote surfaces:
  the KV server, client, witness and replicas, the Kubernetes API
  client, the debug CLI and ``ctl``, the ML loader and ``show run``
  included) and of ``chip_smoke.py``
  finds no import of ``jax`` nor of the JAX package ``vpp_tpu`` (the
  module itself or any ``vpp_tpu.`` submodule; the port's own
  ``vpp_tpu_torch`` is of course allowed), and no string constant that
  names a ``vpp_tpu.`` module: the init supervisor spawns its children
  by module name, where an import scan cannot see a reference module.
* The entry points run on the card unless the caller asks for the CPU:
  with no CUDA device, ``Dataplane(cfg)``, ``TableBuilder(cfg)``,
  ``SessionRuleEngine()``, ``ContivAgent()`` and the agent's command
  line raise instead of running on the CPU.
* On CPU tensors every kernel wrapper serves through its plain version:
  a CPU run of the fused-kernel rungs leaves each launch counter at 0.
* Every stage knob is ported (the ML stage, telemetry, tenancy, the
  overlay, service VIPs, ECMP groups): each constructs, and a bad value
  raises the reference's ``ValueError`` naming the knob. What is still
  refused (the sharded session, NAT and ML forms, also under the newly
  ported knobs) names its ``ROADMAP.md`` Queue 1 item, number and
  title. The ring form and its telemetry rider run under every knob:
  tests/test_torch_persistent.py holds them against the reference.
* Every agent value that reaches a module not ported yet (the VCL
  socket, the mesh) raises ``NotImplementedError`` naming its ROADMAP
  item before the agent starts a thread, writes to its store or touches
  a device; so does the init supervisor for a mesh configuration, and
  the CLI's ``show partitions`` names the mesh's item in its text.

Every quantity compared is an integer: the tolerance is exact equality.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from vpp_tpu_torch.ops import acl_bv as tbv
from vpp_tpu_torch.ops import acl_mxu as tmxu
from vpp_tpu_torch.ops import lpm as tlpm
from vpp_tpu_torch.ops import mlscore as tml
from vpp_tpu_torch.ops import session as tsess
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vpp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_SMALL = dict(max_tables=2, max_rules=8, max_global_rules=8, max_ifaces=8,
              fib_slots=16, sess_slots=64, nat_mappings=2, nat_backends=4,
              fastpath=False)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "vpp_tpu")


def imported_modules(path: Path):
    """Every module name an ``import`` or ``from ... import`` of the
    file names (relative imports resolve to nothing outside it)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_scan_sees_the_whole_package():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "dataplane.py", "session.py", "acl_bv.py",
            "acl_mxu.py", "lpm.py", "_cuda.py", "interop.py", "mlscore.py",
            "telemetry.py", "model.py", "train.py", "vxlan.py", "derive.py",
            "sched.py", "snapshot.py", "faults.py", "transfer.py",
            "pump.py", "rings.py", "governor.py", "icmp.py",
            "persistent.py", "backoff.py", "ring.py", "pktio.py",
            "table.py", "spans.py", "tracer.py", "cache.py", "config.py",
            "processor.py", "configurator.py", "api.py", "tpu.py",
            "txn.py", "agent.py", "config.py", "ksr_main.py", "store.py",
            "proxy.py", "node_id.py", "ipam.py", "containeridx.py",
            "transport.py", "shim.py", "server.py", "statuscheck.py",
            "stn.py", "prometheus.py", "collector.py", "session_rules.py",
            "vpptcp.py", "reflector.py", "cli.py", "ctl.py",
            "client.py", "witness.py", "replica.py", "kvserver.py",
            "kvwitness.py", "k8s_client.py", "loader.py",
            "cycles.py", "linux.py", "daemon.py", "control.py",
            "io_daemon.py", "wiring.py", "stn_netlink.py", "init_main.py",
            "_lazy.py"} <= names
    for sub in ("io", "native", "net", "ksr", "policy", "renderer",
                "service", "trace", "cmd", "cni", "kvstore", "stats",
                "health", "hoststack", "agent", "ipam"):
        assert (ROOT / "vpp_tpu_torch" / sub / "__init__.py") in PORT_FILES
    assert (ROOT / "vpp_tpu_torch" / "ml" / "model.py") in PORT_FILES
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [(ln, m) for ln, m in imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_matches_the_jax_package_but_not_the_port():
    assert _forbidden("vpp_tpu") and _forbidden("vpp_tpu.ops.session")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("vpp_tpu_torch")
    assert not _forbidden("vpp_tpu_torch.ops.session")


# a reference module's dotted name: vpp_tpu.<x>, not vpp_tpu_torch.<x>
_REF_MODULE = re.compile(r"(?<![\w.])vpp_tpu\.(?:[A-Za-z_]|\Z)")


def named_reference_modules(path: Path):
    """Every string constant of the file (docstrings, f-string parts and
    argv lists included) that names a ``vpp_tpu.`` module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and _REF_MODULE.search(node.value)):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_reference_module_in_a_string(path):
    """``InitSupervisor`` spawns ``python -m <module>``: a string that
    kept ``vpp_tpu.cmd.io_daemon`` would quietly run the reference's
    daemon, which no import scan sees."""
    bad = list(named_reference_modules(path))
    assert bad == [], f"{path.relative_to(ROOT)} names {bad}"


def test_string_scan_matches_reference_modules_only(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text(
        'ARGV = ["-m", "vpp_tpu.cmd.io_daemon"]\n'
        'OK = ["-m", "vpp_tpu_torch.cmd.io_daemon", "vpp_tpu/io/daemon.py",'
        ' "vpp_tpu_pump_drops_total", "x.vpp_tpu.y"]\n'
        'def f(m):\n    return f"vpp_tpu.{m}"\n')
    assert [ln for ln, _ in named_reference_modules(src)] == [1, 4]


def test_every_field_uploads_in_exactly_one_group():
    """Every staged field belongs to exactly one upload group, and every
    derived field follows one of them (it is rebuilt when that group
    ships, and only then)."""
    groups = ttables._UPLOAD_GROUPS
    seen = [f for fields in groups.values() for f in fields]
    assert sorted(seen) == sorted(ttables.HOST_FIELDS)
    assert len(seen) == len(set(seen))
    assert set(ttables.DERIVED_GROUPS) == set(ttables.DERIVED_FIELDS)
    assert set(ttables.DERIVED_GROUPS.values()) <= set(groups)
    assert not set(ttables.STATE_FIELDS) & set(seen)


def test_entry_points_refuse_the_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttables.DataplaneConfig(**_SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdp.Dataplane(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttables.TableBuilder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttables.resolve_device(None)
    from vpp_tpu_torch.cmd import agent as tagent
    from vpp_tpu_torch.hoststack import SessionRuleEngine
    from vpp_tpu_torch.kvstore import KVStore

    with pytest.raises(RuntimeError, match="CUDA"):
        SessionRuleEngine()
    store = KVStore()
    with pytest.raises(RuntimeError, match="CUDA"):
        tagent.ContivAgent(store=store)
    assert store.revision == 0, "the agent wrote to its store first"
    with pytest.raises(RuntimeError, match="CUDA"):
        tagent.main([])
    # asking for the CPU is allowed
    assert tdp.Dataplane(cfg, device="cpu").device.type == "cpu"
    assert SessionRuleEngine(device="cpu").device.type == "cpu"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ttables.resolve_device(None) == torch.device("cuda")


# the stage knobs, each with a value the reference refuses (its
# ValueError names the knob)
_BAD_VALUES = {"ml_stage": "bogus", "telemetry": "bogus", "tenancy": "bogus",
               "overlay": "bogus", "svc_vips": 4097, "fib_ecmp_groups": 4097}


@pytest.mark.parametrize("knob,value", [
    ("ml_stage", "enforce"), ("telemetry", "latency"), ("tenancy", "on"),
    ("overlay", "vxlan"), ("svc_vips", 4), ("fib_ecmp_groups", 2)])
def test_unported_stages_refuse(knob, value):
    """Every stage knob is ported: it constructs, its gate reads the
    config (the ML stage stays off until a model is staged), and a bad
    value raises the ValueError naming the knob."""
    cfg = ttables.DataplaneConfig(**dict(_SMALL, **{knob: value}))
    dp = tdp.Dataplane(cfg, device="cpu")
    assert dp._ml_mode == "off" and dp._tel_mode == cfg.telemetry
    assert (dp._tnt_mode, dp._overlay) == (cfg.tenancy, cfg.overlay)
    assert dp.tables.svc_vip_ip.shape[0] == max(cfg.svc_vips, 1)
    assert dp.tables.fib_grp_n.shape[0] == max(cfg.fib_ecmp_groups, 1)
    with pytest.raises(ValueError, match=knob):
        tdp.Dataplane(cfg._replace(**{knob: _BAD_VALUES[knob]}),
                      device="cpu")


def _queue1_titles():
    """ROADMAP.md Queue 1 as {item number: bold title}."""
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("### Queue 1")
    section = text[start:text.index("\n### ", start + 1)]
    return {int(n): t.rstrip(".:") for n, t in
            re.findall(r"^(\d+)\. \*\*(.+?)\*\*", section, re.M)}


def _refusal(kind, arg):
    """The NotImplementedError message of one remaining refusal (for
    ``cli``, the text of the command)."""
    if kind == "cli":
        from vpp_tpu_torch.cli import DebugCLI

        return DebugCLI(tdp.Dataplane(ttables.DataplaneConfig(**_SMALL),
                                      device="cpu")).run(arg)
    with pytest.raises(NotImplementedError) as err:
        if kind == "agent":
            _agent_refusal(arg)
        elif kind == "ml":
            pkts = tvector.make_packet_vector([], n=8)
            t = tdp.Dataplane(ttables.DataplaneConfig(**_SMALL),
                              device="cpu").tables
            tml.ml_score(t, pkts, pkts.valid, pkts.proto, shard=True)
        elif kind == "shard":
            # the sharded forms of the tenant-sliced session and NAT
            # paths (tenancy on)
            from vpp_tpu_torch.ops import nat44 as tnat

            pkts = tvector.make_packet_vector([], n=8)
            t = tdp.Dataplane(ttables.DataplaneConfig(**dict(
                _SMALL, tenancy="on")), device="cpu").tables
            if arg == "nat44_reverse":
                tnat.nat44_reverse(t, pkts, pkts.valid, 1, shard=True,
                                   tnt=True)
            elif arg == "nat44_record":
                tnat.nat44_record(t, pkts, *pkts[:4], pkts.proto,
                                  pkts.valid, 1, shard=True, tnt=True)
            elif arg == "session_insert":
                tsess.session_insert(t, pkts, pkts.valid, 1, shard=True,
                                     tnt=True)
            else:
                tsess.session_lookup_reverse_idx(t, pkts, 1, shard=True,
                                                 tnt=True)
        else:
            tsess._refuse(**arg)
    return str(err.value)


# the agent's refused values: (AgentConfig keyword arguments, other
# ContivAgent arguments)
_AGENT_REFUSED = {
    "vcl_socket": ({"vcl_socket": "/run/vcl.sock"}, {}),
    "mesh.enabled": ({"mesh": {"enabled": True}}, {}),
    "dataplane": ({}, {"dataplane": "mesh node handle"}),
    "mesh_node_resolver": ({}, {"mesh_node_resolver": lambda n: n}),
}


def _agent_refusal(arg):
    """One refused agent value, or another refused seam of the slice."""
    from vpp_tpu_torch.cmd import AgentConfig, ContivAgent
    from vpp_tpu_torch.kvstore import KVStore

    if arg == "init mesh":
        from vpp_tpu_torch.cmd import AgentConfig
        from vpp_tpu_torch.cmd.init_main import InitSupervisor

        InitSupervisor(AgentConfig.from_dict({"mesh": {"nodes": 2}}), None,
                       spawn=None)
    elif arg in ("set_cluster", "set_fleet", "set_vcl"):
        from vpp_tpu_torch.stats import StatsCollector

        coll = StatsCollector(tdp.Dataplane(ttables.DataplaneConfig(
            **_SMALL), device="cpu"))
        getattr(coll, arg)(object())
    else:
        cfg, kw = _AGENT_REFUSED[arg]
        ContivAgent(AgentConfig.from_dict(dict(
            {"serve_http": False}, **cfg)), store=KVStore(),
            device="cpu", **kw)


_REFUSALS = {
    # the node agent's slice (ROADMAP Queue 1 items 12 and 10)
    **{f"agent-{k}": ("agent", k) for k in _AGENT_REFUSED},
    **{f"agent-{k}": ("agent", k) for k in (
        "init mesh", "set_cluster", "set_fleet", "set_vcl")},
    # the debug CLI's page of the mesh's partition layer (a text, not
    # an exception)
    "cli-show_partitions": ("cli", "show partitions"),
    # every stage knob and step form is ported; what is still refused:
    # the sharded (mesh) forms, also under each knob ported since
    "ml_stage": ("ml", "shard"),
    "gate-ml_mode": ("ml", "shard"),
    "gate-tnt_mode": ("shard", "nat44_reverse"),
    "gate-overlay": ("shard", "nat44_record"),
    "entry-overlay-sidecar": ("shard", "session_insert"),
    "session-shard": ("session", dict(shard=True)),
    "session-tnt": ("shard", "session_lookup_reverse_idx"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_refusals_name_their_roadmap_item(case):
    """Every remaining refusal cites ``Queue 1 item N (Title)`` and
    ROADMAP.md's Queue 1 lists item N under that title."""
    msg = _refusal(*_REFUSALS[case])
    cited = re.findall(r"item (\d+) \(([^)]+)\)", msg)
    assert cited, msg
    titles = _queue1_titles()
    for n, title in cited:
        assert titles.get(int(n)) == title, (msg, titles)


@pytest.mark.parametrize("value", sorted(_AGENT_REFUSED))
def test_unported_agent_values_refuse(value, monkeypatch):
    """Each refused agent value raises ``NotImplementedError`` naming the
    module it waits for before the agent starts: no thread, no store
    write, no device (it refuses the same on a machine without a card,
    where resolving the device would raise instead)."""
    import threading

    from vpp_tpu_torch.cmd import AgentConfig, ContivAgent
    from vpp_tpu_torch.kvstore import KVStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, kw = _AGENT_REFUSED[value]
    store = KVStore()
    threads = threading.active_count()
    with pytest.raises(NotImplementedError, match=value.split(".")[-1]):
        ContivAgent(AgentConfig.from_dict(dict({"serve_http": True}, **cfg)),
                    store=store, **kw)
    assert store.revision == 0 and store.dump()["data"] == {}
    assert threading.active_count() == threads


def test_no_citation_of_a_done_roadmap_item():
    """Every ``Queue 1 item N`` the package cites is still open in
    ROADMAP.md: a ported item leaves no refusal (or stale pointer)
    behind."""
    titles = _queue1_titles()
    for path in PORT_FILES:
        for n in re.findall(r"Queue 1 item (\d+)", path.read_text()):
            assert int(n) in titles, (str(path.relative_to(ROOT)), n)


def test_default_config_constructs():
    """The reference's defaults (``fastpath=True``, ``classifier:
    auto``) and the MXU knob construct and engage the fast path; on an
    empty table ``auto`` stays dense and ``mxu`` is eligible."""
    for knob, impl in (("auto", "dense"), ("mxu", "mxu")):
        dp = tdp.Dataplane(ttables.DataplaneConfig(classifier=knob),
                           device="cpu")
        assert dp._use_fastpath
        assert dp.classifier_impl == impl


def test_cpu_runs_never_launch_a_kernel():
    """The fused-kernel rungs on CPU tensors take the plain versions."""
    wrappers = (tsess.sess_probe_ways, tbv.bv_first_set,
                tlpm.lpm_fused_lookup, tmxu.mxu_first_match)
    before = tuple(w.launches for w in wrappers)
    cfg = ttables.DataplaneConfig(**dict(
        _SMALL, classifier="pallas", fib_impl="pallas",
        session_impl="pallas"))
    dp = tdp.Dataplane(cfg, device="cpu")
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("ns", "p"))
    dp.builder.add_route("10.1.1.0/24", pod, tvector.Disposition.LOCAL)
    dp.builder.add_route("0.0.0.0/0", up, tvector.Disposition.REMOTE)
    dp.swap()
    pkts = tvector.make_packet_vector(
        [dict(src="192.0.2.1", dst="10.1.1.7", sport=40000, dport=80,
              rx_if=up)], n=8)
    res = dp.process(pkts, now=10)
    assert int(res.stats.tx) == 1
    # the same wrappers called directly on CPU tensors
    t = dp.tables
    hdr = pkts.five_tuple
    tsess.sess_probe_ways(*hdr, t.sess_valid, t.sess_src, t.sess_dst,
                          t.sess_ports, t.sess_proto, t.sess_time, 10,
                          t.sess_max_age)
    tlpm.lpm_fused_lookup(pkts.dst_ip, t.fib_lpm_lens, t.fib_lpm_stk_cnt,
                          t.fib_lpm_stk_pfx, t.fib_lpm_stk_slot)
    tbv.bv_first_set(*hdr, *tbv._glb_args(t))
    tbv.bv_first_set(*hdr, *tbv._acl_args(t), pkts.rx_if, t.if_local_table)
    tmxu.mxu_first_match(pkts.src_ip, pkts.dst_ip, pkts.proto, pkts.sport,
                         pkts.dport, t.glb_mxu_op)
    after = tuple(w.launches for w in wrappers)
    assert after == before == (0, 0, 0, 0)


@pytest.mark.parametrize("kernel", ["mxu_first_match", "lpm_fused_lookup",
                                    "sess_probe_ways", "bv_first_set"])
def test_kernel_probe_variants_apply_to_the_sources(kernel):
    """``kernel_probe``'s cut variants still find the text they replace
    in the kernel source, each exactly once, and change it."""
    from vpp_tpu_torch import kernel_probe
    from vpp_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / kernel_probe.VARIANTS[kernel][0]).read_text()
    variants = kernel_probe.variant_sources(kernel)
    assert len(variants) >= 3
    assert all(text != src for text in variants.values())


def test_kernel_argument_checks_refuse_what_the_kernels_do_not_take():
    """The wrapper-side checks that run on this machine: a CPU tensor is
    refused before any pointer reaches a kernel, and a nonzero CUDA
    error code from a C entry raises."""
    from vpp_tpu_torch.ops import _cuda

    t = torch.zeros(4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _cuda.require(t, "x")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _cuda.check(9, "kernel")
    _cuda.check(0, "kernel")
    assert not _cuda.use_kernels(t)
    # the source digest covers every kernel source and the flags
    assert len(_cuda._digest()) == 16
    assert {p.name for p in _cuda._sources()} == {
        "sess_probe.cu", "bv_first_set.cu", "lpm_lookup.cu",
        "mxu_first_match.cu", "ml_score.cu"}


def _c_params(entry: str):
    """The ctypes types of a C entry's parameters, read from
    csrc/kernels.cuh (pointers and the stream: c_void_p; int32_t:
    c_int32)."""
    import ctypes

    from vpp_tpu_torch.ops import _cuda

    text = (_cuda.CSRC / "kernels.cuh").read_text()
    decl = re.search(rf"int {entry}\((.*?)\);", text, re.S).group(1)
    return [ctypes.c_void_p if "*" in p else ctypes.c_int32
            for p in decl.split(",")]


@pytest.mark.parametrize("entry", ["sess_probe_ways", "bv_first_set"])
def test_launch_arguments_match_the_c_declarations(entry, monkeypatch):
    """The argument types a wrapper hands ctypes are the C entry's, in
    its order, and the arguments it builds (on CPU tensors, with the
    CUDA-only checks lifted) pass through a ctypes function of those
    types: the shape integers land in their places."""
    import ctypes

    from vpp_tpu_torch.ops import _cuda

    argtypes = (tsess.SESS_ARGTYPES if entry == "sess_probe_ways"
                else tbv.BV_ARGTYPES)
    assert argtypes == _c_params(entry)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    cfg = ttables.DataplaneConfig(**dict(_SMALL, classifier="pallas"))
    dp = tdp.Dataplane(cfg, device="cpu")
    pkts = tvector.make_packet_vector([], n=8)
    hdr = pkts.five_tuple
    t = dp.tables
    got = []
    fn = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(
        lambda *a: got.append(a) or 0)
    if entry == "sess_probe_ways":
        args, (found, slot) = tsess.sess_launch_args(
            *hdr, *tsess._columns(t), 10, 3000, True)
        assert found.dtype == torch.bool and slot.dtype == torch.int32
        fn(*args, 0)
        nb, ways = t.sess_valid.shape
        # sym, the null tenant slice (kt, base, mask), then p,
        # n_buckets, ways, vec4, and the null now and max_age pointers,
        # each followed by its value
        assert got[0][5:9] == (1, None, None, None)
        assert got[0][15:23] == (8, nb, ways, int(ways == 4), None, 10,
                                 None, 3000)
        # the device scalars and the tenant slice go by pointer (a
        # captured step reads them)
        now = torch.tensor(10, dtype=torch.int32)
        kt = torch.zeros(8, dtype=torch.int32)
        tnt = (kt, t.tnt_sess_base, t.tnt_sess_mask)
        args, _ = tsess.sess_launch_args(*hdr, *tsess._columns(t), now,
                                         t.sess_max_age, True, tnt)
        fn(*args, 0)
        assert got[1][6:9] == tuple(x.data_ptr() for x in tnt)
        assert got[1][19:23] == (now.data_ptr(), 0,
                                 t.sess_max_age.data_ptr(), 0)
        with pytest.raises(ValueError, match="tenant slice"):
            tsess.sess_launch_args(*hdr, *tsess._columns(t), now, 3000,
                                   False, (kt[:4], *tnt[1:]))
    else:
        for local in (False, True):
            extra = (pkts.rx_if, t.if_local_table) if local else ()
            args, out = tbv.bv_launch_args(
                *hdr, *(tbv._acl_args(t) if local else tbv._glb_args(t)),
                *extra)
            fn(*args, 0)
            planes = t.acl_bv_src if local else t.glb_bv_src[None]
            n_t, n_int, words = planes.shape
            assert got[-1][17:24] == (
                8, n_t, n_int, 256, words,
                t.if_local_table.shape[0] if local else 0,
                int(words % 4 == 0))
            assert (got[-1][15] is None) != local
            assert isinstance(out, tuple) == local


def test_step_pairs_alternates_sides_and_counts_wins(monkeypatch, capsys):
    """``step_pairs`` alternates which checkout runs first, and its
    summary counts the pairs each side won per cell (ties for
    neither); the run snippet it hands each checkout compiles."""
    import json

    from vpp_tpu_torch import step_pairs

    compile(step_pairs._RUN.replace("STEPS", "3"), "<run>", "exec")
    calls = []
    fake = {"this": [5.0, 3.0, 4.0, 2.0], "other": [4.0, 4.0, 4.0, 4.0]}

    def run(root, steps):
        side = "this" if root == step_pairs.Path.cwd() else "other"
        calls.append(side)
        return {"cell": fake[side][sum(c == side for c in calls) - 1]}

    monkeypatch.setattr(step_pairs, "run", run)
    assert step_pairs.main(["/nonexistent", "--pairs", "4"]) == 0
    assert calls == ["other", "this", "this", "other"] * 2
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cell = out["summary"]["cell"]
    assert (cell["this_won"], cell["other_won"]) == (2, 1)
    assert cell["this_ms"] == 3.5 and cell["other_ms"] == 4.0


def test_swap_pairs_alternates_sides(monkeypatch, capsys):
    """``swap_pairs`` alternates which checkout runs first and hands each
    a run snippet that compiles; its summary is ``step_pairs``'."""
    import json

    from vpp_tpu_torch import swap_pairs

    compile(swap_pairs._RUN.replace("REPS", "3"), "<run>", "exec")
    calls = []

    def run(root, reps):
        calls.append("this" if root == swap_pairs.Path.cwd() else "other")
        return {"mxu (a) host": 1.0 if calls[-1] == "this" else 2.0}

    monkeypatch.setattr(swap_pairs, "run", run)
    assert swap_pairs.main(["/nonexistent", "--pairs", "2"]) == 0
    assert calls == ["other", "this", "this", "other"]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["summary"]["mxu (a) host"]["this_won"] == 2


@pytest.mark.parametrize("kind", ["mlp", "forest"])
def test_ml_launch_arguments_match_the_c_declaration(kind, monkeypatch):
    """``ML_ARGTYPES`` is csrc/ml_score.cu's C entry, in its order; the
    arguments ``ml_launch_args`` builds (on CPU tensors, the CUDA-only
    checks lifted) pass through a ctypes function of those types with
    the shape integers in their places and every model value and policy
    scalar by pointer (a captured step reads the values of the day)."""
    import ctypes

    from vpp_tpu_torch.ops import _cuda

    assert tml.ML_ARGTYPES == _c_params("ml_score")
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    cfg = ttables.DataplaneConfig(**dict(
        _SMALL, ml_stage="enforce", ml_hidden=5, ml_trees=3, ml_depth=2,
        tenancy="on"))
    t = tdp.Dataplane(cfg, device="cpu").tables
    pkts = tvector.make_packet_vector([], n=8)
    got = []
    fn = ctypes.CFUNCTYPE(ctypes.c_int, *tml.ML_ARGTYPES)(
        lambda *a: got.append(a) or 0)
    valid = pkts.valid
    args, (scores, flagged, drop) = tml.ml_launch_args(
        t, pkts, valid, valid, pkts.proto, kind)
    fn(*args, 0)
    smem = tml.ml_smem_bytes(kind, 5, 3, 2)
    assert smem == (4 * (18 * 5 + 10) if kind == "mlp"
                    else 4 * (2 * 3 * 2 + 3 * 4))
    assert got[0][24:30] == (8, 1 if kind == "mlp" else 2, 5, 3, 2, smem)
    planes = ("glb_ml_w1", "glb_ml_b1", "glb_ml_s1", "glb_ml_w2",
              "glb_ml_b2", "glb_ml_f_feat", "glb_ml_f_thresh",
              "glb_ml_f_leaf", "glb_ml_thresh", "glb_ml_action",
              "glb_ml_rl_shift")
    assert got[0][10:21] == tuple(getattr(t, f).data_ptr() for f in planes)
    # no tid: three null pointers (the global policy)
    assert got[0][21:24] == (None, None, None)
    assert got[0][30:33] == (scores.data_ptr(), flagged.data_ptr(),
                             drop.data_ptr())
    # the tenant form: tid and the per-tenant vectors by pointer (a
    # set_tenant_ml swap writes them in place)
    tid = torch.zeros(8, dtype=torch.int32)
    args, _ = tml.ml_launch_args(t, pkts, valid, valid, pkts.proto, kind,
                                 tid=tid)
    fn(*args, 0)
    assert got[1][21:24] == (tid.data_ptr(), t.glb_ml_tnt_mode.data_ptr(),
                             t.glb_ml_tnt_thresh.data_ptr())
    with pytest.raises(ValueError, match="tenant vector"):
        tml.ml_launch_args(t, pkts, valid, valid, pkts.proto, kind,
                           tid=tid[:3])
    assert (scores.dtype, flagged.dtype, drop.dtype) == (
        torch.int32, torch.bool, torch.bool)
    with pytest.raises(ValueError, match="unknown ML kind"):
        tml.ml_launch_args(t, pkts, valid, valid, pkts.proto, "tree")
    # a model too wide for a block's shared memory is refused
    wide = t._replace(glb_ml_w1=torch.zeros(18, 3000, dtype=torch.int8),
                      glb_ml_b1=torch.zeros(3000, dtype=torch.int32),
                      glb_ml_w2=torch.zeros(3000, dtype=torch.int8))
    with pytest.raises(ValueError, match="shared memory"):
        tml.ml_launch_args(wide, pkts, valid, valid, pkts.proto, "mlp")


def test_packaging_names_the_port():
    """pyproject.toml ships the port's kernel and native sources and
    names its node processes; each console script resolves to a
    callable entry point."""
    import fnmatch
    import importlib
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["vpp_tpu_torch"]
    pkg = ROOT / "vpp_tpu_torch"
    sources = [p.relative_to(pkg).as_posix() for p in
               sorted(pkg.glob("csrc/*.cu*")) + sorted(pkg.glob("native/*.cpp"))]
    assert {"native/frame_ring.cpp", "native/pkt_io.cpp"} <= set(sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in globs), src
    scripts = {k: v for k, v in cfg["project"]["scripts"].items()
               if v.startswith("vpp_tpu_torch.")}
    assert set(scripts) == {"vpp-tpu-torch-agent", "vpp-tpu-torch-ksr",
                            "vpp-tpu-torch-cni", "vpp-tpu-torch-kvstore",
                            "vpp-tpu-torch-kvwitness", "vpp-tpu-torch-ctl",
                            "vpp-tpu-torch-ml-train", "vpp-tpu-torch-io",
                            "vpp-tpu-torch-init"}
    for target in scripts.values():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn))
