"""vpp-tpu-torch-init: the port's InitSupervisor against the reference's
tests.

* Every case of tests/test_init.py runs as written on the port through
  ``test_torch_kvserver.run_port_case``, its strings (the case's and
  its fake spawner's) naming the port's modules: the boot sequence (the
  agent, then its plan file, then the IO daemon from the plan), the
  plan timeout, supervision (an agent death restarts the daemon too, a
  daemon death restarts that daemon alone, from its plan) and the
  reverse-order teardown, and the uplink pre-configuration, and the
  single-host mesh cases (the mesh agent, one daemon per node plan).
  The multi-host case (``mesh.coordinator``) must raise the port's
  refusal naming its ROADMAP item: the multi-host mesh is not ported.
* The argv the supervisor spawns is the reference's with each module
  renamed to the port's, and names no reference module.

Every quantity compared is a string or an integer: the tolerance is
exact equality.
"""

from __future__ import annotations

import types

import pytest

import test_init as jinit_tests
from test_torch_agent import case_names
from test_torch_kvserver import _port_strings, run_port_case

from vpp_tpu.cmd import config as jconfig
from vpp_tpu.cmd import init_main as jinit
from vpp_tpu_torch.cmd import config as tconfig
from vpp_tpu_torch.cmd import init_main as tinit

CASES = case_names(jinit_tests)
MESH = {"TestMeshBoot.test_mesh_agent_and_per_node_io",
        "TestMeshBoot.test_one_io_death_respawns_only_it",
        "TestMeshBoot.test_mesh_agent_death_restarts_all_io",
        "test_mesh_plans_straggle_past_settle_window"}
MULTIHOST = {"test_multihost_waits_for_local_plans_only"}


def _port_class(cls):
    """A helper class of the reference's test module with the strings of
    its methods naming the port's modules."""
    ns = {k: _port_strings(v) if isinstance(v, types.FunctionType) else v
          for k, v in vars(cls).items()
          if k not in ("__dict__", "__weakref__")}
    return type(cls.__name__, cls.__bases__, ns)


def test_case_list():
    assert len(CASES) == 12 and MESH | MULTIHOST <= set(CASES)


@pytest.mark.parametrize("case", CASES)
def test_reference_init_cases(case, request):
    run = lambda: run_port_case(  # noqa: E731
        jinit_tests, case, request, wrap={"FakeSpawner": _port_class})
    if case in MULTIHOST:
        with pytest.raises(NotImplementedError) as err:
            run()
        assert "item 14 (Multi-host mesh)" in str(err.value)
    else:
        run()


def test_argv_is_the_references_with_the_port_modules(tmp_path):
    plan = {"shm": "vpp-shm", "slots": 32, "snap": 1024, "uplink_if": 63,
            "host_if": 62, "uplink_interface": "eth9", "vtep": 0xC0A81E01,
            "vni": 10, "control_socket": "/run/vpp-tpu/io-ctl.sock"}
    io = dict(enabled=True, plan_path=str(tmp_path / "plan.json"))
    ref = jinit.InitSupervisor(jconfig.AgentConfig(
        io=jconfig.IOConfig(**io)), "/etc/c.yaml", spawn=lambda a: None)
    port = tinit.InitSupervisor(tconfig.AgentConfig(
        io=tconfig.IOConfig(**io)), "/etc/c.yaml", spawn=lambda a: None)
    for argv in (ref.agent_argv(), ref.io_argv(plan)):
        assert any(a.startswith("vpp_tpu.cmd.") for a in argv)
    renamed = [[a.replace("vpp_tpu.cmd.", "vpp_tpu_torch.cmd.") for a in v]
               for v in (ref.agent_argv(), ref.io_argv(plan))]
    assert [port.agent_argv(), port.io_argv(plan)] == renamed
    assert port.agent_argv()[2] == "vpp_tpu_torch.cmd.agent"
    assert port.io_argv(plan)[2] == "vpp_tpu_torch.cmd.io_daemon"


def test_mesh_is_refused_before_anything_spawns():
    """The multi-host mesh refuses before a spawn; the single-host mesh
    spawns the port's mesh agent."""
    spawned = []
    cfg = tconfig.AgentConfig.from_dict({"mesh": {
        "nodes": 2, "coordinator": "127.0.0.1:1"}})
    with pytest.raises(NotImplementedError, match="coordinator"):
        tinit.InitSupervisor(cfg, None, spawn=spawned.append)
    assert spawned == []
    sup = tinit.InitSupervisor(tconfig.AgentConfig.from_dict(
        {"mesh": {"nodes": 2}}), None, spawn=spawned.append)
    assert sup.agent_argv()[2] == "vpp_tpu_torch.cmd.mesh_main"
