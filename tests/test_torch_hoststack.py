"""The VCL host stack: vpp_tpu_torch/hoststack vs vpp_tpu/hoststack.

* The reference's own suites run as written on the port
  (``port_globals`` / ``port_imports`` of ``tests/test_torch_agent.py``:
  the test module's names, the imports its functions make and its
  fixtures are bound to the port, the session-rule engine and the agent
  to the CPU; string constants naming ``vpp_tpu.`` modules name the
  port's, so child processes run the port too):
  ``tests/test_vcl.py`` (the filtered socket), ``test_vcl_preload.py``
  (the LD_PRELOAD shim in real subprocesses against the admission
  server, the shim built from the port's own ``native/vcl_preload.c``),
  ``test_ldpreload_inject.py`` (the manifest injector),
  ``test_scenarios.py`` (the agent scenarios) and
  ``test_proxy_chain_e2e.py`` (a client, a proxy and a backend under
  the fail-closed shim, behind the 996-rule filler).
* A differential: the reference's ``VclAdmissionServer`` and the
  port's, each over its own package's engine with the same seeded
  rules, answer the same seeded stream of wire requests byte for byte,
  and end with the same counters.

Every quantity compared is a verdict byte, an integer or a string: the
tolerance is exact equality.
"""

from __future__ import annotations

import inspect
import json
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest

# the reference suites and every reference module they reach, imported
# here, outside any ``port_imports`` block (which drops the reference
# modules first imported inside it)
import test_ldpreload_inject as jinject_tests
import test_proxy_chain_e2e as jchain_tests
import test_scenarios as jscen_tests
import test_vcl as jvcl_tests
import test_vcl_preload as jpreload_tests
import vpp_tpu.cmd.ldpreload_inject  # noqa: F401
import vpp_tpu.hoststack.admission  # noqa: F401
import vpp_tpu.hoststack.preload  # noqa: F401
import vpp_tpu.hoststack.scenarios  # noqa: F401
import vpp_tpu.hoststack.vcl  # noqa: F401
from test_torch_agent import case_names, port_globals, port_imports
from test_torch_kvserver import _port_strings, _port_text
from vpp_tpu.hoststack import admission as jadm
from vpp_tpu.hoststack import session_rules as jsr
from vpp_tpu_torch.hoststack import admission as tadm
from vpp_tpu_torch.hoststack import preload as tpreload
from vpp_tpu_torch.hoststack import scenarios as tscen
from vpp_tpu_torch.hoststack import session_rules as tsr


def _ref_fixture_fn(module, name: str, g: dict) -> types.FunctionType:
    """The reference fixture ``name`` of ``module`` as a plain function
    over the port-bound globals ``g``."""
    f = getattr(module, name).__wrapped__
    return _port_strings(types.FunctionType(
        f.__code__, g, f.__name__, f.__defaults__, f.__closure__))


def _port_bound(module, names=None) -> dict:
    g = port_globals(module)
    g.update(names or {})
    for k, v in list(g.items()):
        if k.isupper() and isinstance(v, str):
            g[k] = _port_text(v)  # child-process scripts
    return g


# source ports two reference cases bind by number (test_vcl.py's
# accept wave binds 39991 without SO_REUSEADDR and leaves it in
# TIME_WAIT; test_vcl_preload.py's denied peer binds 23001). Their runs
# on the port bind a port the kernel hands out instead, so that neither
# copy can find the other's port taken when the two suites run side by
# side in parallel workers.
FIXED_SOURCE_PORTS = (39991, 23001)


def _fresh_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _int_consts(consts) -> set:
    out = set()
    for c in consts:
        if type(c) is tuple:
            out |= _int_consts(c)
        elif type(c) is int:
            out.add(c)
    return out


def _fresh_ports(fn: types.FunctionType) -> types.FunctionType:
    """``fn`` with each of ``FIXED_SOURCE_PORTS`` among its constants
    replaced by a port the kernel hands out."""
    code = fn.__code__
    if not set(FIXED_SOURCE_PORTS) & _int_consts(code.co_consts):
        return fn
    subs = {p: _fresh_port() for p in FIXED_SOURCE_PORTS}

    def sub(c):
        if type(c) is tuple:  # a folded literal such as ("127.0.0.1", p)
            return tuple(sub(x) for x in c)
        return subs.get(c, c) if type(c) is int else c

    consts = tuple(sub(c) for c in code.co_consts)
    out = types.FunctionType(code.replace(co_consts=consts), fn.__globals__,
                             fn.__name__, fn.__defaults__, fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def run_case(module, name: str, request, fixtures=None, names=None,
             params=None):
    """Run the reference case ``name`` (a function, or ``Class.method``
    with its ``setup_method`` / ``teardown_method``) of ``module`` on
    the port. ``fixtures`` maps a reference fixture name to the port
    fixture standing in for it (others are pytest's own), ``names``
    replace module globals after the binding (a ``jnp`` that reads the
    port's tensors, a port driver for a reference helper), ``params``
    are a parametrised case's arguments."""
    fixtures = fixtures or {}
    params = params or {}
    g = _port_bound(module, names)
    with port_imports():
        if "." in name:
            cls, meth = name.split(".")
            obj = g[cls]()
            fn = _fresh_ports(_port_strings(vars(g[cls])[meth]))
            args = {p: request.getfixturevalue(fixtures.get(p, p))
                    for p in list(inspect.signature(fn).parameters)[1:]
                    if p not in params}
            setup = getattr(obj, "setup_method", None)
            if setup is not None:
                setup(fn)
            try:
                return fn(obj, **args, **params)
            finally:
                teardown = getattr(obj, "teardown_method", None)
                if teardown is not None:
                    teardown(fn)
        fn = _fresh_ports(_port_strings(g[name]))
        args = {p: request.getfixturevalue(fixtures.get(p, p))
                for p in inspect.signature(fn).parameters
                if p not in params}
        return fn(**args, **params)


def _fixture_from(module, name: str):
    """A pytest fixture body running the reference fixture ``name`` of
    ``module`` on the port (its generator driven inside
    ``port_imports``)."""
    def body(request):
        fn = _ref_fixture_fn(module, name, _port_bound(module))
        args = [request.getfixturevalue(p)
                for p in inspect.signature(fn).parameters]
        gen = fn(*args)
        with port_imports():
            value = next(gen)
        yield value
        with port_imports():
            try:
                next(gen)
            except StopIteration:
                pass
    return body


port_admission = pytest.fixture()(_fixture_from(jpreload_tests, "admission"))
port_listener = pytest.fixture()(_fixture_from(jpreload_tests, "listener"))
port_mesh = pytest.fixture(scope="module")(
    _fixture_from(jchain_tests, "mesh"))


# --- the reference suites on the port -----------------------------------

VCL_CASES = case_names(jvcl_tests)
PRELOAD_CASES = case_names(jpreload_tests)
INJECT_CASES = case_names(jinject_tests)
SCENARIO_CASES = case_names(jscen_tests)
CHAIN_CASES = case_names(jchain_tests)


def test_case_lists():
    """Every case of the five reference suites runs here (32 in all)."""
    assert (len(VCL_CASES), len(PRELOAD_CASES), len(INJECT_CASES),
            len(SCENARIO_CASES), len(CHAIN_CASES)) == (5, 11, 6, 7, 3)


def test_fixed_source_ports_are_the_references():
    """The two cases that bind a source port by number still do, and
    their runs here bind another."""
    for module, case in ((jvcl_tests, "test_accept_batch_mixed_verdicts"),
                         (jpreload_tests,
                          "test_nonblocking_accept_skips_denied_backlog")):
        fn = vars(module)[case]
        assert set(FIXED_SOURCE_PORTS) & _int_consts(fn.__code__.co_consts)
        assert not set(FIXED_SOURCE_PORTS) & _int_consts(
            _fresh_ports(fn).__code__.co_consts)


@pytest.mark.parametrize("case", VCL_CASES)
def test_reference_vcl_cases(case, request):
    run_case(jvcl_tests, case, request)


@pytest.mark.parametrize("case", PRELOAD_CASES)
def test_reference_vcl_preload_cases(case, request):
    run_case(jpreload_tests, case, request,
             {"admission": "port_admission", "listener": "port_listener"})


@pytest.mark.parametrize("case", INJECT_CASES)
def test_reference_ldpreload_inject_cases(case, request):
    run_case(jinject_tests, case, request)


@pytest.mark.parametrize("case", SCENARIO_CASES)
def test_reference_scenario_cases(case, request):
    run_case(jscen_tests, case, request)


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_reference_proxy_chain_cases(case, request):
    run_case(jchain_tests, case, request, {"mesh": "port_mesh"})


# --- the port's own files ------------------------------------------------

def test_shim_builds_into_the_ports_tree():
    """The shim is built from the port's own source into the port's
    build directory, never the reference's."""
    lib = tpreload.shim_path()
    port_native = os.path.dirname(tpreload._SRC)
    assert tpreload._SRC.endswith(os.path.join(
        "vpp_tpu_torch", "native", "vcl_preload.c"))
    assert os.path.dirname(lib).startswith(port_native)
    env = tpreload.vcl_env("/x.sock", appns_index=3, fail_closed=True,
                           base={"LD_PRELOAD": "/a.so"})
    assert env["LD_PRELOAD"] == f"/a.so:{lib}"
    assert (env["VPP_TPU_VCL_SOCK"], env["VPP_TPU_APPNS"],
            env["VPP_TPU_VCL_FAILCLOSED"]) == ("/x.sock", "3", "1")


def test_scenario_rules_equal_the_references():
    """``gen_policy_filler`` and ``proxy_chain_rules`` build the
    reference's rules, field for field."""
    from vpp_tpu.hoststack import scenarios as jscen

    assert [tuple(r) for r in tscen.gen_policy_filler(996)] == \
        [tuple(r) for r in jscen.gen_policy_filler(996)]
    args = (0x7F000001, 1, 2, 15000, 15001)
    assert [tuple(r) for r in tscen.proxy_chain_rules(*args)] == \
        [tuple(r) for r in jscen.proxy_chain_rules(*args)]


def test_injector_reads_json_without_yaml(tmp_path):
    """A JSON manifest goes through the injector in a process where
    PyYAML cannot be imported, and comes back as JSON with the
    injection the YAML path makes."""
    doc = {"apiVersion": "v1", "kind": "Pod",
           "spec": {"containers": [{"name": "app", "image": "alpine"}]}}
    src = tmp_path / "pod.json"
    src.write_text(json.dumps([doc]))
    out = tmp_path / "out.json"
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from vpp_tpu_torch.cmd import ldpreload_inject as m\n"
            f"sys.exit(m.main([{str(src)!r}, '-o', {str(out)!r}, "
            "'--appns', '7']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(out.read_text())
    want = [json.loads(json.dumps(doc))]
    jinject = sys.modules["vpp_tpu.cmd.ldpreload_inject"]
    jinject.inject_documents(want, "/run/vpp-tpu/vcl.sock",
                             "/opt/vpp-tpu/lib", 7, False)
    assert got == want


# --- the differential: the two admission servers, one request stream ----

def _seeded_rules(rs: np.random.Generator, sr, n: int) -> list:
    """``n`` LOCAL and GLOBAL rules over a few namespaces, ports and
    prefixes (both actions), as one package's ``SessionRule``s."""
    out = []
    for _ in range(n):
        scope = int(rs.integers(1, 3))
        plen = int(rs.choice([0, 8, 16, 24, 32]))
        net = int(rs.integers(0, 1 << 32)) & sr._mask_of(plen)
        out.append(sr.SessionRule(
            scope=scope,
            appns_index=int(rs.integers(0, 4)) if scope == 1 else -1,
            transport_proto=int(rs.choice([6, 17])),
            lcl_net=net if scope == 2 else 0, lcl_plen=plen if scope == 2
            else 0, rmt_net=net if scope == 1 else 0,
            rmt_plen=plen if scope == 1 else 0,
            lcl_port=int(rs.choice([0, 80, 443])),
            rmt_port=int(rs.choice([0, 53, 8080])),
            action=int(rs.integers(0, 2))))
    return out


def _seeded_requests(rs: np.random.Generator, n: int) -> list:
    reqs = []
    for _ in range(n):
        op = int(rs.choice([jadm.OP_CONNECT, jadm.OP_ACCEPT,
                            ord("X")], p=[0.6, 0.35, 0.05]))
        reqs.append(jadm._REQ.pack(
            op, int(rs.choice([6, 17])), 0, int(rs.integers(0, 4)),
            int(rs.integers(0, 1 << 32)), int(rs.integers(0, 1 << 32)),
            int(rs.choice([0, 80, 443, 1234])),
            int(rs.choice([0, 53, 8080, 9999]))))
    return reqs


def _ask(path: str, reqs: list) -> bytes:
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(30)
    c.connect(path)
    out = b""
    try:
        for r in reqs:
            c.sendall(r)
            out += c.recv(1)
    finally:
        c.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_servers_answer_alike(seed, tmp_path):
    """The same seeded rules and wire requests through the reference's
    ``VclAdmissionServer`` and the port's: every verdict byte and every
    counter is equal."""
    servers = {}
    try:
        for name, sr, adm, kw in (("ref", jsr, jadm, {}),
                                  ("port", tsr, tadm, {"device": "cpu"})):
            engine = sr.SessionRuleEngine(capacity=256, **kw)
            engine.apply(add=_seeded_rules(np.random.default_rng(seed),
                                           sr, 200))
            servers[name] = adm.VclAdmissionServer(
                engine, str(tmp_path / f"{name}.sock")).start()
        reqs = _seeded_requests(np.random.default_rng(seed + 100), 400)
        answers = {n: _ask(s.path, reqs) for n, s in servers.items()}
        assert answers["ref"] == answers["port"]
        assert 0 < answers["port"].count(b"\x00") < len(reqs)
        deadline = time.monotonic() + 30
        while any(s.stats["clients"] for s in servers.values()):
            assert time.monotonic() < deadline  # the EOF reaches both
            time.sleep(0.01)
        stats = {n: dict(s.stats) for n, s in servers.items()}
        assert stats["ref"] == stats["port"]
    finally:
        for s in servers.values():
            s.stop()
