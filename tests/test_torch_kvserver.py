"""The served KV store: vpp_tpu_torch's KVServer / RemoteKVStore /
Replicator vs vpp_tpu's.

* The reference's own cases (``tests/test_kvserver.py``) run as written
  on the port: ``run_port_case`` rebinds the test module's names to the
  port (``test_torch_agent.port_globals``), maps the imports a case
  makes in its body onto the port's modules (``port_imports``), hands
  it the port's fixtures, and rewrites the module paths in its string
  constants (the child processes it spawns run the port too).
* Cross-package wire cases: a port client against a reference server
  and a reference client against a port server, with put, get, CAS,
  leases and watch-with-snapshot, give the event stream and the replies
  of the same client against its own package's server. A server's
  persisted file loads in the other package's server.

Every quantity compared is a key, a value, a revision, an operation or
a boolean: the tolerance is exact equality.
"""

from __future__ import annotations

import inspect
import queue
import re
import time
import types

import pytest

import test_kvserver as jkv_tests
from test_torch_agent import case_names, port_globals, port_imports
from vpp_tpu.kvstore import client as jclient
from vpp_tpu.kvstore import server as jserver
from vpp_tpu.kvstore import store as jstore
from vpp_tpu_torch.kvstore import client as tclient
from vpp_tpu_torch.kvstore import server as tserver
from vpp_tpu_torch.kvstore import store as tstore

_REF_PATH = re.compile(r"\bvpp_tpu\.")


def _port_text(s: str) -> str:
    return _REF_PATH.sub("vpp_tpu_torch.", s)


def _port_code(code: types.CodeType) -> types.CodeType:
    """``code`` with every string constant naming a ``vpp_tpu.`` module
    renamed to the port's (nested code objects too)."""
    return code.replace(co_consts=tuple(
        _port_code(c) if isinstance(c, types.CodeType)
        else _port_text(c) if isinstance(c, str) else c
        for c in code.co_consts))


def _port_strings(f: types.FunctionType) -> types.FunctionType:
    out = types.FunctionType(_port_code(f.__code__), f.__globals__,
                             f.__name__, f.__defaults__, f.__closure__)
    out.__kwdefaults__ = f.__kwdefaults__
    return out


# a reference fixture name -> the port's fixture that stands in for it
FIXTURES = {"server": "port_kv_server", "client": "port_kv_client",
            "tmp_path": "tmp_path", "capsys": "capsys",
            "fake_k8s": "fake_k8s"}


def run_port_case(module, name: str, request, wrap=None):
    """Run the reference case ``name`` (a function, or ``Class.method``)
    of ``module`` on the port, its fixtures taken from ``FIXTURES`` and
    its module-level and in-body strings naming the port's modules."""
    g = port_globals(module, wrap)
    for k, v in list(g.items()):
        if k.isupper() and isinstance(v, str):
            g[k] = _port_text(v)  # child-process scripts
    with port_imports():
        if "." in name:
            cls, meth = name.split(".")
            fn = _port_strings(vars(g[cls])[meth])
            args = [g[cls]()]
        else:
            fn = _port_strings(g[name])
            args = []
        params = list(inspect.signature(fn).parameters)[len(args):]
        args += [request.getfixturevalue(FIXTURES[p]) for p in params]
        return fn(*args)


@pytest.fixture()
def port_kv_server():
    srv = tserver.KVServer(host="127.0.0.1", port=0).start()
    yield srv
    srv.close()


@pytest.fixture()
def port_kv_client(port_kv_server):
    c = tclient.RemoteKVStore("127.0.0.1", port_kv_server.port,
                              request_timeout=5.0)
    yield c
    c.close()


KV_CASES = case_names(jkv_tests)


def test_kvserver_case_list():
    """Every case of tests/test_kvserver.py runs here."""
    assert len(KV_CASES) == 25


@pytest.mark.parametrize("case", KV_CASES)
def test_reference_kvserver_cases(case, request):
    run_port_case(jkv_tests, case, request)


# --- across packages ---------------------------------------------------

PACKAGES = {"ref": (jserver, jclient, jstore),
            "port": (tserver, tclient, tstore)}


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError("timed out")


def _session(server_pkg: str, client_pkg: str) -> dict:
    """One client of ``client_pkg`` against a server of ``server_pkg``:
    the replies to a fixed sequence of operations and the events of a
    watch-with-snapshot and a plain watch over it."""
    srv_mod, _, store_mod = PACKAGES[server_pkg]
    cli_mod = PACKAGES[client_pkg][1]
    store = store_mod.KVStore()
    store.put("cfg/pre", {"a": 1})
    srv = srv_mod.KVServer(store=store, host="127.0.0.1", port=0).start()
    c = cli_mod.RemoteKVStore("127.0.0.1", srv.port, request_timeout=5.0)
    events, plain = queue.Queue(), queue.Queue()
    out = {}
    try:
        snap, rev, cancel = c.watch_with_snapshot("cfg/", events.put)
        out["snapshot"] = (snap, rev)
        c.watch("live/", plain.put)
        replies = [
            c.put("cfg/a", [1, 2, {"x": "y"}]),
            c.get("cfg/a"),
            c.compare_and_put("cfg/a", [1, 2, {"x": "y"}], "b"),
            c.compare_and_put("cfg/a", "nope", "c"),
            c.compare_and_put("cfg/new", None, 7),
            c.compare_and_delete("cfg/new", 8),
            c.compare_and_delete("cfg/new", 7),
            c.delete("cfg/pre"),
            c.delete("cfg/absent"),
            c.list_values("cfg/"),
            c.list_keys(""),
            c.revision,
            c.ping(),
        ]
        lease = c.lease_grant(30.0)
        replies += [
            c.put("live/n1", {"ip": "10.0.0.1"}, lease=lease),
            c.lease_keepalive(lease),
            c.lease_revoke(lease),
            c.get("live/n1"),
            c.lease_keepalive(lease),
        ]
        with pytest.raises(RuntimeError):
            c.put("live/n2", 1, lease=lease + 1000)
        out["replies"] = replies
        _wait(lambda: events.qsize() >= 5 and plain.qsize() >= 2)
        cancel()
        for name, q in (("events", events), ("plain", plain)):
            out[name] = [(ev.op.name, ev.key, ev.value, ev.prev_value,
                          ev.rev)
                         for ev in (q.get_nowait()
                                    for _ in range(q.qsize()))]
        out["dump"] = store.dump()["data"]
    finally:
        c.close()
        srv.close()
    return out


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("ref", "port"), ("port", "ref"), ("port", "port")],
    ids=["port-client-ref-server", "ref-client-port-server", "port-port"])
def test_wire_interoperates_across_packages(server_pkg, client_pkg):
    """The same operations give the same replies, snapshot, event
    stream and server state whichever package serves and whichever
    package asks (the reference client against the reference server is
    the oracle)."""
    assert _session(server_pkg, client_pkg) == _session("ref", "ref")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_persisted_file_loads_in_the_other_package(writer, tmp_path):
    """A server's persisted store file boots the other package's server
    with the same keys, values and revision, and its clients read it."""
    reader = "port" if writer == "ref" else "ref"
    path = str(tmp_path / "kv.json")
    srv_mod, cli_mod, _ = PACKAGES[writer]
    srv = srv_mod.KVServer(host="127.0.0.1", port=0,
                           persist_path=path).start()
    c = cli_mod.RemoteKVStore("127.0.0.1", srv.port, request_timeout=5.0)
    try:
        c.put("ksr/k8s/pod/a/namespace/default", {"ip": "10.1.1.2"})
        c.put("ids/7", "node-7")
        c.compare_and_put("ids/8", None, "node-8")
        c.delete("ids/7")
        c.save()
        dump = srv.store.dump()
    finally:
        c.close()
        srv.close()
    srv_mod, cli_mod, _ = PACKAGES[reader]
    srv = srv_mod.KVServer(host="127.0.0.1", port=0,
                           persist_path=path).start()
    c = cli_mod.RemoteKVStore("127.0.0.1", srv.port, request_timeout=5.0)
    try:
        assert srv.store.dump()["data"] == dump["data"]
        assert c.revision == srv.store.revision == dump["rev"]
        assert c.list_values("") == dump["data"]
    finally:
        c.close()
        srv.close()


def test_connect_store_speaks_tcp():
    """``connect_store`` builds a ``RemoteKVStore`` for a ``tcp://``
    URL, one endpoint or a primary with standbys, as the reference's."""
    srv = tserver.KVServer(host="127.0.0.1", port=0).start()
    try:
        c = tclient.connect_store(
            f"tcp://127.0.0.1:{srv.port},127.0.0.1:1")
        try:
            assert isinstance(c, tclient.RemoteKVStore)
            assert c.endpoints == [("127.0.0.1", srv.port),
                                   ("127.0.0.1", 1)]
            assert c.ping()
        finally:
            c.close()
        with pytest.raises(ValueError):
            tclient.connect_store("tcp://nohost")
    finally:
        srv.close()
