"""The Kubernetes API client: vpp_tpu_torch's K8sListWatch sources vs
vpp_tpu's.

* The reference's own cases (``tests/test_k8s_client.py``: the
  converters, list / watch / bookmark / 410 re-list-and-diff against
  its fake API server, the kubeconfig parse) run as written on the port
  through ``test_torch_kvserver.run_port_case``.
* A differential: KSR with each package's ``make_k8s_sources`` (token
  auth through a kubeconfig) is driven by the same script of lists,
  watch events, a dropped stream that must re-list and diff, and a
  clean stream end, each against a fake API server of its own; every
  key's sequence of store events, the final store, and the reflector
  counters are equal.
* The port speaks HTTP through the standard library: an AST scan finds
  no ``requests`` import in the package, and the bearer token reaches
  the server.

Every quantity compared is a key, a value, an event kind or a count:
the tolerance is exact equality.
"""

from __future__ import annotations

import ast
import copy
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

import test_k8s_client as jk8s_tests
from test_torch_agent import case_names
from test_torch_kvserver import run_port_case
from vpp_tpu.cmd import ksr_main as jksr
from vpp_tpu.ksr import k8s_client as jk8s
from vpp_tpu.kvstore import store as jstore
from vpp_tpu_torch.cmd import ksr_main as tksr
from vpp_tpu_torch.ksr import k8s_client as tk8s
from vpp_tpu_torch.kvstore import store as tstore

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def fake_k8s():
    srv = jk8s_tests.FakeK8sApiServer()
    yield srv
    srv.close()


K8S_CASES = case_names(jk8s_tests)


def test_k8s_client_case_list():
    """Every case of tests/test_k8s_client.py runs here."""
    assert len(K8S_CASES) == 13


@pytest.mark.parametrize("case", K8S_CASES)
def test_reference_k8s_client_cases(case, request):
    run_port_case(jk8s_tests, case, request)


def test_port_imports_no_requests():
    """Neither the client nor any other module of the port imports
    ``requests`` (the card's machines need not have it)."""
    from test_torch_hygiene import imported_modules

    files = sorted((ROOT / "vpp_tpu_torch").rglob("*.py"))
    assert ROOT / "vpp_tpu_torch" / "ksr" / "k8s_client.py" in files
    bad = [(str(p.relative_to(ROOT)), ln) for p in files
           for ln, m in imported_modules(p)
           if m.split(".")[0] == "requests"]
    assert bad == []
    tree = ast.parse((ROOT / "vpp_tpu_torch/ksr/k8s_client.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert {"http.client", "ssl"} <= names


def test_bearer_token_reaches_the_server(tmp_path):
    """A kubeconfig's token rides every request as ``Authorization:
    Bearer``; an error status raises with the code."""
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            seen.append((self.path, self.headers.get("Authorization")))
            code = 200 if self.path.startswith("/api/v1/pods") else 404
            body = json.dumps({"metadata": {"resourceVersion": "5"},
                               "items": []}).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        kc = _kubeconfig(tmp_path, f"http://127.0.0.1:{srv.server_port}")
        api = tk8s.K8sApi(tk8s.K8sApiConfig.from_kubeconfig(kc))
        assert api.get_list("/api/v1/pods")["items"] == []
        with pytest.raises(tk8s.K8sApiError) as err:
            api.get_list("/api/v1/none")
        assert err.value.status == 404
        assert seen == [("/api/v1/pods", "Bearer sekrit"),
                        ("/api/v1/none", "Bearer sekrit")]
    finally:
        srv.shutdown()
        srv.server_close()


# --- the differential --------------------------------------------------

def _kubeconfig(tmp_path, server: str) -> str:
    """A kubeconfig (JSON, which is YAML) with token auth."""
    cfg = {
        "current-context": "ctx",
        "contexts": [{"name": "ctx",
                      "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": server}}],
        "users": [{"name": "u", "user": {"token": "sekrit"}}],
    }
    path = tmp_path / f"kubeconfig-{server.rsplit(':', 1)[1]}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


PATHS = {t: r.path for t, r in jk8s.RESOURCES.items()}


def _pod(name: str, ip: str, labels=None) -> dict:
    return {"metadata": {"name": name, "namespace": "prod",
                         "labels": labels or {"app": name}},
            "spec": {"containers": [{"name": "c", "ports": [
                {"name": "http", "containerPort": 80}]}]},
            "status": {"podIP": ip, "hostIP": "192.168.0.11"}}


WORLD = {
    "pod": {"a": _pod("a", "10.1.1.2"), "b": _pod("b", "10.1.1.3")},
    "namespace": {"prod": {"metadata": {"name": "prod",
                                        "labels": {"env": "prod"}}}},
    "policy": {"p": jk8s_tests.POLICY_JSON},
    "service": {"s": {"metadata": {"name": "web", "namespace": "prod"},
                      "spec": {"clusterIP": "10.96.0.10",
                               "selector": {"app": "a"},
                               "ports": [{"name": "http", "port": 80,
                                          "targetPort": 8080}]}}},
    "endpoints": {"e": {"metadata": {"name": "web", "namespace": "prod"},
                        "subsets": [{"addresses": [{"ip": "10.1.1.2"}],
                                     "ports": [{"port": 8080}]}]}},
    "node": {"n": {"metadata": {"name": "node-1"},
                   "spec": {"podCIDR": "10.1.1.0/24"},
                   "status": {"addresses": [
                       {"type": "InternalIP", "address": "192.168.0.11"}]}}},
}


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError("timed out")


def _ksr_run(k8s_mod, ksr_mod, store_mod, tmp_path,
             prime: bool = False) -> dict:
    """The script, against a fake API server of its own, for one
    package's KSR: {key: [(op, value), ...]}, the final store and the
    reflector counters.

    ``prime`` lists every source once before the KSR starts. The
    reference needs it to be deterministic: unprimed, its watch threads'
    first lists dispatch adds into reflectors whose resyncs are still
    running, and each listed object is written one to three times as
    the threads happen to run (a reference fault the port does not
    copy; ``test_port_writes_each_listed_object_once``)."""
    fake = jk8s_tests.FakeK8sApiServer()
    store = store_mod.KVStore()
    log = {}
    store.watch("ksr/", lambda ev: log.setdefault(ev.key, []).append(
        (ev.op.name, ev.value)))
    for t, objs in WORLD.items():
        fake.set_objects(PATHS[t], copy.deepcopy(objs))
    sources = k8s_mod.make_k8s_sources(
        kubeconfig=_kubeconfig(tmp_path, fake.url))
    for lw in sources.values():
        lw.RECONNECT_BACKOFF = (0.05, 0.2)
    if prime:
        for lw in sources.values():
            lw.list()
    ksr = ksr_mod.KsrAgent(store=store, sources=sources, serve_http=False)
    pod = "ksr/k8s/pod/{}/namespace/prod"
    try:
        ksr.start()
        # every reflector synced, not just every key written: an event
        # reaching a reflector before its resync returns only starts
        # another resync, which lists the fake's unchanged objects
        _wait(lambda: len(store.list_keys("ksr/")) == 7
              and ksr.registry.all_synced())
        fake.push_event(PATHS["pod"], "MODIFIED",
                        _pod("a", "10.1.1.9", {"app": "a", "v": "2"}))
        _wait(lambda: (store.get(pod.format("a")) or {}).get(
            "ip_address") == "10.1.1.9")
        fake.push_event(PATHS["pod"], "ADDED", _pod("c", "10.1.1.4"))
        _wait(lambda: store.get(pod.format("c")) is not None)
        fake.push_event(PATHS["pod"], "DELETED", _pod("b", "10.1.1.3"))
        _wait(lambda: store.get(pod.format("b")) is None)
        # the stream drops (410 Gone) while the world moves on: the
        # re-list must diff (d added, c deleted, a updated)
        fake.set_objects(PATHS["pod"], {
            "a": _pod("a", "10.1.1.10"), "d": _pod("d", "10.1.1.5")})
        lists = fake.list_calls[PATHS["pod"]]
        fake.expire_stream(PATHS["pod"])
        _wait(lambda: store.get(pod.format("d")) is not None
              and store.get(pod.format("c")) is None
              and store.get(pod.format("a"))["ip_address"] == "10.1.1.10")
        assert fake.list_calls[PATHS["pod"]] == lists + 1
        # a clean stream end re-watches without a re-list
        _wait(lambda: PATHS["pod"] in fake.watch_queues)
        fake.end_stream(PATHS["pod"])
        fake.push_event(PATHS["pod"], "MODIFIED",
                        _pod("d", "10.1.1.6"))
        _wait(lambda: store.get(pod.format("d"))["ip_address"]
              == "10.1.1.6")
        assert fake.list_calls[PATHS["pod"]] == lists + 1
        stats = {t: (r.stats.adds, r.stats.updates, r.stats.deletes)
                 for t, r in ksr.registry.reflectors.items()}
        return {"log": log, "data": store.dump()["data"], "stats": stats}
    finally:
        ksr.close()
        for lw in sources.values():
            lw.stop()
        for p in PATHS.values():
            fake.end_stream(p)
        fake.close()


def test_both_packages_reflect_the_same_events(tmp_path):
    """KSR over each package's sources turns the same API-server script
    into the same store events, key by key."""
    ref = _ksr_run(jk8s, jksr, jstore, tmp_path, prime=True)
    port = _ksr_run(tk8s, tksr, tstore, tmp_path)
    assert port == ref
    assert len(ref["log"]) == 9  # the 7 listed objects, pods c and d


def _start_after_first_list(self):
    """``Reflector.start`` with the watch thread's first list finished
    before the resync begins: the order that makes the reference write
    a listed object twice."""
    lw = self.list_watch
    done = threading.Event()
    relist = lw._relist_and_diff

    def first(*a, **k):
        try:
            return relist(*a, **k)
        finally:
            done.set()

    lw._relist_and_diff = first
    lw.subscribe(self._on_add, self._on_update, self._on_delete)
    assert done.wait(10.0), "the watch thread never listed"
    self.resync()


@pytest.mark.parametrize("package", ["reference", "port"])
def test_port_writes_each_listed_object_once(package, tmp_path,
                                             monkeypatch):
    """A KSR start whose watch threads list before the reflectors'
    resyncs: the port writes each listed object once and counts one
    update for it; the reference writes pod b (the second pod listed)
    twice, through an add dispatched after its first resync."""
    k8s_mod, ksr_mod, store_mod = ((jk8s, jksr, jstore)
                                   if package == "reference"
                                   else (tk8s, tksr, tstore))
    from vpp_tpu.ksr import reflector as jrefl
    from vpp_tpu_torch.ksr import reflector as trefl

    refl_mod = jrefl if package == "reference" else trefl
    monkeypatch.setattr(refl_mod.Reflector, "start", _start_after_first_list)
    fake = jk8s_tests.FakeK8sApiServer()
    store = store_mod.KVStore()
    log = {}
    store.watch("ksr/", lambda ev: log.setdefault(ev.key, []).append(
        ev.op.name))
    for t, objs in WORLD.items():
        fake.set_objects(PATHS[t], copy.deepcopy(objs))
    sources = k8s_mod.make_k8s_sources(
        kubeconfig=_kubeconfig(tmp_path, fake.url))
    ksr = ksr_mod.KsrAgent(store=store, sources=sources, serve_http=False)
    try:
        ksr.start()   # synchronous here: every list and resync is done
        assert ksr.registry.all_synced()
        stats = {t: (r.stats.adds, r.stats.updates)
                 for t, r in ksr.registry.reflectors.items()}
    finally:
        ksr.close()
        for lw in sources.values():
            lw.stop()
        for p in PATHS.values():
            fake.end_stream(p)
        fake.close()
    pod_b = "ksr/k8s/pod/b/namespace/prod"
    assert len(log) == 7
    if package == "port":
        assert all(ops == ["PUT"] for ops in log.values()), log
        assert stats == {t: (0, len(objs)) for t, objs in WORLD.items()}
    else:
        assert log[pod_b] == ["PUT", "PUT"]
        assert stats["pod"] == (1, 2)
