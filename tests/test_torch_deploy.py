"""The port as Kubernetes deploys it: vpp_tpu_torch/deploy/ against k8s/.

* The default render (``python -m vpp_tpu_torch.deploy.render``) is the
  committed ``vpp_tpu_torch/deploy/vpp-tpu-torch.json`` byte for byte,
  also with ``import yaml`` refused.
* The differential: the port's render and the reference's
  (``k8s/render.py``, read through PyYAML) are equal object for object
  and field for field once the substitutions of
  ``vpp_tpu_torch/deploy/__init__.py`` are applied to the reference's,
  for the default values, mesh mode, and a custom image, pod subnet and
  namespace. No container claims ``google.com/tpu``.
* The reference's four ``tests/test_k8s_chart.py`` cases run on the
  port's chart: their ``render`` helper renders the port's, with the
  table's value names and the List presented as the stream of its items
  they read; their string constants carry the table's names.
* The ConfigMap's agent config parses through both packages'
  ``AgentConfig.from_dict`` to equal fields; the port's ``load_config``
  resolves ``${NODE_NAME}`` from the environment and refuses an unset
  one, where the reference's keeps the placeholder.
* Every container runs a port module that has a ``main``; the netconf's
  ``type`` is the console script of ``vpp_tpu_torch.cni.shim:main``.
* ``vpp_tpu_torch/testing/deploy.py``'s host: mounts relocated, Services
  on loopback addresses, the downward API's node name, the card visible
  to the GPU container alone; the mesh-mode plan; the store trio booted
  from the manifest's argv on loopback.

Every quantity compared is a string, an integer or a structure of them:
the tolerance is exact equality. Every subprocess has a time limit.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import tomllib
import types
from pathlib import Path

import pytest
import yaml

import test_k8s_chart as jchart
import vpp_tpu.cmd.config as jconfig
from test_torch_agent import port_imports
from vpp_tpu_torch.cmd import config as tconfig
from vpp_tpu_torch.deploy import render as trender
from vpp_tpu_torch.testing import deploy as tdeploy

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "vpp_tpu_torch" / "deploy" / "vpp-tpu-torch.json"

# the substitution table of vpp_tpu_torch/deploy/__init__.py, applied to
# the reference's render
_NAMES = re.compile(r"\bvpp-tpu-(cfg|kvstore-standby|kvstore|kvwitness-data"
                    r"|kvwitness|vswitch|ksr)\b")
_VALUE_NAMES = {"tpu_count": "gpu_count", "tpu_resource": "gpu_resource"}


def substituted(s: str) -> str:
    s = s.replace("vpp_tpu.cmd.", "vpp_tpu_torch.cmd.")
    s = s.replace("vpp-tpu-cni", "vpp-tpu-torch-cni")
    s = s.replace("google.com/tpu", "nvidia.com/gpu")
    return _NAMES.sub(r"vpp-tpu-torch-\1", s)


def _substitute(v):
    if isinstance(v, dict):
        return {substituted(k): _substitute(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_substitute(x) for x in v]
    return substituted(v) if isinstance(v, str) else v


def _run(argv, **kw):
    return subprocess.run(argv, capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT), **kw)


def port_render(*args):
    return _run([sys.executable, "-m", "vpp_tpu_torch.deploy.render", *args])


def ref_render(*args):
    return _run([sys.executable, str(ROOT / "k8s" / "render.py"), *args])


def _files_parsed(items, parse):
    """The items with each ConfigMap data file parsed."""
    items = copy.deepcopy(items)
    for it in items:
        if it["kind"] == "ConfigMap":
            it["data"] = {k: parse(v) for k, v in it["data"].items()}
    return items


VALUE_SETS = {
    "defaults": [],
    "mesh": ["--set", "mesh_nodes=4"],
    "custom": ["--set", "image=registry.example/vpp-tpu:2.1",
               "--set", "pod_subnet_cidr=10.9.0.0/16",
               "--set", "namespace=vpp-system"],
}


def test_default_render_is_the_committed_manifest():
    r = port_render()
    assert r.returncode == 0, r.stderr
    assert r.stdout == COMMITTED.read_text(), (
        "vpp_tpu_torch/deploy/vpp-tpu-torch.json drifted from the chart: "
        "python -m vpp_tpu_torch.deploy.render -o "
        "vpp_tpu_torch/deploy/vpp-tpu-torch.json")


@pytest.mark.parametrize("values", sorted(VALUE_SETS))
def test_render_is_the_references_after_the_substitutions(values):
    args = VALUE_SETS[values]
    ref, port = ref_render(*args), port_render(*args)
    assert ref.returncode == 0 and port.returncode == 0, (ref.stderr,
                                                          port.stderr)
    ref_items = _files_parsed(
        [d for d in yaml.safe_load_all(ref.stdout) if d], yaml.safe_load)
    doc = json.loads(port.stdout)
    assert (doc["apiVersion"], doc["kind"]) == ("v1", "List")
    port_items = _files_parsed(doc["items"], json.loads)
    assert len(port_items) == len(ref_items) == 13
    for want, got in zip(_substitute(ref_items), port_items):
        assert got == want, (got["kind"], got["metadata"]["name"])
    assert "google.com/tpu" not in port.stdout
    ds = next(it for it in port_items if it["kind"] == "DaemonSet")
    limits = ds["spec"]["template"]["spec"]["containers"][0]["resources"][
        "limits"]
    assert limits == {"nvidia.com/gpu": 1}   # one card, in mesh mode too


# --- the reference's chart cases on the port's chart ----------------------

def _as_stream(text: str) -> str:
    """A rendered List as the stream of its items (JSON documents are
    YAML documents): the form the reference's cases read."""
    return "".join("---\n" + json.dumps(it, indent=2) + "\n"
                   for it in json.loads(text)["items"])


def _chart_render(*args):
    """The reference case's ``render``, on the port's chart."""
    args = [re.sub(r"^(\w+)=", lambda m: _VALUE_NAMES.get(
        m[1], m[1]) + "=", a) for a in args]
    r = port_render(*args)
    if r.returncode == 0:
        r.stdout = _as_stream(r.stdout)
    return r


def _substituted_code(code: types.CodeType) -> types.CodeType:
    return code.replace(co_consts=tuple(
        _substituted_code(c) if isinstance(c, types.CodeType)
        else substituted(c) if isinstance(c, str) else c
        for c in code.co_consts))


CHART_CASES = sorted(n for n in vars(jchart) if n.startswith("test_"))


def test_chart_case_list():
    assert CHART_CASES == [
        "test_default_render_matches_committed_manifest",
        "test_overrides_apply_and_are_valid_yaml",
        "test_unknown_value_rejected",
        "test_witness_epoch_storage_is_a_pvc_not_hostpath"]


@pytest.mark.parametrize("case", CHART_CASES)
def test_reference_chart_case(case, tmp_path):
    """The case as written, its module's ``render`` and ``REPO`` (whose
    ``k8s/vpp-tpu.yaml`` is the committed port render, as a stream)
    bound to the port's chart."""
    (tmp_path / "k8s").mkdir()
    (tmp_path / "k8s" / "vpp-tpu.yaml").write_text(
        _as_stream(COMMITTED.read_text()))
    g = dict(vars(jchart), render=_chart_render, REPO=str(tmp_path))
    fn = getattr(jchart, case)
    fn = types.FunctionType(_substituted_code(fn.__code__), g, fn.__name__)
    with port_imports():
        fn()


def test_render_needs_no_pyyaml(tmp_path):
    """The renderer with an import hook that refuses ``yaml``."""
    out = tmp_path / "m.json"
    code = (
        "import sys\n"
        "class NoYaml:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'yaml' or name.startswith('yaml.'):\n"
        "            raise ImportError('no PyYAML here')\n"
        "sys.meta_path.insert(0, NoYaml())\n"
        "from vpp_tpu_torch.deploy import render\n"
        f"sys.exit(render.main(['-o', {str(out)!r}]))\n")
    r = _run([sys.executable, "-c", code])
    assert r.returncode == 0, r.stderr
    assert out.read_text() == COMMITTED.read_text()
    probe = _run([sys.executable, "-c", code.split("from vpp_tpu_torch")[0]
                  + "import yaml\n"])
    assert probe.returncode != 0 and "no PyYAML here" in probe.stderr


def test_render_refuses_drift(tmp_path):
    """A value the template does not know, a placeholder the values do
    not fill, and a render that is not JSON fail loudly."""
    r = port_render("--set", "tpu_count=8")
    assert r.returncode != 0 and "not a known value" in r.stderr
    values = trender.load_values()
    with pytest.raises(KeyError, match="unknown value 'witness_port'"):
        trender.render({k: v for k, v in values.items()
                        if k != "witness_port"})
    with pytest.raises(ValueError, match="not JSON"):
        trender.render(dict(values, kvstore_port="12379x"))
    bad = tmp_path / "values.yaml"
    bad.write_text("image: x\nnested:\n  key: 1\n")
    with pytest.raises(ValueError, match=":2: not a flat"):
        trender.load_values(str(bad))


# --- the agent config ----------------------------------------------------

def _config_map(items) -> dict:
    return next(it for it in items if it["kind"] == "ConfigMap")["data"]


def _fields(cfg, keys) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: d[k] for k in keys}


@pytest.mark.parametrize("values", ["defaults", "mesh"])
def test_config_map_parses_alike_in_both_packages(values, monkeypatch):
    args = VALUE_SETS[values]
    ref = [d for d in yaml.safe_load_all(ref_render(*args).stdout) if d]
    ref_cfg = yaml.safe_load(_config_map(ref)["contiv.yaml"])
    port = json.loads(port_render(*args).stdout)["items"]
    text = _config_map(port)["contiv.yaml"]
    port_cfg = json.loads(text)
    assert port_cfg == _substitute(ref_cfg)
    keys = sorted(port_cfg)
    monkeypatch.setenv("NODE_NAME", "gpu-node-7")
    got = tconfig.AgentConfig.from_dict(
        tconfig.resolve_node_name(port_cfg))
    want = jconfig.AgentConfig.from_dict(
        dict(_substitute(ref_cfg), node_name="gpu-node-7"))
    assert _fields(got, keys) == _fields(want, keys)
    assert got.node_name == "gpu-node-7"


def test_load_config_resolves_node_name_from_the_environment(
        tmp_path, monkeypatch):
    """The ConfigMap's ``${NODE_NAME}`` is the downward API's node name
    in the port; the reference's ``load_config`` keeps the placeholder
    (every node of its deployment shares one name)."""
    path = tmp_path / "contiv.yaml"
    path.write_text(_config_map(json.loads(COMMITTED.read_text())[
        "items"])["contiv.yaml"])
    monkeypatch.setenv("NODE_NAME", "gpu-node-3")
    assert tconfig.load_config(str(path)).node_name == "gpu-node-3"
    assert jconfig.load_config(str(path)).node_name == "${NODE_NAME}"
    nested = {"a": ["${NODE_NAME}", {"b": "${NODE_NAME}"}],
              "c": "x${NODE_NAME}"}
    assert tconfig.resolve_node_name(nested) == {
        "a": ["gpu-node-3", {"b": "gpu-node-3"}], "c": "x${NODE_NAME}"}


@pytest.mark.parametrize("env", ["unset", "empty"])
def test_load_config_refuses_an_unset_node_name(env, tmp_path,
                                                monkeypatch):
    path = tmp_path / "contiv.yaml"
    path.write_text(json.dumps({"node_name": "${NODE_NAME}"}))
    if env == "unset":
        monkeypatch.delenv("NODE_NAME", raising=False)
    else:
        monkeypatch.setenv("NODE_NAME", "")
    with pytest.raises(ValueError, match="NODE_NAME"):
        tconfig.load_config(str(path))
    # a config without the placeholder needs no NODE_NAME
    path.write_text(json.dumps({"node_name": "node-1"}))
    assert tconfig.load_config(str(path)).node_name == "node-1"


# --- the containers ------------------------------------------------------

def test_containers_run_port_modules_and_the_port_shim():
    items = json.loads(COMMITTED.read_text())["items"]
    modules = []
    for it in items:
        if it["kind"] not in ("Deployment", "DaemonSet"):
            continue
        spec = it["spec"]["template"]["spec"]
        for c in spec.get("initContainers", []) + spec["containers"]:
            cmd = c["command"]
            if cmd[:2] == ["python", "-m"]:
                modules.append(cmd[2])
            assert "vpp_tpu." not in " ".join(cmd)
    assert sorted(modules) == sorted([
        "vpp_tpu_torch.cmd.kvserver", "vpp_tpu_torch.cmd.kvserver",
        "vpp_tpu_torch.cmd.kvwitness", "vpp_tpu_torch.cmd.init_main",
        "vpp_tpu_torch.cmd.ksr_main"])
    for m in modules:
        assert callable(importlib.import_module(m).main), m
    netconf = json.loads(_config_map(items)["10-vpp-tpu.conf"])
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts[netconf["type"]] == "vpp_tpu_torch.cni.shim:main"
    install = " ".join(next(it for it in items if it["kind"] == "DaemonSet")[
        "spec"]["template"]["spec"]["initContainers"][0]["command"])
    assert f"/opt/vpp-tpu/bin/{netconf['type']} " in install


def _host(tmp_path, manifest=None, **kw):
    manifest = manifest or json.loads(COMMITTED.read_text())
    return tdeploy.HostCluster(manifest, tmp_path / "node", **kw)


def test_host_materializes_the_manifest(tmp_path):
    hc = _host(tmp_path, node_name="gpu-node-5", kubeconfig="/k/config")
    root = tmp_path / "node"
    plan = {f"{c.pod}/{c.name}": c for c in hc.plan()}
    assert hc.services == {
        "vpp-tpu-torch-kvstore.kube-system.svc": "127.0.0.2",
        "vpp-tpu-torch-kvstore-standby.kube-system.svc": "127.0.0.3",
        "vpp-tpu-torch-kvwitness.kube-system.svc": "127.0.0.4"}
    kv = plan["vpp-tpu-torch-kvstore/kvstore"]
    assert kv.argv[1:] == [
        "-m", "vpp_tpu_torch.cmd.kvserver", "--host", "127.0.0.2",
        "--port", "12379",
        "--persist", str(root / "host/var/lib/vpp-tpu/kvstore.json"),
        "--witness", "127.0.0.4:12380", "--advertise", "127.0.0.2:12379",
        "--fence-ttl", "6"]
    assert kv.argv[0] == sys.executable
    witness = plan["vpp-tpu-torch-kvwitness/kvwitness"]
    assert witness.argv[-1] == str(
        root / "pvc/vpp-tpu-torch-kvwitness-data/kvwitness.json")
    vsw = plan["vpp-tpu-torch-vswitch/vswitch"]
    assert vsw.address == "127.0.0.1"
    assert vsw.env == {"NODE_NAME": "gpu-node-5", "CUDA_VISIBLE_DEVICES": "0"}
    assert vsw.probes == {"liveness": ("127.0.0.1", 9191, "/liveness"),
                          "readiness": ("127.0.0.1", 9191, "/readiness")}
    assert {n: c.env["CUDA_VISIBLE_DEVICES"] for n, c in plan.items()
            if n != "vpp-tpu-torch-vswitch/vswitch"} == dict.fromkeys(
        ["vpp-tpu-torch-kvstore/kvstore",
         "vpp-tpu-torch-kvstore-standby/kvstore",
         "vpp-tpu-torch-kvwitness/kvwitness",
         "vpp-tpu-torch-vswitch/cni-install", "vpp-tpu-torch-ksr/ksr"], "")
    ksr = plan["vpp-tpu-torch-ksr/ksr"]
    assert ksr.argv[3:] == ["--store-url", "tcp://127.0.0.2:12379",
                            "--kubeconfig", "/k/config"]
    assert ksr.probes == {"liveness": ("127.0.0.5", 9192, "/liveness")}
    install = plan["vpp-tpu-torch-vswitch/cni-install"]
    assert install.init and install.argv == ["sh", "-c", (
        f"cp {root}/image/opt/vpp-tpu/bin/vpp-tpu-torch-cni "
        f"{root}/host/opt/cni/bin/ && cp "
        f"{root}/configmap/vpp-tpu-torch-cfg/10-vpp-tpu.conf "
        f"{root}/host/etc/cni/net.d/")]
    hc.materialize()
    cfg = json.loads((root / "configmap/vpp-tpu-torch-cfg/contiv.yaml")
                     .read_text())
    assert cfg["node_name"] == "${NODE_NAME}"
    assert cfg["store_url"] == "tcp://127.0.0.2:12379,127.0.0.3:12379"
    assert cfg["cni_socket"] == str(root / "host/run/vpp-tpu/cni.sock")
    assert cfg["http_host"] == "127.0.0.1"
    netconf = json.loads((root / "configmap/vpp-tpu-torch-cfg/"
                          "10-vpp-tpu.conf").read_text())
    assert netconf["grpcServer"] == cfg["cni_socket"]
    shim = root / "image/opt/vpp-tpu/bin/vpp-tpu-torch-cni"
    version = subprocess.run([str(shim)], env={"CNI_COMMAND": "VERSION",
                                               "PATH": "/usr/bin:/bin"},
                             capture_output=True, text=True, timeout=120)
    assert json.loads(version.stdout)["cniVersion"] == "0.3.1"
    assert not (root / "image/opt/vpp-tpu/bin/vpp-tpu-cni").exists()


def test_mesh_mode_plan(tmp_path, monkeypatch):
    """``mesh_nodes=2``: the ConfigMap's config parses in the port and the
    supervisor's plan spawns the mesh agent, on one card."""
    from vpp_tpu_torch.cmd.init_main import InitSupervisor

    r = port_render("--set", "mesh_nodes=2")
    assert r.returncode == 0, r.stderr
    hc = _host(tmp_path, json.loads(r.stdout))
    hc.materialize()
    path = tmp_path / "node/configmap/vpp-tpu-torch-cfg/contiv.yaml"
    monkeypatch.setenv("NODE_NAME", "gpu-node-1")
    cfg = tconfig.load_config(str(path))
    assert (cfg.mesh.nodes, cfg.mesh.rule_shards) == (2, 1)
    argv = InitSupervisor(cfg, str(path)).agent_argv()
    assert argv[1:] == ["-m", "vpp_tpu_torch.cmd.mesh_main", "--config",
                        str(path)]
    vsw = hc.container("vpp-tpu-torch-vswitch", "vswitch")
    assert vsw.gpu and vsw.env["CUDA_VISIBLE_DEVICES"] == "0"


def test_store_trio_boots_from_the_manifest(tmp_path):
    """The witness, the primary and the standby from their Deployments'
    argv, each on its own loopback address at ports the kernel hands
    out: a client of the ConfigMap's store_url writes through the
    primary and reads the write back from the standby."""
    from vpp_tpu_torch.kvstore.client import connect_store

    addrs = ["127.0.0.2", "127.0.0.3", "127.0.0.4"]
    kv_port, w_port = tdeploy.free_ports(addrs, 2)
    r = port_render("--set", f"kvstore_port={kv_port}",
                    "--set", f"witness_port={w_port}",
                    "--set", "fence_ttl=3")
    assert r.returncode == 0, r.stderr
    hc = _host(tmp_path, json.loads(r.stdout))
    hc.materialize()
    url = json.loads((tmp_path / "node/configmap/vpp-tpu-torch-cfg/"
                      "contiv.yaml").read_text())["store_url"]
    store = standby = None
    try:
        for pod, name in (("vpp-tpu-torch-kvwitness", "kvwitness"),
                          ("vpp-tpu-torch-kvstore", "kvstore"),
                          ("vpp-tpu-torch-kvstore-standby", "kvstore")):
            hc.spawn(hc.container(pod, name))
        store = connect_store(url)

        def written():
            try:
                store.put("deploy/probe", {"n": 1})
                return store.get("deploy/probe") == {"n": 1}
            except Exception:  # noqa: BLE001 — not serving yet
                return False

        tdeploy.wait_until(written, "the store pair", 60.0, every_s=0.1,
                           cluster=hc)
        standby = connect_store(f"tcp://127.0.0.3:{kv_port}")
        tdeploy.wait_until(
            lambda: standby.get("deploy/probe") == {"n": 1},
            "the standby's copy", 60.0, every_s=0.1, cluster=hc)
        assert (tmp_path / "node/pvc/vpp-tpu-torch-kvwitness-data").is_dir()
    finally:
        for client in (store, standby):
            if client is not None:
                client.close()
        codes = hc.teardown(timeout=20)
    assert codes == {"vpp-tpu-torch-kvwitness/kvwitness": 0,
                     "vpp-tpu-torch-kvstore/kvstore": 0,
                     "vpp-tpu-torch-kvstore-standby/kvstore": 0}

