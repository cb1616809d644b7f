"""A rendered vpp_tpu_torch manifest as processes on one host.

``HostCluster(manifest, root)`` turns the List that
``python -m vpp_tpu_torch.deploy.render`` writes into what a kubelet on
one GPU node would run, with every pod a process of this host:

* each volume becomes a directory under ``root``: a ``hostPath`` under
  ``root/host`` (shared by the pods that mount it, as on a node), a
  ``configMap`` under ``root/configmap/<name>`` (its data as files), a
  ``persistentVolumeClaim`` under ``root/pvc/<claim>``; a container path
  under a mount is relocated into its volume's directory;
* each pod gets its own loopback address (``127.0.0.N``, N from 2; a
  ``hostNetwork`` pod the node's, ``127.0.0.1``), each Service DNS name
  (``<svc>.<namespace>.svc``) the address of the pod its selector
  picks, and a pod's ``--host 0.0.0.0`` (and the agent config's
  ``http_host``) that pod's address; ports stay the manifest's;
* the downward API's ``spec.nodeName`` is the node's name;
* the device plugin's effect: ``CUDA_VISIBLE_DEVICES=0`` for a container
  whose limits claim ``nvidia.com/gpu``, ``""`` for every other;
* the image: ``python`` is this interpreter with the checkout on
  ``PYTHONPATH``, and ``/opt/vpp-tpu/bin/<script>`` of each of the
  port's console scripts in ``pyproject.toml`` is a launcher of its
  entry point under ``root/image``.

Every rewrite is made to the argv, env and config that the manifest
holds; nothing is rebuilt by hand. ``plan()`` is pure (what the CPU
tests check); ``materialize()`` writes the directories, the ConfigMap's
files and the launchers; ``spawn()`` starts a container's process and
``teardown()`` stops them all in reverse order. Not emulated: the
service-account mount of an in-cluster API client (the caller hands
the KSR a kubeconfig instead, ``kubeconfig=``), network namespaces
(every pod shares this host's), and restarts.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
NODE_ADDRESS = "127.0.0.1"
GPU_RESOURCE = "nvidia.com/gpu"
IMAGE_BIN = "/opt/vpp-tpu/bin"


@dataclass
class Container:
    """One container of one pod, as this host runs it."""
    pod: str                     # the workload's name
    name: str
    init: bool                   # an init container (runs to completion)
    argv: List[str]
    env: Dict[str, str]
    address: str
    mounts: Dict[str, Path]      # container path -> host directory
    gpu: bool
    probes: Dict[str, Tuple[str, int, str]] = field(default_factory=dict)


def load_manifest(path) -> dict:
    with open(path) as f:
        return json.load(f)


def console_scripts(pyproject: Path = ROOT / "pyproject.toml") -> dict:
    """``{script: "module:function"}`` of the project's console scripts."""
    import tomllib

    with open(pyproject, "rb") as f:
        return dict(tomllib.load(f)["project"]["scripts"])


class HostCluster:
    def __init__(self, manifest: dict, root, node_name: str = "gpu-node-1",
                 kubeconfig: Optional[str] = None,
                 python: str = sys.executable):
        self.items = list(manifest["items"])
        self.root = Path(root)
        self.node_name = node_name
        self.kubeconfig = kubeconfig
        self.python = python
        # (container, its process), in start order
        self.procs: List[Tuple[Container, subprocess.Popen]] = []
        self.workloads = [it for it in self.items
                          if it["kind"] in ("Deployment", "DaemonSet")]
        self.address: Dict[str, str] = {}
        n = 2
        for w in self.workloads:
            if w["spec"]["template"]["spec"].get("hostNetwork"):
                self.address[w["metadata"]["name"]] = NODE_ADDRESS
            else:
                self.address[w["metadata"]["name"]] = f"127.0.0.{n}"
                n += 1
        self.services: Dict[str, str] = {}
        for svc in self.items:
            if svc["kind"] != "Service":
                continue
            sel = svc["spec"]["selector"]
            pods = [w for w in self.workloads if sel.items() <=
                    w["spec"]["template"]["metadata"]["labels"].items()]
            if len(pods) != 1:
                raise ValueError(f"Service {svc['metadata']['name']} "
                                 f"selects {len(pods)} workloads")
            dns = (f"{svc['metadata']['name']}."
                   f"{svc['metadata']['namespace']}.svc")
            self.services[dns] = self.address[pods[0]["metadata"]["name"]]

    # --- the plan (pure) ---------------------------------------------------
    def volume_dir(self, vol: dict) -> Path:
        if "hostPath" in vol:
            return self.root / "host" / vol["hostPath"]["path"].lstrip("/")
        if "configMap" in vol:
            return self.root / "configmap" / vol["configMap"]["name"]
        if "persistentVolumeClaim" in vol:
            return (self.root / "pvc"
                    / vol["persistentVolumeClaim"]["claimName"])
        raise ValueError(f"volume {vol.get('name')}: unsupported source")

    def relocate(self, path: str, mounts: Dict[str, Path]) -> str:
        """A container path on this host: under its mount's directory,
        else under the image's root."""
        for mp in sorted(mounts, key=len, reverse=True):
            if path == mp or path.startswith(mp.rstrip("/") + "/"):
                return str(mounts[mp]) + path[len(mp.rstrip("/")):]
        return str(self.root / "image") + path

    def _rewrite(self, arg: str, c_mounts) -> str:
        for dns, addr in self.services.items():
            arg = re.sub(re.escape(dns) + r"(?![\w.-])", addr, arg)
        if arg.startswith("/"):
            return self.relocate(arg, c_mounts)
        return arg

    def plan(self) -> List[Container]:
        """Every container of every workload, in manifest order (a pod's
        init containers before its containers)."""
        out = []
        for w in self.workloads:
            pod = w["metadata"]["name"]
            spec = w["spec"]["template"]["spec"]
            vols = {v["name"]: self.volume_dir(v)
                    for v in spec.get("volumes", [])}
            address = self.address[pod]
            for init, key in ((True, "initContainers"),
                              (False, "containers")):
                for c in spec.get(key, []):
                    out.append(self._container(pod, c, init, vols, address))
        return out

    def container(self, pod: str, name: str) -> Container:
        for c in self.plan():
            if c.pod == pod and c.name == name:
                return c
        raise KeyError(f"{pod}/{name}")

    def _container(self, pod, c, init, vols, address) -> Container:
        mounts = {m["mountPath"]: vols[m["name"]]
                  for m in c.get("volumeMounts", [])}
        cmd = list(c["command"])
        argv = []
        if cmd[:2] == ["sh", "-c"]:
            argv = ["sh", "-c", " ".join(
                self._rewrite(tok, mounts)
                for tok in shlex.split(cmd[2]))] + cmd[3:]
        else:
            for i, arg in enumerate(cmd):
                prev = cmd[i - 1] if i else None
                if i == 0 and arg == "python":
                    arg = self.python
                elif prev == "--host" and arg == "0.0.0.0":
                    arg = address
                elif prev == "--kubeconfig" and arg == "in-cluster" \
                        and self.kubeconfig is not None:
                    arg = self.kubeconfig
                else:
                    arg = self._rewrite(arg, mounts)
                argv.append(arg)
        env = {}
        for e in c.get("env", []):
            if "value" in e:
                env[e["name"]] = str(e["value"])
                continue
            ref = e["valueFrom"]["fieldRef"]["fieldPath"]
            if ref != "spec.nodeName":
                raise ValueError(f"{pod}/{c['name']}: env {e['name']} "
                                 f"from {ref}, not emulated")
            env[e["name"]] = self.node_name
        limits = c.get("resources", {}).get("limits", {})
        gpu = int(limits.get(GPU_RESOURCE, 0)) > 0
        env["CUDA_VISIBLE_DEVICES"] = "0" if gpu else ""
        probes = {}
        for kind in ("livenessProbe", "readinessProbe"):
            get = c.get(kind, {}).get("httpGet")
            if get:
                probes[kind[:-len("Probe")]] = (address, int(get["port"]),
                                                get["path"])
        return Container(pod, c["name"], init, argv, env, address, mounts,
                         gpu, probes)

    # --- the host ----------------------------------------------------------
    def materialize(self) -> None:
        """The volume directories, the ConfigMaps' files (each path and
        ``0.0.0.0`` in a JSON file rewritten for the container that reads
        it, the first non-init one that mounts it) and the image's
        console-script launchers."""
        plan = self.plan()
        for c in plan:
            for d in c.mounts.values():
                d.mkdir(parents=True, exist_ok=True)
        for cm in (it for it in self.items if it["kind"] == "ConfigMap"):
            d = self.root / "configmap" / cm["metadata"]["name"]
            d.mkdir(parents=True, exist_ok=True)
            reader = next((c for c in plan if not c.init
                           and d in c.mounts.values()), None)
            for fname, text in cm["data"].items():
                if reader is not None:
                    text = self.rewrite_config(text, reader)
                (d / fname).write_text(text)
        bin_dir = self.root / "image" / IMAGE_BIN.lstrip("/")
        bin_dir.mkdir(parents=True, exist_ok=True)
        for script, entry in console_scripts().items():
            module, func = entry.split(":")
            if not module.startswith("vpp_tpu_torch."):
                continue  # the reference's: not in the port's image
            launcher = bin_dir / script
            launcher.write_text(
                "#!/bin/sh\n"
                f"PYTHONPATH={shlex.quote(str(ROOT))}"
                "${PYTHONPATH:+:$PYTHONPATH} "
                f"exec {shlex.quote(self.python)} -c "
                + shlex.quote(f"import sys; from {module} import {func}; "
                              f"sys.exit({func}())") + ' "$@"\n')
            launcher.chmod(0o755)

    def rewrite_config(self, text: str, c: Container) -> str:
        """A JSON config file as container ``c`` reads it: Service names
        their addresses, every string value that is an absolute path
        relocated, ``0.0.0.0`` its address. A file that is not JSON is
        left as it is."""
        try:
            data = json.loads(text)
        except ValueError:
            return text

        def walk(v):
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, list):
                return [walk(x) for x in v]
            if v == "0.0.0.0":
                return c.address
            if isinstance(v, str):
                return self._rewrite(v, c.mounts)
            return v

        return json.dumps(walk(data), indent=2) + "\n"

    def env_of(self, c: Container) -> dict:
        env = dict(os.environ)
        env.update(c.env)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        return env

    def spawn(self, c: Container,
              argv: Optional[List[str]] = None) -> subprocess.Popen:
        """Start ``c`` (or ``argv`` in its place, with its env) in its own
        session, from ``root``; its output goes to
        ``root/logs/<pod>.<container>.{out,err}``."""
        logs = self.root / "logs"
        logs.mkdir(parents=True, exist_ok=True)
        base = logs / f"{c.pod}.{c.name}"
        with open(f"{base}.out", "wb") as out, \
                open(f"{base}.err", "wb") as err:
            proc = subprocess.Popen(
                list(argv or c.argv), env=self.env_of(c),
                cwd=str(self.root), stdout=out, stderr=err,
                start_new_session=True)
        self.procs.append((c, proc))
        return proc

    def log(self, name: str, stream: str = "err") -> str:
        path = self.root / "logs" / f"{name.replace('/', '.')}.{stream}"
        return path.read_text(errors="replace") if path.exists() else ""

    def exited(self) -> Dict[str, int]:
        """``pod/container`` -> exit code of each process that has ended
        before its time: a container that exited, or an init container
        that exited nonzero."""
        return {f"{c.pod}/{c.name}": p.returncode for c, p in self.procs
                if p.poll() is not None and (not c.init or p.returncode)}

    def teardown(self, timeout: float = 30.0) -> Dict[str, int]:
        """SIGTERM to every process still running, newest first, each
        waited for up to ``timeout`` s (then killed, its code -9); every
        process's exit code."""
        for _, p in reversed(self.procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(timeout=30)
        for _, p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        return {f"{c.pod}/{c.name}": p.returncode for c, p in self.procs}


def free_ports(addresses, n: int) -> List[int]:
    """``n`` distinct ports the kernel hands out that bind on every one
    of ``addresses``: what an operator sets in values.yaml for a node
    whose pods take those addresses."""
    import socket

    out: List[int] = []
    while len(out) < n:
        with socket.socket() as s:
            s.bind((addresses[0], 0))
            port = s.getsockname()[1]
        try:
            for a in addresses:
                with socket.socket() as t:
                    t.bind((a, port))
        except OSError:
            continue
        if port not in out:
            out.append(port)
    return out


def http_status(address: str, port: int, path: str,
                timeout: float = 2.0) -> Optional[int]:
    """A kubelet httpGet probe: the status code, None when nothing
    answers."""
    try:
        with urllib.request.urlopen(f"http://{address}:{port}{path}",
                                    timeout=timeout) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except OSError:
        return None


def wait_until(pred, what: str, deadline_s: float, every_s: float = 0.05,
               cluster: Optional[HostCluster] = None):
    """Poll ``pred`` until it is truthy (returned); ``TimeoutError`` after
    ``deadline_s``, ``RuntimeError`` at once if one of ``cluster``'s
    processes has exited."""
    deadline = time.monotonic() + deadline_s
    while True:
        v = pred()
        if v:
            return v
        if cluster is not None and cluster.exited():
            raise RuntimeError(f"waiting for {what}: exited "
                               f"{cluster.exited()}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"waiting for {what} ({deadline_s:.0f} s)")
        time.sleep(every_s)
