"""vpp-tpu-ldpreload-inject: put k8s workloads on the session shim.

The modern replacement for BOTH excluded reference satellites: the
dockershim-based CRI shim (cmd/contiv-cri — injected VCL/ldpreload env
into containers at pod-create time; dockershim is gone from k8s) and
the ldpreload-label-injector dev tool
(cmd/tools/ldpreload-label-injector — rewrote yaml to add ldpreload
labels). Instead of intercepting the runtime, this rewrites the
manifest itself: every container in every Pod template gets

  - env: LD_PRELOAD=<libdir>/libvclshim.so,
         VPP_TPU_VCL_SOCK=/run/vpp-tpu/vcl.sock,
         VPP_TPU_APPNS=<--appns>, [VPP_TPU_VCL_FAILCLOSED=1]
  - volumeMounts + hostPath volumes for the agent socket dir and the
    shim library dir

so an unmodified image is admission-checked against the node's session
rules from its first connect(). Idempotent: re-running on injected
yaml changes nothing.

Usage: vpp-tpu-torch-ldpreload-inject [-o OUT] [--appns N]
       [--fail-closed] [--sock PATH] [--libdir DIR] manifest.yaml
(reads stdin when the file is "-"; multi-document yaml preserved)

The port's copy of ``vpp_tpu/cmd/ldpreload_inject.py``. A manifest may
also be JSON (one object, or a list of documents), and is written back
as JSON; PyYAML is imported only to read or write YAML, so the tool
runs where it is not installed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Tuple

SOCK_DIR_VOL = "vpp-tpu-run"
LIB_DIR_VOL = "vpp-tpu-lib"


def _ensure(lst: Optional[list], key: str, item: dict) -> list:
    """Append item to lst unless an entry with the same ``key`` value
    exists (idempotency); returns the list."""
    lst = lst if isinstance(lst, list) else []
    if not any(isinstance(e, dict) and e.get(key) == item[key]
               for e in lst):
        lst.append(item)
    return lst


def _set_env(container: dict, name: str, value: str) -> None:
    env = container.get("env")
    env = env if isinstance(env, list) else []
    for e in env:
        if isinstance(e, dict) and e.get("name") == name:
            # value + valueFrom together is rejected by the k8s API;
            # our literal value replaces any valueFrom source
            e.pop("valueFrom", None)
            if name == "LD_PRELOAD":
                # chain after any existing preload (same contract as
                # vcl_env: the app keeps its jemalloc/instrumentation)
                prior = str(e.get("value") or "")
                if value not in prior.split(":"):
                    e["value"] = f"{prior}:{value}" if prior else value
            else:
                e["value"] = value
            break
    else:
        env.append({"name": name, "value": value})
    container["env"] = env


def inject_pod_spec(spec: dict, sock: str, libdir: str, appns: int,
                    fail_closed: bool) -> None:
    sock_dir = sock.rsplit("/", 1)[0] or "/run/vpp-tpu"
    # initContainers too: a wait-for-db init connect() bypassing
    # admission would punch through the very policy this tool applies
    targets = (spec.get("containers") or []) + \
        (spec.get("initContainers") or [])
    for container in targets:
        _set_env(container, "LD_PRELOAD", f"{libdir}/libvclshim.so")
        _set_env(container, "VPP_TPU_VCL_SOCK", sock)
        _set_env(container, "VPP_TPU_APPNS", str(appns))
        if fail_closed:
            _set_env(container, "VPP_TPU_VCL_FAILCLOSED", "1")
        container["volumeMounts"] = _ensure(
            container.get("volumeMounts"), "name",
            {"name": SOCK_DIR_VOL, "mountPath": sock_dir})
        container["volumeMounts"] = _ensure(
            container["volumeMounts"], "name",
            {"name": LIB_DIR_VOL, "mountPath": libdir, "readOnly": True})
    spec["volumes"] = _ensure(
        spec.get("volumes"), "name",
        {"name": SOCK_DIR_VOL, "hostPath": {"path": sock_dir}})
    spec["volumes"] = _ensure(
        spec["volumes"], "name",
        {"name": LIB_DIR_VOL, "hostPath": {"path": libdir}})


def _find_pod_spec(doc: dict) -> Optional[dict]:
    """Pod => .spec; workloads with a template (Deployment, DaemonSet,
    StatefulSet, Job, ReplicaSet) => .spec.template.spec; CronJob =>
    .spec.jobTemplate.spec.template.spec."""
    if not isinstance(doc, dict):
        return None
    kind = doc.get("kind")
    spec = doc.get("spec")
    if not isinstance(spec, dict):
        return None
    if kind == "Pod":
        return spec
    if kind == "CronJob":
        spec = (spec.get("jobTemplate") or {}).get("spec")
        if not isinstance(spec, dict):
            return None
    tmpl = spec.get("template")
    if isinstance(tmpl, dict) and isinstance(tmpl.get("spec"), dict):
        return tmpl["spec"]
    return None


def inject_documents(docs: list, sock: str, libdir: str, appns: int,
                     fail_closed: bool) -> int:
    """Inject every pod template found; returns how many were."""
    n = 0
    for doc in docs:
        spec = _find_pod_spec(doc)
        if spec is not None:
            inject_pod_spec(spec, sock, libdir, appns, fail_closed)
            n += 1
    return n


def load_documents(text: str) -> Tuple[list, Optional[str]]:
    """The manifest's documents, and its JSON form: None for YAML,
    ``"object"`` or ``"list"`` (a document per element) for JSON.
    Anything JSON does not parse is YAML."""
    try:
        parsed = json.loads(text)
    except ValueError:
        import yaml

        # a trailing '---' or comment-only section loads as None and
        # would re-serialize as a literal 'null' document kubectl rejects
        return [d for d in yaml.safe_load_all(text) if d is not None], None
    if isinstance(parsed, list):
        return [d for d in parsed if d is not None], "list"
    return [parsed], "object"


def dump_documents(docs: list, json_form: Optional[str]) -> str:
    """``docs`` in the form ``load_documents`` read them in."""
    if json_form is not None:
        out = docs if json_form == "list" else docs[0]
        return json.dumps(out, indent=2) + "\n"
    import yaml

    return yaml.safe_dump_all(docs, sort_keys=False)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="vpp-tpu-torch-ldpreload-inject",
        description="inject session-shim env/volumes into k8s yaml")
    ap.add_argument("manifest", help="yaml file, or - for stdin")
    ap.add_argument("-o", "--out", default="-",
                    help="output file (default stdout)")
    ap.add_argument("--sock", default="/run/vpp-tpu/vcl.sock")
    ap.add_argument("--libdir", default="/opt/vpp-tpu/lib")
    ap.add_argument("--appns", type=int, default=0)
    ap.add_argument("--fail-closed", action="store_true")
    args = ap.parse_args(argv)

    text = (sys.stdin.read() if args.manifest == "-"
            else open(args.manifest).read())
    docs, json_form = load_documents(text)
    n = inject_documents(docs, args.sock, args.libdir, args.appns,
                         args.fail_closed)
    out = dump_documents(docs, json_form)
    if args.out == "-":
        sys.stdout.write(out)
    else:
        with open(args.out, "w") as f:
            f.write(out)
    print(f"injected {n} pod template(s)", file=sys.stderr)
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
