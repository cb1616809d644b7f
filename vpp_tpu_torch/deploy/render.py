"""Render the port's manifest from ``chart/vpp-tpu-torch.yaml.tmpl`` and
``chart/values.yaml``, as ``k8s/render.py`` renders the reference's:

    python -m vpp_tpu_torch.deploy.render                     # stdout
    python -m vpp_tpu_torch.deploy.render --set image=reg/vpp:1.2
    python -m vpp_tpu_torch.deploy.render -o vpp_tpu_torch/deploy/vpp-tpu-torch.json

``{{name}}`` placeholders come from values.yaml (overridable with
``--set``); a ``--set`` of a key values.yaml does not hold, a
placeholder the values do not fill, a placeholder left over, or a render
that is not JSON fails loudly, so a template / values drift cannot
produce a silently broken manifest. ``mesh_nodes`` > 0 adds the
agent config's ``mesh`` section (the supervisor then starts the mesh
agent). Needs no PyYAML: the values file is read by ``load_values``
(one ``key: scalar`` a line) and the output is JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
TEMPLATE = os.path.join(_DIR, "chart", "vpp-tpu-torch.yaml.tmpl")
VALUES = os.path.join(_DIR, "chart", "values.yaml")
MANIFEST = os.path.join(_DIR, "vpp-tpu-torch.json")


def _scalar(text: str):
    """A values.yaml scalar: a quoted string, an int, or a bare string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if re.fullmatch(r"-?\d+", text):
        return int(text)
    return text


def load_values(path: str = VALUES) -> dict:
    """The flat ``key: scalar`` mapping of a values file; ``#`` starts a
    comment outside quotes. Anything else (nesting, a list, a line
    without ``key:``) raises ``ValueError`` with its line number."""
    values = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            body = line.strip()
            if not body or body.startswith("#"):
                continue
            m = re.fullmatch(r"([A-Za-z_]\w*):\s*(\"[^\"]*\"|'[^']*'|[^#]*?)"
                             r"\s*(#.*)?", body)
            if m is None or not m.group(2) or line[0].isspace():
                raise ValueError(f"{path}:{n}: not a flat `key: scalar` "
                                 f"line: {line.rstrip()!r}")
            values[m.group(1)] = _scalar(m.group(2))
    return values


def render_text(values: dict) -> str:
    """The template with ``values`` substituted: JSON text."""
    with open(TEMPLATE) as f:
        lines = [ln for ln in f if not ln.lstrip().startswith("#")]
    values = dict(values)
    # conditional mesh section: nodes > 0 turns the agent config into
    # mesh mode (cmd/config.py MeshConfig; the init supervisor passes
    # the same contiv.yaml to vpp-tpu-torch-mesh-agent)
    if int(values.get("mesh_nodes", 0)) > 0:
        values["mesh_section"] = (
            ',\n      "mesh": {"nodes": %d, "rule_shards": %d}'
            % (int(values["mesh_nodes"]),
               int(values.get("mesh_rule_shards", 1))))
    else:
        values["mesh_section"] = ""

    def sub(m: re.Match) -> str:
        key = m.group(1)
        if key not in values:
            raise KeyError(f"template references unknown value {key!r}")
        return str(values[key])

    out = re.sub(r"\{\{(\w+)\}\}", sub, "".join(lines))
    leftover = re.search(r"\{\{\w+\}\}", out)
    if leftover:
        raise ValueError(f"unrendered placeholder: {leftover.group(0)}")
    return out


def render_manifest(values: dict) -> dict:
    """The rendered List: each ConfigMap data value the template writes
    as an object becomes its file's JSON text."""
    text = render_text(values)
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise ValueError(f"the render is not JSON ({e}); check the values "
                         "substituted into it") from None
    for item in doc["items"]:
        if item.get("kind") == "ConfigMap":
            item["data"] = {
                k: v if isinstance(v, str) else json.dumps(v, indent=2) + "\n"
                for k, v in item["data"].items()}
    return doc


def render(values: dict) -> str:
    """The manifest file's text: the List as indented JSON."""
    return json.dumps(render_manifest(values), indent=2) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vpp_tpu_torch.deploy.render")
    ap.add_argument("--values", default=VALUES)
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    values = load_values(args.values)
    for kv in args.sets:
        key, eq, val = kv.partition("=")
        if not eq:
            raise SystemExit(f"--set {kv!r}: expected KEY=VALUE")
        if key not in values:
            raise SystemExit(f"--set {key}: not a known value "
                             f"(see {args.values})")
        values[key] = val
    text = render(values)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
