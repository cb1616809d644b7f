"""Step time of two checkouts of the port, in alternating pairs on one card.

    python3 -m vpp_tpu_torch.step_pairs OTHER_CHECKOUT [--pairs 10]

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit; OTHER_CHECKOUT is another checkout's root (say, a
``git archive`` of the parent commit). Each run is a fresh process in
one checkout's root that stages ``chip_smoke.py``'s slice and times
``process`` steps with that checkout's own ``chip_smoke`` helpers (device
ms between CUDA events, median of ``--steps``): the ``pallas`` path on
forward vectors alternating with the replies to all their packets (phase
5's cell) and the MXU path's fast tier on the replies to forwarded
packets, at P = 256 and 4,096. Each cell runs the checkout's default
step — the captured one where the checkout has the step program cache,
the eager one before it — and, where the checkout has the cache, the
same cell again with the dataplane stepping eagerly (``eager`` cells).
The pairs alternate which checkout runs first. Prints one JSON line per
run, then a summary per cell: each side's median and quartiles over
the runs, and, for a cell both sides ran, the pairs this checkout won
(ties count for neither).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# one run: stage the slice on the card and time its steps (the code of
# the checkout it runs in: the helpers are the same in every checkout
# since the port's first slice)
_RUN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
out = {}
for path in ("pallas", "mxu fast"):
    cfg = cs.slice_config()
    if path != "pallas":
        cfg = cfg._replace(classifier="mxu", fastpath=True)
    dp = cs.Dataplane(cfg)
    up, pods = cs.stage(dp, 10240, 3744)
    modes = ("", "eager ") if hasattr(dp, "graphs") else ("",)
    for mode in modes:
        dp.graphs = mode == ""
        for n in (cs.VEC, cs.BIG_VEC):
            if path == "pallas":
                ms = cs.time_steps(dp, up, pods, n, STEPS, 7 + n, 1000)[0]
            else:
                fwd = cs.forward_traffic(n, up, 7 + n)
                first = dp.process(cs.packet_vector_from_numpy(
                    fwd, dp.device), now=1000)
                rep = cs.packet_vector_from_numpy(cs.reply_traffic(
                    cs.snapshot(first), pods, "forwarded"), dp.device)
                ms = cs.time_process(dp, [rep], STEPS, 1001, tier=1)[0]
            out[f"{mode}{path} P={n}"] = ms
print(json.dumps(out))
"""


def run(root: Path, steps: int) -> dict:
    """One run in the checkout at ``root``: {cell: median step ms}."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.replace("STEPS", str(steps))],
        cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"run in {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30,
                    help="timed process steps a cell in each run")
    args = ap.parse_args(argv)
    sides = {"this": Path.cwd(), "other": args.other.resolve()}
    runs = {"this": [], "other": []}
    for k in range(args.pairs):
        order = ("other", "this") if k % 2 == 0 else ("this", "other")
        for side in order:
            ms = run(sides[side], args.steps)
            runs[side].append(ms)
            print(json.dumps({"pair": k, "side": side, "ms": ms}),
                  flush=True)
    print(json.dumps({"pairs": args.pairs, "summary": summarise(runs)}))
    return 0


def summarise(runs: dict) -> dict:
    """Per cell of ``runs`` ({side: [{cell: ms}]}): each side's median
    and quartiles, and for a cell both sides ran, the pairs each won
    (ties count for neither)."""
    summary = {}
    for cell in dict.fromkeys([*runs["this"][0], *runs["other"][0]]):
        ms = {side: np.array([r[cell] for r in runs[side]])
              for side in runs if cell in runs[side][0]}
        summary[cell] = {}
        for side, v in ms.items():
            summary[cell][f"{side}_ms"] = float(np.median(v))
            summary[cell][f"{side}_quartiles"] = np.percentile(
                v, [25, 75]).tolist()
        if len(ms) == 2:
            summary[cell].update(
                this_won=int((ms["this"] < ms["other"]).sum()),
                other_won=int((ms["other"] < ms["this"]).sum()))
    return summary


if __name__ == "__main__":
    sys.exit(main())
