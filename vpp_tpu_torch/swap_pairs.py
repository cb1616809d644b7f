"""Swap cost of two checkouts of the port, in alternating pairs on one card.

    python3 -m vpp_tpu_torch.swap_pairs OTHER_CHECKOUT [--pairs 2] [--reps 4]

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and the CUDA toolkit; OTHER_CHECKOUT is another checkout's root (say, a
``git archive`` of the parent commit). Each run is a fresh process in one
checkout's root that stages ``chip_smoke.py``'s phase 4e configuration
(tenancy, the overlay, service VIPs, ECMP, the ML stage and telemetry)
on the ``pallas`` path and on the MXU path with that checkout's own
``chip_smoke`` helpers, steps one forward vector (its programs are
captured), then times ``--reps`` swaps of each of two churns: (a) one
global rule's ``dest_port`` changed at index 5,000 of 10,240 (the rule
list otherwise the same objects, as a renderer hands it over), and (c) a
pod add (an interface, its local table, a /32 route). A cell's numbers
are the medians over the reps of the host wall ms of ``Dataplane.swap``
(the card synchronised before and after), the ms between CUDA events
around it (its span on the device's timeline, host work included), and
the host-to-device bytes it shipped (the upload groups' record where
the checkout keeps one, else the staged arrays' bytes: a full upload);
and the device's busy ms of one more swap of the churn under
``torch.profiler`` (kernel and memcpy time). The pairs alternate which checkout runs first.
Prints one JSON line per run, then per cell each side's median and
quartiles over the runs and the pairs this checkout won.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from vpp_tpu_torch.step_pairs import summarise

# one run: the code of the checkout it runs in (every checkout since the
# tenancy slice has these chip_smoke helpers)
_RUN = """
import dataclasses, json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs

def timed(dp):
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    dp.swap()
    z.record()
    torch.cuda.synchronize()
    b = dp.builder
    rec = getattr(b, "last_upload", None)
    shipped = (sum(r["bytes"] for r in rec.values()) if rec is not None
               else sum(np.asarray(x).nbytes
                        for x in b.host_arrays().values()))
    return (time.perf_counter() - t0) * 1e3, a.elapsed_time(z), shipped

def profiled(dp, stage):
    # the device's busy ms of one swap: torch.profiler's kernel and
    # memcpy time (the same measure on both checkouts)
    from torch.profiler import ProfilerActivity, profile
    stage()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dp.swap()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / 1e3

out = {}
for path in ("pallas", "mxu"):
    cfg = cs.slice_config()
    if path == "mxu":
        cfg = cfg._replace(classifier="mxu", fastpath=True)
    dp = cs.Dataplane(cs.tnt_ovl_config(cfg))
    up, pods = cs.stage_tnt_ovl(dp, 10240, 3744, cs.ml_models(0)[0][1])
    cs.apply_tnt_op(dp, ("process", cs.tnt_ovl_traffic(cs.VEC, up, 7, 3744),
                         100))
    b = dp.builder
    rules = cs.global_rules(10240, svc=True)
    b.set_global_table(rules)
    dp.swap()
    def stage(churn, r):
        global rules
        if churn == "a":
            rules = list(rules)
            rules[5000] = dataclasses.replace(rules[5000],
                                              dest_port=9999 - r % 2)
            b.set_global_table(rules)
        else:
            pod = ("default", f"swap-pod{r}")
            idx = dp.add_pod_interface(pod)
            dp.alloc_table_slot(f"swap-pod{r}-policy")
            b.set_local_table(dp.table_slots[f"swap-pod{r}-policy"],
                              cs.local_rules(cs.N_PODS + r, 128))
            dp.assign_pod_table(pod, f"swap-pod{r}-policy")
            b.add_route(f"10.1.1.{251 + r}/32", idx, cs.Disposition.LOCAL)

    for churn in ("a", "c"):
        got = []
        for r in range(REPS):
            stage(churn, r)
            got.append(timed(dp))
        host, span, shipped = (float(np.median(v)) for v in zip(*got))
        out[f"{path} ({churn}) host"] = host
        out[f"{path} ({churn}) event span"] = span
        out[f"{path} ({churn}) device busy"] = profiled(
            dp, lambda: stage(churn, REPS))
        out[f"{path} ({churn}) bytes"] = shipped
print(json.dumps(out))
"""


def run(root: Path, reps: int) -> dict:
    """One run in the checkout at ``root``: {cell: median}."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.replace("REPS", str(reps))],
        cwd=root, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"run in {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=4,
                    help="timed swaps of each churn in each run (at most "
                         "4: the pod adds use 10.1.1.251-255)")
    args = ap.parse_args(argv)
    sides = {"this": Path.cwd(), "other": args.other.resolve()}
    runs = {"this": [], "other": []}
    for k in range(args.pairs):
        order = ("other", "this") if k % 2 == 0 else ("this", "other")
        for side in order:
            got = run(sides[side], min(args.reps, 4))
            runs[side].append(got)
            print(json.dumps({"pair": k, "side": side, "cells": got}),
                  flush=True)
    print(json.dumps({"pairs": args.pairs, "summary": summarise(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
