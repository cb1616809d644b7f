"""Where a hand-written kernel's time goes: source variants timed on the card.

    python3 -m vpp_tpu_torch.kernel_probe [kernel ...]

(kernels: mxu_first_match, lpm_fused_lookup, sess_probe_ways,
bv_first_set; default all)

Run from the repo root on a machine with one NVIDIA Hopper card and the
CUDA toolkit. Each variant is the kernel's source with one part cut out
(a text substitution), built with ``nvcc`` beside the real kernel and
timed like ``chip_smoke.py`` times kernels (device ms per launch from a
replayed CUDA graph) at the smoke's main-path shapes, in turns with the
unmodified kernel. ``sess_probe_ways`` and ``bv_first_set`` run on the
main path's own inputs: the smoke's slice is staged and driven for one
round first. A cut kernel computes a wrong answer by design; the
unmodified one is held bit-exact against its plain version first. The
differences between the lines say what a redesign can win.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from vpp_tpu_torch.ops import _cuda, acl_bv, acl_mxu, lpm, session

# kernel -> (its source in csrc/, {variant: [(text, replacement), ...]})
_MXU_EPI = ("for (int i = kN / 8 - 1; i >= 0; --i) {",
            "for (int i = 0; i >= 0; --i) {")
_MXU_MMA = ("wgmma_s8(acc, da + 2 * ks, db + 2 * ks, ks);",
            "if (ks < 0) wgmma_s8(acc, da + 2 * ks, db + 2 * ks, ks);")
_LPM_STAGE = ("  if (fits) {\n    for (int k = 0; k < n_pop; ++k) {",
              "  if (false) {\n    for (int k = 0; k < n_pop; ++k) {")
_LPM_SEARCH = ("      const int32_t at = fits ?",
               "      const int32_t at = true ? -1 : fits ?")
_SESS_HASH = ("    b = mix & static_cast<uint32_t>(n_buckets - 1);",
              "    b = s & static_cast<uint32_t>(n_buckets - 1);")
_SESS_LOADS = ("return __ldg(reinterpret_cast<const int4*>(col) + b);",
               "return make_int4(0, 0, 0, static_cast<int>(b));")
_BV_SEARCH = ("while (__any_sync(kFull, busy)) {",
              "while (false && __any_sync(kFull, busy)) {")
# the rows stay live (their top bit, always 0, feeds the word) so that
# the search is not cut with the AND
_BV_AND = ("and5<kVec4>(rows, c)",
           "make_uint4(0u, 0u, 0u, static_cast<uint32_t>(("
           + " | ".join(f"reinterpret_cast<uintptr_t>(rows[{k}])"
                        for k in range(5)) + ") >> 63))")
VARIANTS = {
    "mxu_first_match": ("mxu_first_match.cu", {
        "epilogue on 8 of 128 columns": [_MXU_EPI],
        "no products": [_MXU_MMA],
        "no products, epilogue on 8 columns": [_MXU_MMA, _MXU_EPI],
        "every tile reads rule tile 0": [
            ("op + static_cast<int64_t>(col0) * kPlanes", "op")],
    }),
    "lpm_fused_lookup": ("lpm_lookup.cu", {
        "no staging": [_LPM_STAGE],
        "no search": [_LPM_SEARCH],
        "no staging, no search": [_LPM_STAGE, _LPM_SEARCH],
    }),
    "sess_probe_ways": ("sess_probe.cu", {
        "no hash (bucket = src & (NB - 1))": [_SESS_HASH],
        "no loads": [_SESS_LOADS],
        "no hash, no loads": [_SESS_HASH, _SESS_LOADS],
        "256-thread blocks": [("constexpr int kBlock = 32;",
                               "constexpr int kBlock = 256;")],
    }),
    "bv_first_set": ("bv_first_set.cu", {
        "no search (row 0)": [_BV_SEARCH],
        "no AND": [_BV_AND],
        "no search, no AND": [_BV_SEARCH, _BV_AND],
        "16 lanes a narrow packet": [("constexpr int kNarrowLanes = 8;",
                                      "constexpr int kNarrowLanes = 16;")],
        "16 lanes a wide packet": [("constexpr int kWideLanes = 32;",
                                    "constexpr int kWideLanes = 16;")],
    }),
}


def variant_sources(kernel: str):
    """{variant name: its CUDA source} of ``kernel``; every text a
    variant replaces must occur exactly once in the kernel's source."""
    src_name, variants = VARIANTS[kernel]
    src = (_cuda.CSRC / src_name).read_text()
    out = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{kernel} variant {name!r}: {old!r} "
                                   f"is not in {src_name} exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(kernel: str, out: Path):
    """Every variant of ``kernel`` as a loaded ctypes entry, by name."""
    src_name = VARIANTS[kernel][0]
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, text) in enumerate(variant_sources(kernel).items()):
        path = out / f"{kernel}_{i}.cu"
        path.write_text(text)
        lib = out / f"lib{kernel}_{i}.so"
        procs.append((name, lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(lib), str(path)], stderr=subprocess.PIPE, text=True)))
    entries = {"kernel": getattr(_cuda.library(src_name[:-3]), kernel)}
    for name, lib, proc in procs:
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{err}")
        entries[name] = getattr(ctypes.CDLL(str(lib)), kernel)
    return entries


def lpm_stack(rng, dev):
    """The smoke's FIB as an LPM stack (33 lengths x 4,096: /32 250,
    /24 3,745, /0 1 live) and 4,096 destinations, 7 in 8 inside a /24."""
    npad = 4096
    pfx = np.full((33, npad), 0x7FFFFFFF, np.int32)
    slot = np.zeros((33, npad), np.int32)
    cnt = np.zeros(33, np.int32)
    for row, length, n in ((0, 32, 250), (8, 24, 3745), (32, 0, 1)):
        mask = ((0xFFFFFFFF << (32 - length)) & 0xFFFFFFFF) if length else 0
        vals = np.unique(rng.integers(0, 1 << 32, 3 * n, dtype=np.uint64)
                         & mask)
        vals = np.sort(rng.permutation(vals)[:n])
        pfx[row, :len(vals)] = (vals ^ 0x80000000).astype(
            np.uint32).view(np.int32)
        slot[row, :len(vals)] = rng.integers(0, npad, len(vals))
        cnt[row] = len(vals)
    dst = rng.integers(0, 1 << 32, npad, dtype=np.uint64)
    inside = np.arange(npad) % 8 != 0
    picks = pfx[8, rng.integers(0, cnt[8], npad)].astype(np.int64)
    dst = np.where(inside, ((picks & 0xFFFFFFFF) ^ 0x80000000)
                   | rng.integers(0, 256, npad), dst)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return t(dst.astype(np.uint32).view(np.int32)), [
        t(np.arange(32, -1, -1, dtype=np.int32)), t(cnt), t(pfx), t(slot)]


def main_path(seed: int):
    """{(P, what): (wrapper, plain, args)}: the session lookup and the
    global and local classify at the main path's inputs (the smoke's
    slice staged on the card and driven one round, then each size's
    forward vector and its replies)."""
    import chip_smoke as cs

    dp = cs.Dataplane(cs.slice_config())
    up, pods = cs.stage(dp, 10240, 3744)
    cs.drive(dp, up, pods, 1, seed)
    out = {}
    for p in (cs.VEC, cs.BIG_VEC):
        fwd = cs.forward_traffic(p, up, seed + p)
        first = dp.process(cs.packet_vector_from_numpy(fwd, dp.device),
                           now=1000)
        inp = cs.main_path_inputs(dp, fwd, cs.reply_traffic(
            cs.snapshot(first), pods), 1001)
        out[(p, "session")] = (session.sess_probe_ways,
                               session.sess_probe_reverse_plain,
                               inp["sess"])
        for what in ("glb", "loc"):
            out[(p, what)] = (acl_bv.bv_first_set,
                              acl_bv.bv_search_first_set_plain, inp[what])
    return out


def probe(kernel: str, out: Path, seed: int, inputs=None) -> None:
    """Time ``kernel``'s variants in turns with it; ``inputs``: the
    ``main_path`` of the session and classify kernels."""
    import chip_smoke as cs

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    entries = build(kernel, out)
    runs = {}  # shape -> run(entry): one launch with that shape's inputs
    if kernel == "mxu_first_match":
        for f in entries.values():
            f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int32] * 2
                          + [ctypes.c_void_p] * 2)
        for p in (cs.VEC, cs.BIG_VEC):
            args = cs.mxu_case(rng, p, 10240, dev)
            if not torch.equal(acl_mxu.mxu_first_match(*args),
                               acl_mxu.mxu_first_match_plain(*args)):
                raise AssertionError(f"{kernel} P={p} is not exact")
            enc = torch.empty(p, dtype=torch.int32, device=dev)
            ptrs = [_cuda.ptr(t) for t in args]
            cs.say(f"{kernel} P={p}: the wrapper's enc fill alone "
                   f"{cs.time_graph(lambda e=enc: e.fill_(1)) * 1e3:.2f} us")

            def run(f, p=p, enc=enc, ptrs=ptrs):
                enc.fill_(int(acl_mxu.ENC_MISS))
                f(*ptrs, p, 10240, _cuda.ptr(enc), _cuda.stream())
            runs[f"P={p} (with the fill)"] = run
    elif kernel == "lpm_fused_lookup":
        for f in entries.values():
            f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int32] * 4
                          + [ctypes.c_void_p] * 3)
        dst, stack = lpm_stack(rng, dev)
        if not all(torch.equal(a, b) for a, b in zip(
                lpm.lpm_fused_lookup(dst, *stack),
                lpm.lpm_fused_lookup_plain(dst, *stack))):
            raise AssertionError(f"{kernel} is not exact")
        found = torch.empty(dst.shape[0], dtype=torch.bool, device=dev)
        slot = torch.empty(dst.shape[0], dtype=torch.int32, device=dev)
        ptrs = [_cuda.ptr(t) for t in [dst] + stack]
        for p, n_len, budget, where in (
                (1, 33, lpm.LPM_SMEM_ENTRIES, "staged"),
                (cs.VEC, 33, lpm.LPM_SMEM_ENTRIES, "staged"),
                (cs.BIG_VEC, 33, lpm.LPM_SMEM_ENTRIES, "staged"),
                (1, 33, 0, "budget 0: device memory"),
                (cs.BIG_VEC, 33, 0, "budget 0: device memory"),
                (cs.BIG_VEC, 0, 0, "empty stack")):
            def run(f, p=p, n_len=n_len, budget=budget):
                f(*ptrs, p, n_len, 4096, budget, _cuda.ptr(found),
                  _cuda.ptr(slot), _cuda.stream())
            runs[f"P={p} {where}"] = run
    else:
        sess = kernel == "sess_probe_ways"
        for f in entries.values():
            f.argtypes = session.SESS_ARGTYPES if sess else acl_bv.BV_ARGTYPES
        for (p, what), (wrapper, plain, args) in inputs.items():
            if (what == "session") != sess:
                continue
            got, want = wrapper(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{kernel} {what} P={p} is not exact")
            c_args, _ = (session.sess_launch_args if sess
                         else acl_bv.bv_launch_args)(*args)

            def run(f, c_args=c_args):
                f(*c_args, _cuda.stream())
            runs[f"P={p} {what}"] = run
    for shape, run in runs.items():
        kernel_ms = []
        for name, f in entries.items():
            if name == "kernel":
                continue
            ms = cs.time_graph(lambda f=f: run(f))
            kernel_ms.append(cs.time_graph(lambda: run(entries["kernel"])))
            cs.say(f"{kernel} {shape} {name}: {ms * 1e3:.2f} us")
        cs.say(f"{kernel} {shape} kernel: {np.median(kernel_ms) * 1e3:.2f} "
               f"us (median of {len(kernel_ms)}, timed in turns)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernels", nargs="*", choices=sorted(VARIANTS),
                    help="the kernels to probe (default: all)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--out", type=Path,
                    default=_cuda.BUILD_ROOT / "variants",
                    help="where the variant sources and libraries go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    kernels = args.kernels or sorted(VARIANTS)
    inputs = (main_path(args.seed) if {"sess_probe_ways", "bv_first_set"}
              & set(kernels) else None)
    for kernel in kernels:
        probe(kernel, args.out, args.seed, inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
