"""The step program cache: each step variant captured once in CUDA graphs.

The port's counterpart of the reference's jit program cache
(``vpp_tpu/pipeline/dataplane.py`` ``_jitted_step`` :557, ``_step_label``
:356, the compile counters and budget :393-470): ``jax.jit`` compiles
each step variant once into one device program, and here a ``Program``
captures it once into CUDA graphs and replays them, so a step costs a
graph launch instead of ~500-1,600 eager launches from the host.

A program holds

* static inputs: the ``[9, P]`` header columns (``plain``; with the
  overlay on ``[19, P]``: the outer header, the inner sidecar and the
  VNI row), the ``[5, B]`` bit-packed batch (``packed``) or ``K`` of
  them (``chain``),
  the clock ``now`` (0-d int32) and, for a packed or chain program of a
  telemetry step, the rx stamp (0-d, or ``[K]``) and ``now_us`` the
  latency histogram reads (graph.py ``tel_observe``); each call writes
  them, then replays;
* the live table tensors, which the step reads and mutates in place:
  their addresses are baked into the graphs, so ``Dataplane.swap`` and
  ``expire_sessions`` write into the held tensors, and a program whose
  tables are no longer all the live ones is dropped, never replayed;
* its parts, one graph each: ``full`` on the forced full chain; on the
  auto path ``prefix`` (ending in the dispatch flag), ``fast`` and
  ``full`` (each of which reads the prefix's outputs), with the flag
  read to the host between them, outside every graph: the auto path's
  one host sync per step;
* its static output: a final part writes every result tensor into ONE
  buffer (``Packing``, or the packed rows and aux); the call clones it
  after the replay and hands out views of the clone, so a result never
  aliases graph memory (the result of step N is unchanged by step N+1)
  and the copy-out is one launch.

Warm-up. Torch wants a warm-up before a capture, but a second run of a
step on live state would insert its sessions twice and advance the
sweep cursors twice. So a part's first call runs it eagerly — the
warm-up, whose result is the real one — and then captures it, which
executes nothing; from the second call on it replays. The kernels'
one-time host setup (``cudaFuncSetAttribute``, the SM-count queries)
thus runs before any capture. A capture or replay that fails raises;
nothing falls back to the eager step.

Launch counters. A kernel wrapper counts its launches while its Python
body runs, which under capture launches nothing: each part records what
its capture counted, takes it back, and adds it at every replay, so
``launches`` keeps meaning device launches.

On the CPU the same program runs — copy in, the parts eagerly, copy
out — without graphs, so the tests exercise its buffers; its first call
counts as its capture.

``Program.prime`` builds every part (both tiers on the auto path) on an
all-invalid batch and writes the state it stepped back, so a caller can
capture everything before other threads touch the card (the IO pump's
``warm``); captures run in ``thread_local`` mode all the same, so
another thread's event waits and copies cannot break a capture a later
swap forces. ``RingProgram`` is the ring form (the reference's window
program, ``_ring_call``): a host loop over a window's slots through one
packed program, one capture per step variant whatever the fill.

``capture_counts`` / ``capture_totals`` / ``capture_budget`` mirror
``jit_compile_counts`` / ``jit_compile_totals`` / ``jit_compile_budget``;
the key adds the dataplane (graphs hold its tensors) to the reference's
(the label, the input shape and every table tensor's shape and dtype),
and a budget also raises when its scope captures one key twice.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
from typing import Dict, Optional, Sequence

import torch

from vpp_tpu_torch.ops import acl_bv, acl_mxu, lpm, mlscore, session
from vpp_tpu_torch.pipeline.graph import (
    SWEEP_STRIDE_DEFAULT,
    packed_fields,
    packed_vector,
    result_fields,
    result_of,
    tel_observe,
)
from vpp_tpu_torch.pipeline.vector import PacketVector

# the kernel wrappers whose launch counters replays keep
WRAPPERS = (session.sess_probe_ways, acl_bv.bv_first_set,
            lpm.lpm_fused_lookup, acl_mxu.mxu_first_match,
            mlscore.ml_stage)

# (label, signature) -> captures in this process
_CAPTURES: Dict[tuple, int] = {}
_CAPTURES_LOCK = threading.Lock()
_owners = itertools.count()
_dumps = itertools.count()

# when set (a directory), every capture keeps its graph's nodes and
# writes them there as ``<label>-<n>.dot`` (CUDAGraph.debug_dump)
debug_dump_dir: Optional[str] = None


def new_owner() -> int:
    """A serial number for one dataplane's programs."""
    return next(_owners)


def step_label(step, form: str, sweep_stride: int) -> str:
    """The reference's ``_step_label``: the variant in ``step``'s name
    (graph.py ``make_pipeline_step``), then the sweep stride where it
    is not the default, then the form."""
    return "{}{}_{}".format(
        step.__name__[len("pipeline_step_"):],
        "" if sweep_stride == SWEEP_STRIDE_DEFAULT else f"_sw{sweep_stride}",
        form)


def table_signature(tables) -> tuple:
    """The shape and dtype of every table tensor, in field order."""
    return tuple((tuple(t.shape), t.dtype) for t in tables)


def _count(label: str, sig: tuple) -> None:
    with _CAPTURES_LOCK:
        _CAPTURES[(label, sig)] = _CAPTURES.get((label, sig), 0) + 1


def capture_counts() -> Dict[tuple, int]:
    """Snapshot of {(part label, signature): captures}."""
    with _CAPTURES_LOCK:
        return dict(_CAPTURES)


def capture_totals() -> Dict[str, int]:
    """Captures per part label."""
    totals: Dict[str, int] = {}
    for (label, _sig), n in capture_counts().items():
        totals[label] = totals.get(label, 0) + n
    return totals


class CaptureBudgetExceeded(AssertionError):
    """Raised by capture_budget() when a scope captures more step
    programs than it declared, or one key twice."""


class _CaptureBudget:
    def __init__(self, budget: int):
        self.budget = budget
        self._before: Dict[tuple, int] = {}

    def __enter__(self) -> "_CaptureBudget":
        self._before = capture_counts()
        return self

    @property
    def spent(self) -> int:
        return (sum(capture_counts().values())
                - sum(self._before.values()))

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        after = capture_counts()
        new = {k: n - self._before.get(k, 0) for k, n in after.items()
               if n > self._before.get(k, 0)}
        twice = sorted(key[0] for key in new if after[key] > 1)
        spent = sum(new.values())
        if spent > self.budget or twice:
            detail = ", ".join(f"{label}@{n}x"
                               for (label, _sig), n in sorted(
                                   new.items(), key=lambda kv: kv[0][0]))
            raise CaptureBudgetExceeded(
                f"step capture budget exceeded: {spent} captures, declared "
                f"budget {self.budget}"
                + (f", captured again: {', '.join(twice)}" if twice else "")
                + f" ({detail})")


def capture_budget(budget: int) -> _CaptureBudget:
    """Context manager: fail if the enclosed scope captures more than
    ``budget`` step parts, or any key a second time."""
    return _CaptureBudget(budget)


class Packing:
    """Where each tensor of a fixed list (int32 or bool, any shapes)
    lies in one byte buffer: the int32 ones first, then the bool ones.
    ``pack`` writes them with two launches; ``unpack`` gives views."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.specs = [(tuple(t.shape), t.dtype) for t in tensors]
        other = {d for _, d in self.specs} - {torch.int32, torch.bool}
        if other:
            raise TypeError(f"Packing takes int32 and bool tensors, got "
                            f"{sorted(map(str, other))}")
        self.words = sum(math.prod(s) for s, d in self.specs
                         if d == torch.int32)
        self.nbytes = 4 * self.words + sum(
            math.prod(s) for s, d in self.specs if d == torch.bool)

    def pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        if [(tuple(t.shape), t.dtype) for t in tensors] != self.specs:
            raise ValueError("Packing: the tensors changed shape or dtype")
        buf = torch.empty(self.nbytes, dtype=torch.uint8,
                          device=tensors[0].device)
        words, flags = self._regions(buf)
        for dtype, out in ((torch.int32, words), (torch.bool, flags)):
            parts = [t.reshape(-1) for t in tensors if t.dtype == dtype]
            if parts:
                torch.cat(parts, out=out)
        return buf

    def _regions(self, buf: torch.Tensor):
        return (buf[:4 * self.words].view(torch.int32),
                buf[4 * self.words:].view(torch.bool))

    def unpack(self, buf: torch.Tensor) -> list:
        regions = dict(zip((torch.int32, torch.bool), self._regions(buf)))
        at = {torch.int32: 0, torch.bool: 0}
        out = []
        for shape, dtype in self.specs:
            n = math.prod(shape)
            out.append(regions[dtype][at[dtype]:at[dtype] + n].view(shape))
            at[dtype] += n
        return out


def encode_packed(results, observed=None) -> torch.Tensor:
    """The packed output of ``K`` results as one int32 buffer: the
    ``[5, B]`` rows of each, then the ``[12]`` aux rows of each
    (``observed``: each result's ``tel_observe`` count, or None)."""
    observed = observed or [None] * len(results)
    fields = [packed_fields(r, n) for r, n in zip(results, observed)]
    return torch.cat([t.reshape(-1) for f in fields for t in f[:5]]
                     + [t.reshape(-1) for f in fields for t in f[5:]])


def encode_observed(tables, results, stamps, now_us) -> torch.Tensor:
    """The packed boundary after ``K`` steps: with telemetry on
    (``now_us`` a 0-d tensor, else None) each result's wire latency is
    observed with its batch's 0-d ``stamps`` entry (graph.py
    ``tel_observe``), then the results are encoded (``encode_packed``)."""
    observed = None if now_us is None else [
        tel_observe(tables, r, stamp, now_us)
        for r, stamp in zip(results, stamps)]
    return encode_packed(results, observed)


def packed_views(words: torch.Tensor, batch: int, k: Optional[int] = None):
    """(out, aux) views of an ``encode_packed`` buffer: ``[5, B]`` and
    ``[12]``, or with ``k`` ``[K, 5, B]`` and ``[K, 12]``."""
    n = (k or 1) * 5 * batch
    out, aux = words[:n], words[n:]
    if k is None:
        return out.view(5, batch), aux
    return out.view(k, 5, batch), aux.view(k, -1)


class Part:
    """One piece of a program, ``fn(*args)``: run eagerly at its first
    call and captured right after (on CUDA), replayed from then on."""

    def __init__(self, label: str, sig: tuple, fn, cuda: bool):
        self.label, self.sig, self.fn, self.cuda = label, sig, fn, cuda
        self.built = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None           # the static outputs of the graph
        self.launches: Dict[object, int] = {}  # wrapper -> per replay
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.dump: Optional[str] = None  # its graph's DOT file, if dumped

    def __call__(self, args, static_args=None):
        """The part's outputs for ``args`` (the static ones once it is
        captured); ``static_args``: what the capture reads, where they
        differ from this first call's ``args``."""
        if self.graph is not None:
            self.graph.replay()
            for w, n in self.launches.items():
                w.launches += n
            self.replays += 1
            return self.out
        out = self.fn(*args)
        if not self.built:
            self.built = True
            _count(self.label, self.sig)
            if self.cuda:
                self._capture(args if static_args is None else static_args)
        return out

    def _capture(self, args) -> None:
        before = [w.launches for w in WRAPPERS]
        # a graph to dump keeps its nodes past the instantiation
        graph = torch.cuda.CUDAGraph(keep_graph=bool(debug_dump_dir))
        if debug_dump_dir:
            graph.enable_debug_mode()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        try:
            # thread_local: the IO pump's other threads (fetch workers,
            # the ring fetcher) may wait on events or copy results while
            # one thread captures; in the default "global" mode those
            # calls would fail or invalidate the capture
            with torch.cuda.graph(graph,
                                  capture_error_mode="thread_local"):
                out = self.fn(*args)
        finally:
            counted = [w.launches - n for w, n in zip(WRAPPERS, before)]
            for w, n in zip(WRAPPERS, before):
                w.launches = n
        if debug_dump_dir:  # else capture_end instantiated it
            graph.instantiate()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.launches = {w: n for w, n in zip(WRAPPERS, counted) if n}
        if debug_dump_dir:
            os.makedirs(debug_dump_dir, exist_ok=True)
            self.dump = os.path.join(debug_dump_dir,
                                     f"{self.label}-{next(_dumps)}.dot")
            graph.debug_dump(self.dump)
        self.graph, self.out = graph, out


def _decoder(form: str, overlay: bool):
    """``decode(x) -> (pkts, sidecar kwargs)`` of a program's static
    input: a packed batch, the ``[9, P]`` header columns, or with the
    overlay the ``[19, P]`` outer header, inner header and VNI row."""
    n = len(PacketVector._fields)
    if form != "plain":
        return lambda x: (packed_vector(x), {})
    if not overlay:
        return lambda x: (PacketVector(*x.unbind(0)), {})

    def decode(x):
        rows = x.unbind(0)
        return PacketVector(*rows[:n]), dict(
            ovl_inner=PacketVector(*rows[n:2 * n]), ovl_vni=rows[2 * n])
    return decode


class Program:
    """One step variant over one dataplane's live tables: static inputs
    (``x`` of ``shape``, ``now``, and the telemetry stamps), the parts,
    the copy-out (module doc). ``run`` returns the clone of the final
    part's output; ``result`` / ``packed`` read it."""

    def __init__(self, label: str, sig: tuple, tables, step, form: str,
                 shape, device: torch.device):
        self.tables, self.form = tables, form
        self.shape = tuple(shape)
        cuda = device.type == "cuda"
        self.now = torch.zeros((), dtype=torch.int32, device=device)
        self.x = torch.zeros(self.shape, dtype=torch.int32, device=device)
        # the latency histogram's inputs: packed and chain forms of a
        # telemetry step observe it (graph.py tel_observe)
        self.observes = (form != "plain"
                         and getattr(step, "tel_mode", "off") != "off")
        self.stamp = torch.zeros(self.shape[:1] if form == "chain" else (),
                                 dtype=torch.int32, device=device)
        self.now_us = torch.zeros((), dtype=torch.int32, device=device)
        self.packing: Optional[Packing] = None
        # dispatch flags read to the host (``replay`` on the auto path)
        self.host_reads = 0
        decode = _decoder(form, getattr(step, "overlay", "off") != "off")
        self._us = self.now_us if self.observes else None

        if form == "chain":
            def full(x, now):
                results = [step.full(tables, packed_vector(xk), now)
                           for xk in x.unbind(0)]
                return encode_observed(tables, results, self.stamp.unbind(0),
                                       self._us)
        else:
            def full(x, now):
                pkts, sidecar = decode(x)
                return self._encode(step.full(tables, pkts, now, **sidecar))
        self.prefix = self.fast = None
        if hasattr(step, "prefix"):
            if form == "chain":
                raise ValueError("the auto path's chain runs the packed "
                                 "program once a sub-batch")

            def prefix(x, now):
                pkts, sidecar = decode(x)
                return step.prefix(tables, pkts, now, **sidecar)
            self.prefix = Part(f"{label}:prefix", sig, prefix, cuda)

            def fast(pre, now):
                return self._encode(step.fast(tables, pre, now))

            def full(pre, now):
                return self._encode(step.slow(tables, pre, now))
            self.fast = Part(f"{label}:fast", sig, fast, cuda)
            label = f"{label}:full"
        self.full = Part(label, sig, full, cuda)

    def parts(self):
        return [p for p in (self.prefix, self.fast, self.full)
                if p is not None]

    def holds(self, tables) -> bool:
        """Whether ``tables`` are exactly the tensors the graphs read."""
        return len(tables) == len(self.tables) and all(
            a is b for a, b in zip(tables, self.tables))

    def _encode(self, res) -> torch.Tensor:
        if self.form != "plain":
            return encode_observed(self.tables, [res], [self.stamp],
                                   self._us)
        fields = result_fields(res)
        if self.packing is None:
            self.packing = Packing(fields)
        return self.packing.pack(fields)

    def run(self, now: int, load, stamp=0, now_us: int = 0) -> torch.Tensor:
        """Copy in (``now``, then ``load(x)`` writes the batch, and for
        an observing program ``stamp`` — an int, or K of them for a
        chain — and ``now_us``), run the parts, and return the clone of
        the output."""
        self.now.fill_(now)
        load(self.x)
        if self.observes:
            if self.form == "chain":
                self.stamp.copy_(torch.as_tensor(stamp, dtype=torch.int32))
            else:
                self.stamp.fill_(stamp)
            self.now_us.fill_(now_us)
        return self.replay().clone()

    def replay(self) -> torch.Tensor:
        """Run the parts on the static inputs as they stand; returns the
        final part's output itself (graph memory once captured: the
        next replay overwrites it)."""
        args = (self.x, self.now)
        if self.prefix is None:
            return self.full(args)
        pre = self.prefix(args)
        # the auto path's one host sync; either tier reads the
        # prefix's outputs
        tier = self.fast if bool(pre.ok) else self.full
        self.host_reads += 1
        return tier((pre, self.now), (self.prefix.out, self.now))

    def prime(self, mutable: Sequence[str]) -> int:
        """Build every part without stepping the tables: on an
        all-invalid batch, run each part once (eagerly, its warm-up) and
        capture it — on the auto path both tiers, whatever the flag
        says — then write the ``mutable`` fields back as they were.
        Returns the parts built. So a caller can capture everything
        before other threads touch the card (the IO pump's ``warm``)."""
        todo = [p for p in self.parts() if not p.built]
        if not todo:
            return 0
        saved = {f: getattr(self.tables, f).clone() for f in mutable}
        for t in (self.x, self.now, self.stamp, self.now_us):
            t.zero_()
        args = (self.x, self.now)
        if self.prefix is None:
            self.full(args)
        else:
            pre = self.prefix(args)
            static = (self.prefix.out, self.now)
            for tier in (self.fast, self.full):
                if not tier.built:
                    tier((pre, self.now), static)
        for f, v in saved.items():
            getattr(self.tables, f).copy_(v)
        return len(todo)

    def result(self, buf: torch.Tensor):
        """The StepResult of a ``plain`` program's output."""
        return result_of(self.packing.unpack(buf), self.tables)

    def packed(self, buf: torch.Tensor):
        """(out, aux) of a ``packed`` or ``chain`` program's output."""
        k = self.shape[0] if self.form == "chain" else None
        return packed_views(buf, self.shape[-1], k)


class RingProgram:
    """The ring form: the counterpart of the reference's window program
    (``vpp_tpu/pipeline/dataplane.py`` ``_ring_call``), one window of up
    to ``slots`` packed frames over one set of tables.

    Device buffers: ``rx`` is one int32 window in the layout of the
    host's staging window (io/rings.py ``DeviceDescRing``): ``rx_ring
    [S, 5, B]``, ``rx_now [S]``, ``rx_stamp [S]``, so a window arrives
    in ONE copy; ``out`` holds S records of ``[5 * B + 12]`` words (a
    slot's packed rows, then its aux rows) and, with telemetry on, the
    ``pack_tel_rider`` words, so it leaves in ONE copy; ``cursor`` is
    the device frame cursor (0-d int32). ``run(n)`` steps exactly ``n``
    slots, as the reference's ``while_loop`` on ``head < rx_tail``
    does: each slot's frame, clock and stamp are copied into the packed
    program's static inputs on the device, its parts replayed (on the
    auto path with the dispatch flag read to the host between them),
    and its output copied into the slot's record; records ``n..S-1``
    stay zero, as the reference's ``zeros_like`` starts; then the
    cursor advances by ``n`` and the rider is packed. One capture per
    step variant serves every fill."""

    def __init__(self, packed: Program, slots: int, tel_width: int = 0):
        from vpp_tpu_torch.pipeline.dataplane import PACKED_AUX_ROWS

        self.prog, self.tables = packed, packed.tables
        self.slots, self.batch = int(slots), packed.shape[-1]
        self.shape = (self.slots,) + packed.shape
        dev = packed.x.device
        s, per = self.slots, 5 * self.batch
        self.rx = torch.zeros(s * (per + 2), dtype=torch.int32, device=dev)
        self.rx_ring = self.rx[:s * per].view(s, 5, self.batch)
        self.rx_now = self.rx[s * per:s * per + s]
        self.rx_stamp = self.rx[s * per + s:]
        self.record = per + PACKED_AUX_ROWS
        self.out = torch.zeros(s * self.record + tel_width,
                               dtype=torch.int32, device=dev)
        self._records = self.out[:s * self.record].view(s, self.record)
        self.tel = self.out[s * self.record:] if tel_width else None
        self.cursor = torch.zeros((), dtype=torch.int32, device=dev)
        self.live = False  # checked out by a running ring (dataplane.py)

    def parts(self):
        return self.prog.parts()

    def holds(self, tables) -> bool:
        return self.prog.holds(tables)

    def prime(self, mutable: Sequence[str]) -> int:
        return self.prog.prime(mutable)

    def run(self, n: int, now_us: int = 0) -> torch.Tensor:
        """Step slots ``0..n-1`` of ``rx`` (class doc); ``now_us`` is
        the window's dispatch clock (telemetry). Returns ``out``."""
        if not 0 <= n <= self.slots:
            raise ValueError(f"ring window fill {n} outside 0..{self.slots}")
        p = self.prog
        if n < self.slots:
            self._records[n:].zero_()
        if p.observes:
            p.now_us.fill_(now_us)
        for i in range(n):
            p.x.copy_(self.rx_ring[i])
            p.now.copy_(self.rx_now[i])
            if p.observes:
                p.stamp.copy_(self.rx_stamp[i])
            self._records[i].copy_(p.replay())
        self.cursor.add_(n)
        if self.tel is not None:
            from vpp_tpu_torch.ops.telemetry import pack_tel_rider

            pack_tel_rider(self.tables, out=self.tel)
        return self.out

    def views(self, out):
        """``(tx_ring [S, 5, B], aux_ring [S, 12], rider or None)`` of an
        ``out`` buffer (the device tensor, or its host copy as numpy)."""
        s, per = self.slots, 5 * self.batch
        recs = out[:s * self.record].reshape(s, self.record)
        tx = recs[:, :per].reshape(s, 5, self.batch)
        tel = out[s * self.record:] if self.tel is not None else None
        return tx, recs[:, per:], tel
