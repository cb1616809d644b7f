"""The Dataplane: table epochs, interface registry and the step entries.

The PyTorch counterpart of ``vpp_tpu/pipeline/dataplane.py``
``Dataplane``: the same registry (uplink, host and pod interfaces, ACL
table slots), the same epoch ``swap`` (the staged configuration is
uploaded and the live session state carried over by reference), the
same selection ladders re-gated at every swap, and the same
``process`` / ``probe`` / ``process_packed`` / ``process_packed_chain``
entries, with the reference's bit-packed ``[5, B]`` boundary and its
numpy helpers (``PACKED_*``, ``packed_input_zeros``,
``pack_packet_columns``, ``unpack_packet_input``,
``unpack_packet_result``).

``Dataplane(config, device=None, graphs=True)`` runs on the card:
``device`` None resolves to ``cuda`` and raises when no GPU is present.
Tests pass ``device="cpu"``, where every kernel wrapper takes its plain
version.

The step program cache (pipeline/capture.py) is the counterpart of the
reference's jit cache: with ``graphs`` (the default) ``process``,
``process_packed`` and ``process_packed_chain`` run each step variant
through one ``Program`` per key — captured CUDA graphs on the card, the
same buffers without graphs on the CPU — and ``graphs=False`` runs each
step eagerly, op by op. ``probe`` and ``process_packed(commit=False)``
run eagerly on clones of the mutable state. The clock reaches the
device as a 0-d int32 tensor, as the reference passes ``jnp.int32``.

With the fast path engaged (``fastpath=True``, the default, and at
least ``fastpath_min_rules`` global rules — re-gated at every swap)
the stepping entries run the two-tier dispatcher, which reads its
dispatch flag to the host once per step (pipeline/graph.py
``pipeline_step_auto``); the full chain alone never synchronises.
``probe`` always runs the full chain, as the reference's does, and
runs it under ``_lock``, so a concurrent ``swap`` (which writes the
configuration tensors in place) can never hand it parts of two epochs.

The ML stage engages only once a model is staged (``ml_stage`` is the
ceiling; the staged kind picks the MLP or the forest variant, re-gated
at every swap). With ``telemetry`` on, ``process_packed`` /
``process_packed_chain`` take the rx stamps (``stamp_us`` /
``stamps_us``) and the dispatch clock ``now_us`` and observe the wire
latency on the device; ``telemetry_snapshot`` reads the bins and the
top-K rows back, never the sketch.

Tenancy (``tenancy: on``) and the overlay (``overlay: vxlan``) are
config gates like telemetry. ``tenant_snapshot`` reads the per-tenant
planes and the per-tenant live session counts (one prefix sum on the
device); ``process`` takes the overlay's inner-header sidecar
(``ovl_inner``, ``ovl_vni``) and returns the outer headers it built;
``set_vtep`` / ``encap_remote`` and ``fib_snapshot`` are the
reference's. Under the overlay the packed forms raise the reference's
``ValueError``: the packed boundary has no lane for the sidecar.

``swap`` ships only the dirty upload groups, into the tensors the
captured programs hold (pipeline/tables.py); ``adopt_sessions`` writes
restored or migrated session columns into the live ones the same way
(pipeline/snapshot.py), so neither recaptures anything. The bytes
they move are counted in pipeline/transfer.py (the reference keeps that
accounting in its dataplane module).

The ring form (the reference's ``_ring_call`` window program) is a
``capture.RingProgram`` over the packed program of the selection, and
only ever over a PRIVATE clone of the tables: ``ring_checkout`` hands
the IO pump's persistent ring the current selection's one, kept with its
captured programs across ring restarts (pipeline/persistent.py);
``graft`` writes the ring's state back into the live tensors in place.
``prime`` captures a form's parts without stepping (the pump's ``warm``).

The observability surface the agent, the collector and the CLI read is
the reference's: ``enable_journal`` records every epoch's builder ops
into a ``TxnJournal`` (pipeline/txn.py) inside ``swap``; ``swap`` runs in
an ``epoch-swap`` span (trace/spans.py) and observes
``txn_commit_hist``, ``propagation_hist`` and ``fib_churn_hist`` when a
collector has set them; ``tracer`` (trace/tracer.py) is offered every
``process`` result; ``on_if_freed`` observers hear of every freed pod
interface; ``kernel_snapshot`` says which rung each ladder chose and why;
``time_classifier`` times the selected global classifier alone.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Dict, Optional

import numpy as np
import torch

from vpp_tpu_torch.ir.rule import PodID
from vpp_tpu_torch.ops.lpm import lpm_plane_bytes
from vpp_tpu_torch.ops.session import session_expire, sweep_covered
from vpp_tpu_torch.ops.telemetry import tel_clock_us, tel_rider_width
from vpp_tpu_torch.ops.vxlan import vxlan_encap
from vpp_tpu_torch.pipeline import capture
from vpp_tpu_torch.pipeline.graph import (
    StepResult,
    make_pipeline_step,
    packed_vector,
)
from vpp_tpu_torch.pipeline.selection import (
    select_fib_impl,
    select_impl,
    select_session_impl,
)
from vpp_tpu_torch.pipeline.tables import (
    FIB_STATE_FIELDS,
    SESSION_FIELDS,
    TELEMETRY_FIELDS,
    TENANCY_STATE_FIELDS,
    DataplaneConfig,
    InterfaceType,
    TableBuilder,
    resolve_device,
    restored_sessions,
    tel_capacity,
)
from vpp_tpu_torch.pipeline.transfer import count_device_transfer
from vpp_tpu_torch.pipeline.vector import Disposition, PacketVector
from vpp_tpu_torch.trace import spans

# every state field a step writes in place; ``probe`` and
# ``process_packed(commit=False)`` run on copies of them
_MUTABLE_FIELDS = (tuple(SESSION_FIELDS) + tuple(TELEMETRY_FIELDS)
                   + tuple(TENANCY_STATE_FIELDS) + ("fib_ecmp_c",))

# --- the bit-packed boundary (the reference's numpy surface) ------------

# packed-boundary shape: [PACKED_IN_ROWS, B] in, [PACKED_OUT_ROWS_N, B] out
PACKED_IN_ROWS = 5
PACKED_OUT_ROWS_N = 5
# The aux rider's row names, IN ORDER (graph.py ``packed_fields`` builds
# the rows): the two-tier dispatch trio, session-table pressure, the ML
# verdicts, device telemetry and tenancy.
PACKED_AUX_SCHEMA = (
    "fastpath", "rx", "sess_hits",
    "insert_fails", "evictions",
    "ml_scored", "ml_flagged", "ml_drops",
    "tel_observed", "tel_sketched",
    "tnt_limited", "tnt_qfail",
)
PACKED_AUX_ROWS = len(PACKED_AUX_SCHEMA)


def packed_input_zeros(n: int):
    """An all-invalid packed input batch (flags=0) — the pre-compile /
    warm-up argument for ``process_packed``."""
    return np.zeros((PACKED_IN_ROWS, n), np.int32)


def pack_packet_columns(fu, cols, n: int, off: int = 0) -> None:
    """Pack ring columns into a packed input batch. ``fu`` is the uint32
    view of a [5, B] int32 batch; writes packets [off, off+n)."""
    def u(name):
        return cols[name][:n].view(np.uint32)

    fu[0, off:off + n] = u("src_ip")
    fu[1, off:off + n] = u("dst_ip")
    fu[2, off:off + n] = (u("sport") << 16) | (u("dport") & 0xFFFF)
    fu[3, off:off + n] = (
        ((u("pkt_len") & 0xFFFF) << 16) | ((u("proto") & 0xFF) << 8)
        | (u("ttl") & 0xFF)
    )
    fu[4, off:off + n] = (u("rx_if") << 8) | (u("flags") & 0xFF)


def unpack_packet_input(flat) -> dict:
    """Host-side inverse of ``pack_packet_columns``: decode a [5, B]
    packed input batch back into named PacketVector column arrays."""
    fu = flat.view(np.uint32)
    return {
        "src_ip": fu[0],
        "dst_ip": fu[1],
        "proto": ((fu[3] >> 8) & 0xFF).astype(np.int32),
        "sport": (fu[2] >> 16).astype(np.int32),
        "dport": (fu[2] & 0xFFFF).astype(np.int32),
        "ttl": (fu[3] & 0xFF).astype(np.int32),
        "pkt_len": (fu[3] >> 16).astype(np.int32),
        "rx_if": (fu[4] >> 8).astype(np.int32),
        "flags": (fu[4] & 0xFF).astype(np.int32),
    }


def unpack_packet_result(out) -> dict:
    """Decode a fetched [5, B] packed result into named host arrays.
    ``out`` must be a writable int32 array. tx_if 0xFFFF decodes to -1
    (no egress interface)."""
    if out.shape[0] != PACKED_OUT_ROWS_N:
        raise ValueError(f"packed result of shape {out.shape}, expected "
                         f"{PACKED_OUT_ROWS_N} rows")
    ou = out.view(np.uint32)
    row3 = ou[3]
    tx_if = (row3 & 0xFFFF).astype(np.int32)
    tx_if[tx_if == 0xFFFF] = -1
    return {
        "src_ip": ou[0],
        "dst_ip": ou[1],
        "sport": (ou[2] >> 16).astype(np.int32),
        "dport": (ou[2] & 0xFFFF).astype(np.int32),
        "ttl": ((row3 >> 16) & 0xFF).astype(np.int32),
        "disp": ((row3 >> 24) & 0xF).astype(np.int32),
        "drop_cause": (row3 >> 28).astype(np.int32),
        "tx_if": tx_if,
        "next_hop": ou[4],
    }


def _i32(v: int) -> int:
    """An int as the int32 it wraps to (the reference's ``jnp.int32``)."""
    return ((int(v) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class _PinnedUpload:
    """Host-to-device copies of packed batches through pinned staging
    buffers, non-blocking: two buffers per shape, used in turn, each
    refilled only once the copy out of it has finished (its event)."""

    def __init__(self):
        self._slots: Dict[tuple, list] = {}  # shape -> [next, slot, slot]

    def __call__(self, arr: np.ndarray, dest: torch.Tensor) -> None:
        ring = self._slots.get(arr.shape)
        if ring is None:
            ring = self._slots[arr.shape] = [0] + [
                [torch.empty(arr.shape, dtype=torch.int32, pin_memory=True),
                 None] for _ in range(2)]
        ring[0] ^= 1
        slot = ring[1 + ring[0]]
        buf, done = slot
        if done is not None and not done.query():
            done.synchronize()
        buf.numpy()[...] = arr
        dest.copy_(buf, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()


class Dataplane:
    TICKS_PER_SEC = 10

    def __init__(self, config: Optional[DataplaneConfig] = None,
                 device=None, graphs: bool = True):
        self.device = resolve_device(device)
        # the step program cache (module doc): key -> capture.Program
        self.graphs = bool(graphs)
        self._programs: Dict[tuple, capture.Program] = {}
        # the ring program over a private table clone, with its key:
        # only the current selection's is kept (ring_checkout)
        self._ring: Optional[tuple] = None
        self._owner = capture.new_owner()
        self._signed = (None, ())  # (tables, their table_signature)
        self._upload = _PinnedUpload()
        self.config = config or DataplaneConfig()
        self.builder = TableBuilder(self.config, device=self.device)
        self.tables = self.builder.to_device()
        self.epoch = 0
        self._lock = threading.RLock()
        self.commit_lock = self._lock
        c = self.config
        self.classifier = c.classifier
        self.mxu_threshold = 512
        self.bv_min_rules = int(c.classifier_bv_min_rules)
        self.fib_impl_knob = c.fib_impl
        self.fib_lpm_min_routes = int(c.fib_lpm_min_routes)
        self.session_impl_knob = c.session_impl
        # the two-tier dispatch: master switch + rule-count gate
        self.fastpath_enabled = bool(c.fastpath)
        self.fastpath_min_rules = int(c.fastpath_min_rules)
        self._use_fastpath = False
        self._sess_hash = c.sess_hash
        self._sweep_stride = int(c.sess_sweep_stride)
        # the ML stage's ceiling; it engages once a model is staged
        self.ml_stage = c.ml_stage
        self._ml_mode = "off"
        self._ml_kind = "mlp"
        self._tel_mode = c.telemetry
        # tenancy and the overlay: config gates (their planes' shapes
        # are config-static; an unstaged tenancy-on dataplane forwards
        # as tenancy off does)
        self._tnt_mode = c.tenancy
        self._overlay = c.overlay
        self._vtep: Optional[int] = None
        self._classifier_impl = "dense"
        self._fib_impl = "dense"
        self._session_impl = "gather"
        self._skip_local = True
        # the route-churn histogram (the collector's
        # vpp_tpu_fib_churn_commit_seconds): every swap that re-shipped
        # FIB state observes the FIB upload's cost
        self.fib_churn_hist = None
        self._refresh_selection()
        # time_classifier's accumulators (the collector's
        # stage="classify" row and `show acl`)
        self.classify_seconds = 0.0
        self.classify_ns_pkt: Optional[float] = None
        self._t0 = _time.monotonic()
        self._now = 0
        self._steps_since_expire = 0
        # interface registry (if 0 stays reserved as "unset")
        self.pod_if: Dict[PodID, int] = {}
        self.if_pod: Dict[int, PodID] = {}
        self._free_ifs = list(range(c.max_ifaces - 1, 0, -1))
        self.uplink_if: Optional[int] = None
        self.host_if: Optional[int] = None
        # ACL table slot registry (renderer table id -> slot)
        self.table_slots: Dict[str, int] = {}
        self._free_slots = list(range(c.max_tables - 1, -1, -1))
        # the packet tracer (trace/tracer.py), offered every processed
        # frame (it captures only while armed)
        self.tracer = None
        # the config transaction journal (enable_journal)
        self.journal = None
        # callbacks of a freed pod interface slot (the collector zeroes
        # its accumulators so a pod reusing the slot starts clean)
        self.on_if_freed = []
        # the collector's histograms: every swap's publish duration, and
        # the config propagation (event wall clock to swap complete)
        # of a swap under an active span trace
        self.txn_commit_hist = None
        self.propagation_hist = None

    # --- interfaces ---
    def add_uplink(self) -> int:
        with self._lock:
            if self.uplink_if is None:
                self.uplink_if = self._free_ifs.pop()
                self.builder.set_interface(
                    self.uplink_if, InterfaceType.UPLINK, apply_global=True)
            return self.uplink_if

    def add_host_interface(self) -> int:
        with self._lock:
            if self.host_if is None:
                self.host_if = self._free_ifs.pop()
                self.builder.set_interface(self.host_if, InterfaceType.HOST)
            return self.host_if

    def add_pod_interface(self, pod: PodID) -> int:
        with self._lock:
            if pod in self.pod_if:
                return self.pod_if[pod]
            if not self._free_ifs:
                raise RuntimeError("interface table full")
            idx = self._free_ifs.pop()
            self.pod_if[pod] = idx
            self.if_pod[idx] = pod
            self.builder.set_interface(idx, InterfaceType.POD)
            return idx

    def del_pod_interface(self, pod: PodID) -> bool:
        with self._lock:
            idx = self.pod_if.pop(pod, None)
            if idx is None:
                return False
            del self.if_pod[idx]
            self.builder.set_interface(idx, InterfaceType.NONE,
                                       local_table=-1)
            self._free_ifs.append(idx)
            observers = list(self.on_if_freed)
        for cb in observers:
            cb(idx)
        return True

    # --- ACL table slots ---
    def alloc_table_slot(self, table_id: str) -> int:
        with self._lock:
            if table_id in self.table_slots:
                return self.table_slots[table_id]
            if not self._free_slots:
                raise RuntimeError("ACL table slots exhausted")
            slot = self._free_slots.pop()
            self.table_slots[table_id] = slot
            return slot

    def free_table_slot(self, table_id: str) -> None:
        with self._lock:
            slot = self.table_slots.pop(table_id, None)
            if slot is not None:
                self.builder.clear_local_table(slot)
                self._free_slots.append(slot)

    def assign_pod_table(self, pod: PodID, table_id: Optional[str]) -> None:
        """Point the pod's interface at a local ACL table (or none)."""
        with self._lock:
            idx = self.pod_if.get(pod)
            if idx is None:
                return
            slot = self.table_slots.get(table_id, -1) if table_id else -1
            self.builder.set_if_local_table(idx, slot)

    # --- epochs ---
    def enable_journal(self, path: Optional[str]) -> None:
        """Turn on the config transaction trace: builder mutations are
        recorded and journaled per epoch swap (JSONL at ``path``; None:
        an in-memory count only). Replaying the journal onto a fresh
        builder reproduces the table history this dataplane enforced."""
        from vpp_tpu_torch.pipeline.txn import TxnJournal

        with self._lock:
            self.journal = TxnJournal(path)
            self.builder.start_recording()

    def swap(self) -> int:
        """Publish the staged configuration as a new table epoch; the
        live session state carries over by reference, and every staged
        tensor whose shape and dtype are unchanged is written into the
        live one in place, so the captured programs stay valid; those
        that no longer hold the live tables are dropped. With a journal
        the ops staged since the last swap are recorded under the lock,
        in epoch order. The swap runs in an ``epoch-swap`` span and
        feeds the collector's histograms when they are set."""
        span = spans.RECORDER.begin("swap", "epoch-swap")
        try:
            with self._lock:
                self.tables = self.builder.to_device(sessions=self.tables,
                                                     into=self.tables)
                self._refresh_selection()
                self._programs = {k: p for k, p in self._programs.items()
                                  if p.holds(self.tables)}
                if (self.fib_churn_hist is not None
                        and self.builder.fib_last_shipped):
                    self.fib_churn_hist.observe(float(
                        self.builder.fib_upload.get("ms", 0.0)) / 1e3)
                self.epoch += 1
                span.attrs["epoch"] = self.epoch
                span.name = f"epoch {self.epoch}"
                if self.journal is not None:
                    txn = self.builder.drain_recording()
                    if txn is not None:
                        self.journal.record(txn, self.epoch)
                epoch = self.epoch
        finally:
            # the enclosing trace's root (a KSR event, a CNI add) holds
            # the config event's time; a swap that is the root itself
            # has no propagation to measure
            root = spans.current_root()
            spans.RECORDER.end(span)
        if self.txn_commit_hist is not None and span.done:
            self.txn_commit_hist.observe(span.duration)
        if (self.propagation_hist is not None and root is not None
                and root is not span):
            self.propagation_hist.observe(_time.time() - root.t_wall,
                                          source=root.stage)
        return epoch

    def adopt_sessions(self, sessions) -> int:
        """Publish restored session state into the live tables (the
        snapshot restore and range-migration path, pipeline/snapshot.py).
        ``sessions`` is a ``{field: host array}`` mapping of
        SESSION_FIELDS, checked as ``to_device(sessions=...)`` checks it;
        each column is written into the live tensor, and the telemetry,
        tenancy-state and ECMP-accounting planes are zeroed in place (the
        reference cold-starts them on this path), so the captured
        programs are kept. The epoch bumps. Call after the base-config
        swap and before traffic: nothing staged is published."""
        arrays = restored_sessions(self.config, sessions)
        count_device_transfer("adopt", arrays, "h2d")
        with self._lock:
            t = self.tables
            for f, a in arrays.items():
                src = torch.from_numpy(a.view(np.int32) if a.dtype
                                       == np.uint32 else a)
                getattr(t, f).copy_(src)
            for f in (tuple(TELEMETRY_FIELDS) + tuple(TENANCY_STATE_FIELDS)
                      + tuple(FIB_STATE_FIELDS)):
                getattr(t, f).zero_()
            self.epoch += 1
            return self.epoch

    # --- time base ---
    def clock_ticks(self) -> int:
        """Monotonic wall-clock ticks since this dataplane started."""
        return int((_time.monotonic() - self._t0) * self.TICKS_PER_SEC)

    def advance_clock(self, seconds: float) -> None:
        """Shift the time base forward (tests simulate idle periods)."""
        self._t0 -= seconds

    def expire_sessions(self, max_age: Optional[int] = None,
                        lazy: bool = False) -> int:
        """Invalidate reflective + NAT sessions idle for more than
        ``max_age`` ticks; returns how many expired. ``lazy=True``
        skips the bulk pass when the in-step sweep has covered the
        whole ring since the last call."""
        if max_age is None:
            max_age = self.config.sess_max_age
        with self._lock:
            if lazy and max_age == self.config.sess_max_age:
                steps = self._steps_since_expire
                self._steps_since_expire = 0
                if sweep_covered(steps, self._sweep_stride, self.tables):
                    return 0
            self._now = max(self._now, self.clock_ticks())
            before = self.tables
            after = session_expire(before, self._now, max_age)
            expired = int(
                (before.sess_valid - after.sess_valid).sum()
                + (before.natsess_valid - after.natsess_valid).sum())
            if expired:
                # into the live columns: the captured programs hold them
                before.sess_valid.copy_(after.sess_valid)
                before.natsess_valid.copy_(after.natsess_valid)
        return expired

    # --- selection ---
    @property
    def classifier_impl(self) -> str:
        return self._classifier_impl

    @property
    def fib_impl(self) -> str:
        return self._fib_impl

    @property
    def session_impl(self) -> str:
        return self._session_impl

    def _kernels_serve(self) -> bool:
        """The ladders' ``pallas_ok`` bit: the CUDA kernels serve only
        on a CUDA device."""
        return self.device.type == "cuda"

    def _refresh_selection(self) -> None:
        """Re-gate the per-epoch choices against the staged builder:
        the three ladders, the policy-free local-classify skip, the
        fast-path engagement and the ML stage (on only with a model
        staged, in the variant of its kind)."""
        b = self.builder
        self._ml_mode = self.ml_stage if b.ml_kind_name else "off"
        self._ml_kind = b.ml_kind_name or "mlp"
        p_ok = self._kernels_serve()
        self._classifier_impl = select_impl(
            self.classifier, b.bv_ok(), b.mxu_enabled and b.glb_mxu.ok,
            b.glb_nrules, self.bv_min_rules, self.mxu_threshold,
            pallas_ok=p_ok)
        self._skip_local = bool((b.if_local_table < 0).all())
        self._use_fastpath = (self.fastpath_enabled
                              and b.glb_nrules >= self.fastpath_min_rules)
        self._fib_impl = select_fib_impl(
            self.fib_impl_knob, b.lpm_ok(), b.fib_route_count(),
            self.fib_lpm_min_routes, pallas_ok=p_ok)
        self._session_impl = select_session_impl(self.session_impl_knob,
                                                 p_ok)

    def kernel_snapshot(self) -> dict:
        """Which rung each hot op's ladder selected, the operator's knob
        and why (the eligibility bit that decided), read under the lock:
        the reference's keys and values, with the CUDA device and
        ``_kernels_serve()`` where the reference names the TPU backend
        and the Pallas import."""
        with self._lock:
            b = self.builder
            p_ok = self._kernels_serve()

            def why(impl, knob, eligible, reason_ineligible):
                if impl == "pallas":
                    return "cuda device + structure eligible"
                if knob == impl:
                    return "explicit knob"
                if not p_ok:
                    return "no cuda device (the kernel rung needs one)"
                if not eligible:
                    return reason_ineligible
                return "ladder heuristic"

            return {
                "backend": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
                "pallas_available": p_ok,
                "classifier": {
                    "impl": self._classifier_impl,
                    "knob": self.classifier,
                    "why": why(self._classifier_impl, self.classifier,
                               b.bv_ok(), "bv structure ineligible"),
                },
                "fib": {
                    "impl": self._fib_impl,
                    "knob": self.fib_impl_knob,
                    "why": why(self._fib_impl, self.fib_impl_knob,
                               b.lpm_ok(), "lpm planes ineligible"),
                },
                "session": {
                    "impl": self._session_impl,
                    "knob": self.session_impl_knob,
                    # always eligible: no memory-budget gate here
                    # (pipeline/selection.py)
                    "why": why(self._session_impl, self.session_impl_knob,
                               True, ""),
                },
            }

    def time_classifier(self, batch: int = 256, iters: int = 10) -> float:
        """Time the selected global classifier alone over a synthetic
        batch from the uplink and return ns/packet (CUDA events on the
        card: the ``pallas`` rung launches ``bv_first_set``, ``mxu``
        ``mxu_first_match``; the wall clock on the CPU). Accumulates the
        seconds into ``classify_seconds`` and records
        ``classify_ns_pkt``. A diagnostic, not hot-path work."""
        from vpp_tpu_torch.pipeline.graph import _classifier_fns
        from vpp_tpu_torch.pipeline.vector import make_packet_vector

        with self._lock:
            tables = self.tables
            impl = self._classifier_impl
        fn = _classifier_fns(impl)[0]
        uplink = self.uplink_if if self.uplink_if is not None else 0
        pkts = make_packet_vector(
            [{"src": "172.16.0.9", "dst": "10.1.1.2", "proto": 6,
              "sport": 40000 + i, "dport": 8000 + (i % 20),
              "rx_if": uplink} for i in range(min(batch, 64))],
            n=batch, device=self.device)
        cuda = self.device.type == "cuda"
        fn(tables, pkts)  # the first call builds the kernels (warm)
        if cuda:
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
        else:
            t0 = _time.perf_counter()
        for _ in range(iters):
            fn(tables, pkts)
        if cuda:
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3
        else:
            dt = _time.perf_counter() - t0
        self.classify_seconds += dt
        self.classify_ns_pkt = dt / iters / batch * 1e9
        return self.classify_ns_pkt

    def _get_step(self, fast: bool, skip_local: Optional[bool] = None):
        """The step variant of the current selection (``fast``: the
        two-tier dispatcher). Call under ``_lock``."""
        return make_pipeline_step(
            self._classifier_impl,
            self._skip_local if skip_local is None else skip_local, fast,
            self._sweep_stride, ml_mode=self._ml_mode,
            ml_kind=self._ml_kind, tel_mode=self._tel_mode,
            tnt_mode=self._tnt_mode, fib_impl=self._fib_impl,
            sess_impl=self._session_impl, sess_hash=self._sess_hash,
            overlay=self._overlay)

    def _key(self, fast: bool, skip: bool, form: str, shape) -> tuple:
        """The cache key of a program of the current selection: the step
        variant (classifier, local-skip, tier, form and every gate), the
        input shape and the table signature. Call under ``_lock``."""
        if self._signed[0] is not self.tables:
            self._signed = (self.tables,
                            capture.table_signature(self.tables))
        return (self._classifier_impl, skip, fast, form, self._sweep_stride,
                self._fib_impl, self._session_impl, self._sess_hash,
                self._ml_mode, self._ml_kind, self._tel_mode,
                self._tnt_mode, self._overlay, tuple(shape),
                self._signed[1])

    def _program(self, fast: bool, form: str, shape):
        """The step program of the current selection for inputs of
        ``shape`` (``form``: plain, packed or chain; the ring form is
        checked out with ``ring_checkout``), built on first use. As the
        reference's ``_get_step`` does, a policy-free epoch keeps the
        program with the local classify where that one exists rather
        than capture the skip variant too: its results are the same.
        Call under ``_lock``."""
        self._plain_only(form)
        if form not in ("plain", "packed", "chain"):
            raise ValueError(f"unknown step form {form!r}" + (
                " (a ring window program is checked out with "
                "ring_checkout)" if form == "ring" else ""))
        shape = tuple(shape)
        skip = self._skip_local
        if skip and self._key(fast, True, form, shape) not in self._programs \
                and self._key(fast, False, form, shape) in self._programs:
            skip = False
        key = self._key(fast, skip, form, shape)
        prog = self._programs.get(key)
        if prog is None or not prog.holds(self.tables):
            prog = self._new_program(self.tables, fast, skip, form, shape)
            self._programs[key] = prog
        return prog

    def _new_program(self, tables, fast: bool, skip: bool, form: str,
                     shape, private: bool = False):
        """A program of the current selection over ``tables`` (``private``:
        a ring's clone, a capture key of its own)."""
        step = self._get_step(fast, skip)
        sig = (self._owner, shape, capture.table_signature(tables)) + (
            ("private",) if private else ())
        if form != "ring":
            return capture.Program(
                capture.step_label(step, form, self._sweep_stride), sig,
                tables, step, form, shape, self.device)
        slots, batch = shape[0], shape[-1]
        packed = capture.Program(
            capture.step_label(step, f"ring{slots}", self._sweep_stride),
            sig, tables, step, "packed", (PACKED_IN_ROWS, batch),
            self.device)
        width = 0
        if self._tel_mode != "off":
            nb, _d, _w, k = tel_capacity(self.config)
            width = tel_rider_width(nb, k)
        return capture.RingProgram(packed, slots, width)

    def ring_checkout(self, slots: int, batch: int) -> capture.RingProgram:
        """The ring program of the current selection over a PRIVATE
        clone of the tables, for one live ring at a time (the reference
        copies the tables once at a ring's start, so ``self.tables``
        stays at launch state until the ring's state is grafted back).
        Captured graphs bind tensor addresses, so the clone is kept with
        its programs under the key of ``_program``'s (the selection, the
        geometry, the table signature): a restart that changes no shape
        writes the epoch's tables into the held clone (``copy_``, under
        ``_lock``) and captures nothing. Only the current key's ring is
        kept: a checkout under another key drops the held clone and its
        graphs. Under the overlay it raises the reference's
        ``ValueError``. Return it with ``ring_checkin``."""
        with self._lock:
            self._plain_only("ring")
            fast = self._use_fastpath
            shape = (int(slots), PACKED_IN_ROWS, int(batch))
            key = self._key(fast, self._skip_local, "ring", shape)
            if self._ring is not None and self._ring[0] == key:
                ring = self._ring[1]
                if ring.live:
                    raise RuntimeError("a ring of this selection is "
                                       "already live on this dataplane")
                for mine, live in zip(ring.tables, self.tables):
                    mine.copy_(live)
                ring.cursor.zero_()
            else:
                self._ring = None  # the old clone goes before the new one
                clone = self.tables._replace(**{
                    f: getattr(self.tables, f).clone()
                    for f in self.tables._fields})
                ring = self._new_program(clone, fast, self._skip_local,
                                         "ring", shape, private=True)
                self._ring = (key, ring)
            ring.live = True
            return ring

    @staticmethod
    def ring_checkin(ring: capture.RingProgram) -> None:
        """Hand a ring program back (its tables stay valid until the
        next ``ring_checkout`` of its key)."""
        ring.live = False

    def graft(self, tables, fields) -> None:
        """Write ``fields`` of ``tables`` (a ring's private state, or a
        ``{field: tensor}`` mapping) into the live tensors in place,
        under ``_lock``: the captured programs keep holding them, and
        the epoch does not move (a bump would restart the pump's ring)."""
        get = tables.get if isinstance(tables, dict) else (
            lambda f: getattr(tables, f))
        with self._lock:
            for f in fields:
                getattr(self.tables, f).copy_(get(f))

    def prime(self, form: str, shape) -> int:
        """Capture every part of the current selection's ``form`` program
        for ``shape`` (both tiers on the auto path) without stepping the
        live tables (``capture.Program.prime``); returns the parts
        built."""
        with self._lock:
            fast = self._use_fastpath and form != "chain"
            if form == "chain" and self._use_fastpath:
                # the auto path's chain runs the packed program per batch
                form, shape = "packed", tuple(shape)[1:]
            return self._program(fast, form, shape).prime(_MUTABLE_FIELDS)

    def _plain_only(self, form: str) -> None:
        """The reference's refusal of the packed forms under the
        overlay: the packed boundary carries no inner-header sidecar."""
        if self._overlay != "off" and form != "plain":
            raise ValueError(
                f"overlay={self._overlay!r} supports only the plain step "
                f"form (the packed/ring boundaries carry no inner-header "
                f"sidecar); got form {form!r}")

    def programs(self):
        """The step programs built so far (pipeline/capture.py)."""
        with self._lock:
            return list(self._programs.values())

    # --- traffic ---
    def _check(self, pkts: PacketVector) -> None:
        if pkts.src_ip.device != self.tables.sess_valid.device:
            raise ValueError(
                f"packet vector on {pkts.src_ip.device}, dataplane on "
                f"{self.tables.sess_valid.device}")

    def _clock(self, now: Optional[int]) -> int:
        """The step's clock: ``now``, else the wall-clock ticks, kept
        monotone."""
        if now is None:
            self._now = max(self._now, self.clock_ticks())
            now = self._now
        return int(now)

    def _now_tensor(self, now: int) -> torch.Tensor:
        return torch.full((), _i32(now), dtype=torch.int32,
                          device=self.device)

    def _scratch(self):
        """The live tables with copies of the state a step mutates."""
        t = self.tables
        return t._replace(**{f: getattr(t, f).clone()
                             for f in _MUTABLE_FIELDS})

    def _load_packed(self, flat, dest: Optional[torch.Tensor] = None):
        """A packed batch (host numpy / tensor, or a tensor on this
        device) as int32 on the device, in ``dest`` when given. From the
        host it goes through the pinned staging buffers (non-blocking)."""
        if torch.is_tensor(flat) and flat.device == self.device:
            if dest is None:
                return flat.to(torch.int32).contiguous()
            return dest.copy_(flat)
        arr = flat.numpy() if torch.is_tensor(flat) else np.asarray(flat)
        arr = (arr.view(np.int32) if arr.dtype == np.uint32
               else arr.astype(np.int32, copy=False))
        if dest is None:
            dest = torch.empty(arr.shape, dtype=torch.int32,
                               device=self.device)
        if self.device.type == "cuda":
            self._upload(arr, dest)
        else:
            dest.copy_(torch.from_numpy(arr))
        return dest

    def process(self, pkts: PacketVector, now: Optional[int] = None,
                ovl_inner: Optional[PacketVector] = None,
                ovl_vni=None) -> StepResult:
        """Run one packet vector through the step; the session state of
        the live epoch is updated in place. With ``graphs`` the step
        replays its program (the header is copied into its static
        columns, the result is a copy of its output); the full chain
        never synchronises with the device, the two-tier dispatcher
        reads its dispatch flag once. With the overlay on, ``ovl_inner``
        / ``ovl_vni`` are the host-parsed inner-header sidecar of VXLAN
        ingress ([P] inner PacketVector, [P] int32 VNI, -1: no VXLAN
        framing); None gives the all-unframed sidecar, under which any
        overlay-addressed frame fails closed."""
        self._check(pkts)
        sidecar = self._sidecar(pkts, ovl_inner, ovl_vni)
        with self._lock:
            self._steps_since_expire += 1
            now = self._clock(now)
            if not self.graphs:
                result = self._get_step(self._use_fastpath)(
                    self.tables, pkts, self._now_tensor(now), *sidecar)
                self.tables = result.tables
            else:
                cols = tuple(pkts)
                if sidecar[0] is not None:
                    cols += tuple(sidecar[0]) + (sidecar[1],)
                prog = self._program(self._use_fastpath, "plain",
                                     (len(cols), pkts.src_ip.shape[0]))
                buf = prog.run(_i32(now),
                               lambda x: torch.stack(cols, out=x))
                result = prog.result(buf)
            tracer = self.tracer
        if tracer is not None:
            tracer.record(result)
        return result

    def _sidecar(self, pkts: PacketVector, ovl_inner, ovl_vni) -> tuple:
        """(ovl_inner, ovl_vni) of a step: with the overlay off (None,
        None), the sidecar unused as the reference leaves it; with it on
        the reference's defaults, the outer header and all -1."""
        if self._overlay == "off":
            return None, None
        if ovl_inner is None:
            ovl_inner = pkts
        self._check(ovl_inner)
        if ovl_vni is None:
            ovl_vni = torch.full_like(pkts.flags, -1)
        return ovl_inner, torch.as_tensor(ovl_vni, dtype=torch.int32,
                                          device=self.device)

    def probe(self, pkts: PacketVector,
              now: Optional[int] = None) -> StepResult:
        """Side-effect-free step against the live tables: the forced
        full chain (as the reference's ``probe``) runs eagerly on copies
        of the state it would update, so no session is installed and no
        counter or telemetry plane of the live epoch moves. It runs
        under ``_lock``: a swap writes the configuration tensors in
        place and must not land mid-step."""
        self._check(pkts)
        sidecar = self._sidecar(pkts, None, None)
        with self._lock:
            step = self._get_step(False)
            if now is None:
                now = max(self._now, self.clock_ticks())
            return step(self._scratch(), pkts, self._now_tensor(now),
                        *sidecar)

    def _stamps(self, stamps, k: Optional[int], now_us: Optional[int]):
        """The telemetry inputs of a packed call: the rx stamp (K of
        them for a chain; None: unstamped) and ``now_us`` (None: the
        clock now), each wrapped to int32; zeros with telemetry off."""
        if self._tel_mode == "off":
            return (0 if k is None else [0] * k), 0
        if now_us is None:
            now_us = tel_clock_us()
        if k is None:
            return _i32(stamps or 0), _i32(now_us)
        if stamps is None:
            stamps = np.zeros(k, np.int64)
        return [_i32(s) for s in np.asarray(stamps).reshape(k)], \
            _i32(now_us)

    def _packed_eager(self, step, tables, flats, now: int, stamps,
                      now_us: int):
        """The packed steps of ``flats`` (``[5, B]`` device batches, one
        rx stamp each) run eagerly on ``tables``, and their
        ``capture.encode_observed`` buffer."""
        now_t = self._now_tensor(now)
        us = self._now_tensor(now_us) if self._tel_mode != "off" else None
        results = [step(tables, packed_vector(xk), now_t) for xk in flats]
        return capture.encode_observed(
            tables, results, [self._now_tensor(s) for s in stamps], us)

    def process_packed(self, flat, now: Optional[int] = None,
                       commit: bool = True, with_aux: bool = False,
                       stamp_us: int = 0, now_us: Optional[int] = None):
        """One bit-packed ``[5, B]`` int32 batch (host numpy or tensor;
        ``pack_packet_columns`` / ``packed_input_zeros``, the row layout
        of graph.py ``packed_vector``) through the step; returns the
        DEVICE ``[5, B]`` packed result (graph.py ``packed_fields``),
        and with ``with_aux`` also the ``[PACKED_AUX_ROWS]`` aux rider,
        without a host sync on the full chain. ``commit=False`` runs the
        step eagerly on copies of the mutable state (a probe-like
        classify that keeps nothing). With telemetry on, ``stamp_us`` is
        the batch's rx-enqueue stamp in µs (``tel_clock_us``; 0:
        unstamped, not observed) and ``now_us`` the dispatch clock (None:
        read here): the device histograms ``now_us - stamp_us`` of every
        valid packet."""
        if not torch.is_tensor(flat):
            flat = np.asarray(flat)
        self._plain_only("packed")
        with self._lock:
            if commit:
                self._steps_since_expire += 1
            now = self._clock(now)
            stamp, us = self._stamps(stamp_us, None, now_us)
            batch = flat.shape[1]
            if commit and self.graphs:
                prog = self._program(self._use_fastpath, "packed",
                                     (PACKED_IN_ROWS, batch))
                buf = prog.run(_i32(now),
                               lambda x: self._load_packed(flat, x),
                               stamp, us)
                out, aux = prog.packed(buf)
            else:
                tables = self.tables if commit else self._scratch()
                out, aux = capture.packed_views(self._packed_eager(
                    self._get_step(self._use_fastpath), tables,
                    [self._load_packed(flat)], now, [stamp], us), batch)
        return (out, aux) if with_aux else out

    def process_packed_chain(self, flats, now: Optional[int] = None,
                             with_aux: bool = False, stamps_us=None,
                             now_us: Optional[int] = None):
        """K packed batches (a host ``[K, 5, B]`` int32 stack) stepped in
        turn at one clock, the sessions threaded from each to the next
        as K ``process_packed`` calls would; returns the DEVICE
        ``[K, 5, B]`` results (and ``[K, PACKED_AUX_ROWS]`` aux rows).
        With ``graphs`` the forced full chain is ONE graph of K steps;
        the auto path runs the packed program K times (prefix, flag
        read, tier). ``stamps_us`` ([K] µs rx stamps; None: unstamped)
        and ``now_us`` feed the latency histogram with telemetry on."""
        if not torch.is_tensor(flats):
            flats = np.asarray(flats)
        self._plain_only("chain")
        with self._lock:
            k, batch = len(flats), flats.shape[-1]
            # a K-chain sweeps once per sub-batch
            self._steps_since_expire += max(1, k)
            now = self._clock(now)
            stamps, us = self._stamps(stamps_us, k, now_us)
            if self.graphs and not self._use_fastpath:
                prog = self._program(False, "chain",
                                     (k, PACKED_IN_ROWS, batch))
                outs, auxs = prog.packed(prog.run(
                    _i32(now), lambda x: self._load_packed(flats, x),
                    stamps, us))
            elif self.graphs:
                x = self._load_packed(flats)
                prog = self._program(True, "packed", (PACKED_IN_ROWS, batch))
                views = [prog.packed(prog.run(
                    _i32(now), lambda d, xk=xk: d.copy_(xk), sk, us))
                    for xk, sk in zip(x.unbind(0), stamps)]
                outs = torch.stack([o for o, _ in views])
                auxs = torch.stack([a for _, a in views])
            else:
                x = self._load_packed(flats)
                outs, auxs = capture.packed_views(self._packed_eager(
                    self._get_step(self._use_fastpath), self.tables,
                    x.unbind(0), now, stamps, us), batch, k)
        return (outs, auxs) if with_aux else outs

    # --- the VXLAN edge ---
    def set_vtep(self, vtep_ip: int) -> None:
        """This node's VTEP address: ``encap_remote``'s outer source, and
        staged for the overlay's decap filter and encap (published at
        the next ``swap``)."""
        with self._lock:
            self._vtep = int(vtep_ip) & 0xFFFFFFFF
            self.builder.set_vtep_ip(vtep_ip)

    def encap_remote(self, result: StepResult) -> PacketVector:
        """The outer-header vector of a step's REMOTE-disposed packets
        with a tunnel next hop (plain tensor code on the step's device);
        lanes with next hop 0 (e.g. an SNAT'd default route) leave as
        plain IP and come back invalid."""
        if self._vtep is None:
            raise RuntimeError("set_vtep() before encap_remote()")
        mask = ((result.disp == int(Disposition.REMOTE))
                & (result.next_hop != 0))
        return vxlan_encap(result.pkts, mask, self._vtep, result.next_hop)

    # --- snapshots ---
    def fib_snapshot(self) -> dict:
        """Host scalars of the FIB: the live route count, the routes per
        prefix length, the ECMP group registry with each member's ways
        and forwarded packets (from the [G, W] plane, the one device
        read), the LPM plane bytes, the host ms of the last plane
        restage and the last FIB upload's record (fields re-shipped
        whole, blob bytes, bytes, host ms)."""
        with self._lock:
            t, b = self.tables, self.builder
            live = b.fib_plen[b.fib_plen >= 0]
            cnts = np.bincount(live, minlength=33) if len(live) else []
            groups = {
                g: [{"nh": int(m[0]), "tx_if": int(m[1]), "node": int(m[2]),
                     "ways": [w for w, a in enumerate(e["assign"])
                              if a == m],
                     "pkts": 0} for m in e["members"]]
                for g, e in b.nh_groups.items()}
            snap = {
                "impl": self._fib_impl,
                "knob": self.fib_impl_knob,
                "routes": int(len(live)),
                "by_length": {int(n): int(c) for n, c in enumerate(cnts)
                              if c},
                "lpm_ok": b.lpm_ok(),
                "lpm_build_ms": float(b.lpm_build_ms),
                "ecmp_groups": groups,
                "plane_bytes": lpm_plane_bytes(self.config),
                "upload": dict(b.fib_upload),
            }
            ecmp_c = t.fib_ecmp_c.cpu().numpy().astype(np.int64)
        count_device_transfer("fib.snapshot", ecmp_c)
        snap["ecmp_c"] = ecmp_c
        for g, members in groups.items():
            for m in members:
                if m["ways"]:
                    m["pkts"] = int(ecmp_c[g, m["ways"]].sum())
        return snap

    def tenant_snapshot(self) -> Optional[dict]:
        """Host copy of the per-tenant planes: bucket levels, rx /
        forwarded / rate-limited / slice-failure counters, rates and
        bursts, and each tenant's live sessions in its slice
        (tenancy/derive.py ``tenant_occupancy``, a prefix sum on the
        device: [T] ints cross, never the columns). None with tenancy
        off."""
        if self._tnt_mode == "off":
            return None
        from vpp_tpu_torch.tenancy.derive import tenant_occupancy

        with self._lock:
            t = self.tables
            now = max(self._now, self.clock_ticks())
            registry = {tid: dict(e)
                        for tid, e in self.builder.tenants.items()}
            occ = tenant_occupancy(t.sess_valid, t.sess_time,
                                   self._now_tensor(now), t.sess_max_age,
                                   t.tnt_sess_base, t.tnt_sess_mask + 1)
            planes = [x.cpu().numpy().astype(np.int64) for x in (
                t.tnt_tokens, t.tnt_rx_c, t.tnt_tx_c, t.tnt_rl_c,
                t.tnt_qf_c, occ, t.tnt_rate, t.tnt_burst, t.tnt_sess_mask)]
        tokens, rx, tx, rl, qf, occ_h, rate, burst, smask = planes
        return {
            "tenants": registry,
            "tokens": tokens,
            "rx": rx,
            "tx": tx,
            "rl_drops": rl,
            "quota_fails": qf,
            "occupancy": occ_h,
            "rate": rate,
            "burst": burst,
            "sess_quota_slots": (smask + 1) * int(self.config.sess_ways),
        }

    # --- device telemetry (ops/telemetry.py) ---
    def telemetry_snapshot(self) -> Optional[dict]:
        """Host copy of the collect-facing telemetry planes: the latency
        bins, the sketched-packet count and the top-K candidate rows (a
        few hundred bytes; the ``[d, w]`` sketch stays on the card).
        None with telemetry off."""
        if self._tel_mode == "off":
            return None
        with self._lock:
            t = self.tables
            planes = [getattr(t, f).cpu().numpy() for f in (
                "tel_lat_hist", "tel_sketched", "tel_top_key",
                "tel_top_src", "tel_top_dst", "tel_top_ports",
                "tel_top_cnt")]
        bins, sketched, key, src, dst, ports, cnt = planes
        return {
            "mode": self._tel_mode,
            "bins": bins.astype(np.int64),
            "sketched": int(sketched),
            "top_key": key.view(np.uint32),
            "top_src": src.view(np.uint32),
            "top_dst": dst.view(np.uint32),
            "top_ports": ports.view(np.uint32),
            "top_cnt": cnt.astype(np.int64),
        }
