"""The Dataplane: table epochs, interface registry and the step entry.

The PyTorch counterpart of ``vpp_tpu/pipeline/dataplane.py``
``Dataplane``: the same registry (uplink, host and pod interfaces, ACL
table slots), the same epoch ``swap`` (the staged configuration is
uploaded and the live session state carried over by reference), the
same selection ladders re-gated at every swap, and the same
``process``/``probe`` entries.

``Dataplane(config, device=None)`` runs on the card: ``device`` None
resolves to ``cuda`` and raises when no GPU is present. Tests pass
``device="cpu"``, where every kernel wrapper takes its plain version.

With the fast path engaged (``fastpath=True``, the default, and at
least ``fastpath_min_rules`` global rules — re-gated at every swap)
``process`` and ``probe`` run the two-tier dispatcher, which reads its
dispatch flag to the host once per step (pipeline/graph.py
``pipeline_step_auto``); the full chain alone never synchronises.

Not ported: ``process_packed`` and the chain/ring forms, the jit
caches, spans, journal and tracer (the port compiles nothing).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Dict, Optional

from vpp_tpu_torch.ir.rule import PodID
from vpp_tpu_torch.ops.session import session_expire, sweep_covered
from vpp_tpu_torch.pipeline.graph import StepResult, make_pipeline_step
from vpp_tpu_torch.pipeline.selection import (
    select_fib_impl,
    select_impl,
    select_session_impl,
)
from vpp_tpu_torch.pipeline.tables import (
    SESSION_FIELDS,
    DataplaneConfig,
    InterfaceType,
    TableBuilder,
    resolve_device,
)
from vpp_tpu_torch.pipeline.vector import PacketVector

# the step mutates these in place; ``probe`` runs on copies
_MUTABLE_FIELDS = tuple(SESSION_FIELDS) + ("fib_ecmp_c",)


class Dataplane:
    TICKS_PER_SEC = 10

    def __init__(self, config: Optional[DataplaneConfig] = None,
                 device=None):
        self.device = resolve_device(device)
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
        self._classifier_impl = "dense"
        self._fib_impl = "dense"
        self._session_impl = "gather"
        self._skip_local = True
        self._refresh_selection()
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
    def swap(self) -> int:
        """Publish the staged configuration as a new table epoch; the
        live session state carries over by reference."""
        with self._lock:
            self.tables = self.builder.to_device(sessions=self.tables)
            self._refresh_selection()
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
                self.tables = after
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
        the three ladders, the policy-free local-classify skip and the
        fast-path engagement."""
        b = self.builder
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

    def _get_step(self):
        return make_pipeline_step(
            self._classifier_impl, self._skip_local, self._use_fastpath,
            self._sweep_stride, fib_impl=self._fib_impl,
            sess_impl=self._session_impl, sess_hash=self._sess_hash)

    # --- traffic ---
    def _check(self, pkts: PacketVector) -> None:
        if pkts.src_ip.device != self.tables.sess_valid.device:
            raise ValueError(
                f"packet vector on {pkts.src_ip.device}, dataplane on "
                f"{self.tables.sess_valid.device}")

    def process(self, pkts: PacketVector,
                now: Optional[int] = None) -> StepResult:
        """Run one packet vector through the step; the session state of
        the live epoch is updated in place. The full chain never
        synchronises with the device; the two-tier dispatcher reads
        its dispatch flag once."""
        self._check(pkts)
        with self._lock:
            step = self._get_step()
            self._steps_since_expire += 1
            if now is None:
                self._now = max(self._now, self.clock_ticks())
                now = self._now
            result = step(self.tables, pkts, int(now))
            self.tables = result.tables
        return result

    def probe(self, pkts: PacketVector,
              now: Optional[int] = None) -> StepResult:
        """Side-effect-free step against the live tables: the step runs
        on copies of the state it would update, so no session is
        installed and no counter of the live epoch moves."""
        self._check(pkts)
        with self._lock:
            step = self._get_step()
            if now is None:
                now = max(self._now, self.clock_ticks())
            t = self.tables
            scratch = t._replace(**{f: getattr(t, f).clone()
                                    for f in _MUTABLE_FIELDS})
        return step(scratch, pkts, int(now))
