"""Reflex-plane latency governor: closed-loop SLO protection for the
wire path.

The port's copy of ``vpp_tpu/io/governor.py``. Without it the pump's
window shaping is open-loop: the stager ships whatever backlog is
queued, so under load every frame pays the full S-slot window's
batching latency and p99 sits wherever the offered load pushes it. nanoPU
(PAPERS.md) argues the metric that matters for reflex traffic — DDoS
mitigation verdicts, health checks, our ML ``enforce`` decisions — is
wire-to-wire *tail* latency; Gryphon shows the failure mode at the
other end: a gateway that cannot shed or prioritize under overload
fails everyone instead of degrading gracefully.

:class:`LatencyGovernor` closes the loop **host-side only**. It
watches the device telemetry (the in-step device latency histogram
behind ``vpp_tpu_wire_latency_seconds``, falling back to the pump's
host batch window), plus per-window fill occupancy and the rx backlog,
and adapts the pump's window shaping between its two existing extremes
— 1-slot lone-frame windows (the latency floor) and S-slot backlog
fills (throughput) — against an explicit ``latency_slo_us`` knob.
Critically, every actuator is a host-side integer the pump/stager
already treats as dynamic (window fill count, in-flight depth,
coalesce cap, admission), so the governor **never enters the jit
key**: governed and ungoverned runs trace the exact same step
variants.

Control law (docs/LATENCY.md has the derivation)::

    t_svc  : EWMA per-frame service time (delivered-frame deltas)
    est    = p99_obs + backlog_frames * t_svc        # SLO envelope
    hi     = slo_us;  lo = slo_us * (1 - hysteresis)

    p99_obs > hi and windows not already lone  ->  level - 1  (fast)
    est > hi and p99_obs <= lo and level < top ->  level + 1  (queue
                                                   pressure, headroom)
    est > hi otherwise, B consecutive ticks    ->  BROWNOUT (shed)
    est < lo for R consecutive ticks           ->  un-shed -> RECOVERY,
                                                   then level + 1 per R
                                                   ticks back to top
                                                   -> NORMAL

Levels are a discrete ladder from ``(fill=1, inflight=1)`` to
``(fill=S, inflight=max)``; one step per tick with a settle grace
between steps, hysteresis bands, and slow-up/fast-down asymmetry —
the anti-oscillation guards (a monotone trajectory within bands is
pinned by the anti-flap unit test). Brownout/recovery mirrors the
degraded-mode pattern of the ring fallback: brownout never snaps straight back to
normal (one-way brownout -> recovery -> normal), and
``vpp_tpu_degraded{component="governor"}`` flips ONLY when the
control loop itself is wedged (``governor.tick`` fault ladder) — a
wedged governor freezes the last-known window shape and the pump
keeps forwarding.

Overload shedding is explicit and attributed: in brownout the pump
admits bulk only up to the pipe's natural depth (``fill x inflight``
frames) and drops the excess at admission as ``drops_overload``
(``vpp_tpu_pump_drops_total{reason="overload"}``) — never silent
queue growth. :class:`PriorityFilter` designates the reflex flows
(static port/prefix/proto rules + dynamically marked host pairs, e.g.
ML-flagged traffic) that bypass shedding entirely and preempt bulk
windows in the staging path (the stager ships a window the moment a
priority slot lands instead of draining the backlog into it).

This module imports no torch (like io/rings.py): it runs on the
pump's dispatch thread and in light processes.
"""

from __future__ import annotations

import ipaddress
import logging
import threading
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from vpp_tpu_torch.testing import faults

log = logging.getLogger("governor")

# governor operating modes, in the order the state machine visits them
# (the vpp_tpu_governor_mode info gauge enumerates these plus "off"
# for a pump with no governor attached)
GOVERNOR_MODES = ("normal", "brownout", "recovery")

# consecutive tick failures before the governor declares itself wedged
# (one-way, vpp_tpu_degraded{component="governor"}): a single injected
# or transient failure skips one adjustment — the pump's ring fault
# ladder never trips on the first blip either
WEDGE_LIMIT = 3


class LatencyGovernor:
    """Closed-loop window-shape controller (module doc).

    Thread contract: ``maybe_tick`` runs on the pump's dispatch thread;
    ``limits``/``admit`` are read on the same thread; ``snapshot`` is
    read by the collector/CLI threads — every mutable field is guarded
    by ``_lock`` (ticks are rare and short, so the hot-path cost is an
    uncontended acquire).

    ``SNAPSHOT_SCALARS`` names the numeric snapshot keys the collector
    exports one gauge each for (``GOVERNOR_STAT_GAUGES``); the
    ``--counters`` lint pass keeps the two in lockstep.
    """

    SNAPSHOT_SCALARS = (
        "slo_us", "level", "fill", "inflight", "last_p99_us",
        "queue_est_us", "fill_avg", "ticks", "tick_errors",
    )

    def __init__(self, slo_us: float, *, slots: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 tick_s: float = 0.05, hysteresis_pct: float = 30.0,
                 brownout_ticks: int = 3, recover_ticks: int = 5,
                 settle_ticks: int = 2, ewma_alpha: float = 0.3,
                 shed_margin: float = 0.4,
                 clock=time.monotonic):
        if slo_us <= 0:
            raise ValueError(f"latency_slo_us must be > 0, got {slo_us}")
        if not 0.0 < hysteresis_pct < 100.0:
            raise ValueError(
                f"governor hysteresis_pct must be in (0, 100), "
                f"got {hysteresis_pct}")
        if brownout_ticks < 1 or recover_ticks < 1:
            raise ValueError("governor brownout/recover ticks must be >= 1")
        self.slo_us = float(slo_us)
        self.tick_s = float(tick_s)
        self.hysteresis_pct = float(hysteresis_pct)
        self.brownout_ticks = int(brownout_ticks)
        self.recover_ticks = int(recover_ticks)
        self.settle_ticks = int(settle_ticks)
        self.ewma_alpha = float(ewma_alpha)
        if not 0.0 < shed_margin <= 1.0:
            raise ValueError(
                f"governor shed_margin must be in (0, 1], "
                f"got {shed_margin}")
        self.shed_margin = float(shed_margin)
        self._clock = clock
        self._lock = threading.Lock()
        self._queue_cap: Optional[int] = None
        self._levels: List[Tuple[int, int]] = []
        self._level = 0
        self._fill = 1
        self._inflight = 1
        self._shed = False
        self.mode = "normal"
        self.wedged = False
        self._last_tick = float("-inf")
        self._over_ticks = 0
        self._under_ticks = 0
        self._ok_ticks = 0
        self._cool = 0
        self._error_streak = 0
        self._t_svc_s: Optional[float] = None
        self._rate_last: Optional[Tuple[float, int]] = None
        self._last_p99 = 0.0
        self._last_queue_est = 0.0
        self._last_fill_avg = 0.0
        self._ticks = 0
        self._tick_errors = 0
        self._adjust = {"up": 0, "down": 0}
        self._transitions = {m: 0 for m in GOVERNOR_MODES}
        if slots is not None and max_inflight is not None:
            self.bind(slots, max_inflight)

    # --- ladder ---
    def bind(self, slots: int, max_inflight: int,
             queue_cap: Optional[int] = None) -> None:
        """Build the level ladder for the pump's geometry: fill doubles
        1 -> slots first (the latency-dominant lever), then in-flight
        depth doubles to ``max_inflight``. Idempotent — the owning
        pump calls this at construction; an explicitly pre-bound
        governor (tests) keeps its ladder.

        ``queue_cap`` switches the governor into EXPRESS mode (the
        pump passes it when a priority lane is attached): reflex
        traffic bypasses the bulk queue entirely, so bulk backlog no
        longer counts toward the SLO envelope — the p99 axis shapes
        windows for the reflex lane, and brownout/shedding engage only
        when the backlog itself exceeds ``queue_cap`` frames (true
        overload: the queue would otherwise grow to ring overflow,
        which is silent loss at the daemon instead of attributed
        drops here)."""
        with self._lock:
            if queue_cap is not None:
                self._queue_cap = max(1, int(queue_cap))
            if self._levels:
                return
            slots = max(1, int(slots))
            infl = max(1, int(max_inflight))
            # the in-flight floor stays at 2 where the pump allows it:
            # depth 1 serializes the ring's double buffer (stage,
            # dispatch and fetch stop overlapping), which costs bulk
            # goodput far more than it buys the reflex lane — one
            # residual window of wait either way
            f, i = 1, min(2, infl)
            levels = [(f, i)]
            while f < slots or i < infl:
                if f < slots:
                    f = min(f * 2, slots)
                else:
                    i = min(i * 2, infl)
                levels.append((f, min(i, infl)))
            self._levels = levels
            # rest at the top of the ladder: the fill cap only binds
            # under backlog (a lone frame still ships alone), so full
            # throughput shape is the correct no-signal default
            self._level = len(levels) - 1
            self._fill, self._inflight = levels[self._level]

    # --- hot-path reads (pump dispatch thread) ---
    @property
    def fill(self) -> int:
        with self._lock:
            return self._fill

    def limits(self) -> Tuple[int, int, bool]:
        """``(window_fill, max_inflight, shedding)`` — the live
        actuator values the pump applies to its staging path."""
        with self._lock:
            return self._fill, self._inflight, self._shed

    def admit(self, priority: bool, backlog_frames: int) -> bool:
        """Admission decision for one coalesce group. Priority groups
        are ALWAYS admitted (the lane shedding protects). Bulk is
        admitted unconditionally outside brownout; in brownout it is
        admitted only while the backlog fits the SLO's queue budget —
        the deepest queue whose predicted FIFO delay
        (``backlog x t_svc``) still spends at most ``shed_margin`` of
        the SLO, floored at the pipe's natural depth
        (``fill x inflight`` frames, what keeps the device busy).
        Excess offered load is dropped at admission with an
        attributed cause instead of growing the queue without bound;
        offered load the SLO-budgeted queue CAN carry is never shed,
        which is what keeps bulk goodput at sub-saturating load."""
        if priority:
            return True
        with self._lock:
            if not self._shed:
                return True
            if self._queue_cap is not None:
                # express mode: bulk queueing no longer delays reflex
                # traffic, so the shed bound is the physical queue cap
                # — brownout trims the backlog to it, attributed
                return backlog_frames <= self._queue_cap
            bound = self._fill * self._inflight
            if self._t_svc_s:
                bound = max(bound, int(
                    self.shed_margin * self.slo_us
                    / max(self._t_svc_s * 1e6, 1e-9)))
            return backlog_frames <= bound

    # --- control loop ---
    def tick_due(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = self._clock()
        with self._lock:
            if self.wedged:
                return False
            return now - self._last_tick >= self.tick_s

    def maybe_tick(self, p99_us: Optional[float], backlog_frames: int,
                   delivered_frames: int,
                   fill_avg: Optional[float] = None,
                   now: Optional[float] = None) -> bool:
        """Run one control tick if due. Never raises: a failing tick
        (the ``governor.tick`` fault seam, or a real bug in the
        control loop) is counted, and after ``WEDGE_LIMIT`` consecutive
        failures the governor goes WEDGED — one-way: adjustments stop,
        the pump keeps running at the last-known window shape, and
        ``vpp_tpu_degraded{component="governor"}`` flips. A crashed
        governor must degrade observability, never the data path."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self.wedged or now - self._last_tick < self.tick_s:
                return False
            self._last_tick = now
            try:
                self._tick_locked(p99_us, backlog_frames,
                                  delivered_frames, fill_avg, now)
                self._error_streak = 0
                return True
            except Exception:  # noqa: BLE001 — wedge ladder (module doc)
                self._tick_errors += 1
                self._error_streak += 1
                if self._error_streak >= WEDGE_LIMIT:
                    self.wedged = True
                    log.exception(
                        "governor wedged after %d consecutive tick "
                        "failures — window shape frozen at fill=%d "
                        "inflight=%d shed=%s",
                        self._error_streak, self._fill, self._inflight,
                        self._shed)
                else:
                    log.exception("governor tick failed (%d/%d)",
                                  self._error_streak, WEDGE_LIMIT)
                return False

    def _tick_locked(self, p99_us, backlog_frames, delivered_frames,
                     fill_avg, now) -> None:
        # faults: "governor.tick" = the control loop crashing (a bad
        # observation source, a wedged telemetry fetch) — it must
        # freeze the window shape, never kill the pump (chaos schedule)
        faults.fire("governor.tick")
        self._ticks += 1
        if not self._levels:
            return  # unbound (no pump yet): observe-only
        # EWMA per-frame service time from delivered-frame deltas —
        # the queue-delay estimator's slope. Idle gaps inflate the
        # instantaneous value; backlog is ~0 then, so the product
        # (queue_est) stays honest.
        if self._rate_last is not None:
            t0, d0 = self._rate_last
            dt, dd = now - t0, delivered_frames - d0
            if dd > 0 and dt > 0:
                inst = dt / dd
                self._t_svc_s = (inst if self._t_svc_s is None else
                                 self.ewma_alpha * inst
                                 + (1 - self.ewma_alpha) * self._t_svc_s)
        self._rate_last = (now, delivered_frames)
        queue_us = (backlog_frames * self._t_svc_s * 1e6
                    if self._t_svc_s else 0.0)
        p99 = float(p99_us) if p99_us is not None else None
        self._last_p99 = p99 or 0.0
        self._last_queue_est = queue_us
        if fill_avg is not None:
            self._last_fill_avg = float(fill_avg)
        hi = self.slo_us
        lo = self.slo_us * (1.0 - self.hysteresis_pct / 100.0)
        if self._queue_cap is not None:
            # EXPRESS mode (priority lane attached): reflex traffic
            # bypasses the bulk queue, so backlog does not count
            # toward the SLO envelope — p99 IS the envelope, and
            # queue pressure is a separate overload axis against the
            # physical queue bound
            est = p99 or 0.0
            queue_over = backlog_frames > self._queue_cap
            queue_clear = backlog_frames <= self._queue_cap // 2
        else:
            est = (p99 or 0.0) + queue_us
            queue_over = False
            queue_clear = True
        if self._cool > 0:
            self._cool -= 1
        top = len(self._levels) - 1
        if est <= hi and not queue_over:
            self._ok_ticks += 1
        else:
            self._ok_ticks = 0
        if est > hi or queue_over:
            self._under_ticks = 0
            if (p99 is not None and p99 > hi and self._level > 0
                    and self._cool == 0):
                self._step_locked(-1)   # batching latency: fast down
                self._over_ticks = 0
            elif ((p99 is None or p99 <= lo) and self._level < top
                  and self._cool == 0):
                self._step_locked(+1)   # queue pressure with headroom
                self._over_ticks = 0
            else:
                # count toward brownout only when no step could still
                # help (settling after a step is not "unattainable");
                # in express mode additionally only under QUEUE
                # pressure — shedding bulk cannot improve a reflex
                # lane that already bypasses the queue, so a p99-only
                # breach at the floor holds shape instead of shedding
                if self._cool == 0 and \
                        (self._queue_cap is None or queue_over):
                    self._over_ticks += 1
                if (not self._shed
                        and self._over_ticks >= self.brownout_ticks):
                    # SLO unattainable at offered load: shed bulk
                    self._shed = True
                    self._enter_locked("brownout")
        elif est < lo:
            self._over_ticks = 0
            self._under_ticks += 1
            if self._under_ticks >= self.recover_ticks:
                self._under_ticks = 0
                if self._shed and queue_clear:
                    # one-way: brownout exits INTO recovery, never
                    # straight back to normal (the degraded-mode pattern); in
                    # express mode the backlog must also have drained
                    # below half the queue bound, or shedding would
                    # flap against a still-standing queue
                    self._shed = False
                    self._enter_locked("recovery")
                elif not self._shed and self._level < top \
                        and self._cool == 0:
                    self._step_locked(+1)  # slow up: one step per R ticks
        else:
            # inside the hysteresis band: hold — this is the
            # anti-flap dead zone
            self._over_ticks = 0
            self._under_ticks = 0
        if (self.mode == "recovery" and not self._shed
                and self._level == top
                and self._ok_ticks >= self.recover_ticks):
            self._enter_locked("normal")

    def _step_locked(self, direction: int) -> None:
        new = min(max(self._level + direction, 0), len(self._levels) - 1)
        if new == self._level:
            return
        self._level = new
        self._fill, self._inflight = self._levels[new]
        self._adjust["up" if direction > 0 else "down"] += 1
        self._cool = self.settle_ticks

    def _enter_locked(self, mode: str) -> None:
        if mode == self.mode:
            return
        log.warning("governor %s -> %s (p99 %.0fus queue-est %.0fus "
                    "fill %d inflight %d)", self.mode, mode,
                    self._last_p99, self._last_queue_est, self._fill,
                    self._inflight)
        self.mode = mode
        self._transitions[mode] += 1
        self._ok_ticks = 0

    # --- observability ---
    def snapshot(self) -> dict:
        """Consistent copy for the collector/CLI (host scalars only)."""
        with self._lock:
            return {
                "mode": self.mode,
                "shedding": self._shed,
                "wedged": self.wedged,
                "slo_us": self.slo_us,
                "level": self._level,
                "levels": len(self._levels),
                "fill": self._fill,
                "inflight": self._inflight,
                "last_p99_us": self._last_p99,
                "queue_est_us": self._last_queue_est,
                "fill_avg": self._last_fill_avg,
                "t_svc_us": (self._t_svc_s or 0.0) * 1e6,
                "ticks": self._ticks,
                "tick_errors": self._tick_errors,
                "adjust_up": self._adjust["up"],
                "adjust_down": self._adjust["down"],
                "transitions": dict(self._transitions),
            }


class PriorityFilter:
    """Designates the reflex flows the priority lane serves.

    Static rules (config knobs ``io.priority_ports`` /
    ``io.priority_prefixes`` / ``io.priority_protos``) classify by
    L4 port (either direction), src/dst CIDR, or protocol number;
    :meth:`mark_flow` adds dynamic (src, dst) host pairs at runtime —
    the hook EXPOSED for an ML-mirror consumer to promote flagged
    flows without a config round trip (nothing in-tree calls it yet;
    the automatic ml_flagged→mark_flow wiring is ROADMAP item 4's
    online-loop territory). Marks are host-pair granular: the reflex
    unit the enforce path acts on.

    Classification is vectorized numpy over a frame's column block
    (<= VEC packets, a handful of rules — microseconds on the dispatch
    thread); a frame is priority when ANY of its packets match.
    """

    def __init__(self, ports: Iterable[int] = (),
                 prefixes: Iterable[str] = (),
                 protos: Iterable[int] = (),
                 max_flows: int = 4096):
        ports = sorted({int(p) for p in ports})
        protos = sorted({int(p) for p in protos})
        # a rule that can never match is the misconfiguration class
        # validate_governor_config exists to refuse at YAML load —
        # same discipline as the CIDR parse below
        for p in ports:
            if not 0 < p <= 0xFFFF:
                raise ValueError(
                    f"priority_ports entries must be 1..65535, "
                    f"got {p}")
        for p in protos:
            if not 0 <= p <= 0xFF:
                raise ValueError(
                    f"priority_protos entries must be 0..255, got {p}")
        self.ports = np.asarray(ports, np.int64)
        self.protos = np.asarray(protos, np.int64)
        nets = []
        for cidr in prefixes:
            net = ipaddress.ip_network(str(cidr), strict=False)
            if net.version != 4:
                raise ValueError(
                    f"priority_prefixes must be IPv4, got {cidr!r}")
            nets.append((int(net.network_address),
                         int(net.netmask)))
        self._nets = tuple(nets)
        self.max_flows = int(max_flows)
        self._lock = threading.Lock()
        self._flows: set = set()
        # sorted packed (src<<32 | dst) keys for vectorized membership
        self._flow_keys = np.empty(0, np.uint64)

    @staticmethod
    def _pack(src_ip: int, dst_ip: int) -> int:
        return (int(src_ip) & 0xFFFFFFFF) << 32 | (int(dst_ip)
                                                   & 0xFFFFFFFF)

    def mark_flow(self, src_ip: int, dst_ip: int) -> bool:
        """Promote a (src, dst) host pair to the priority lane.
        Returns False (and keeps the existing set) when the mark table
        is full — a bounded set, so a flood of flagged flows cannot
        grow host memory without limit."""
        key = self._pack(src_ip, dst_ip)
        with self._lock:
            if key in self._flows:
                return True
            if len(self._flows) >= self.max_flows:
                return False
            self._flows.add(key)
            self._flow_keys = np.fromiter(
                sorted(self._flows), np.uint64, len(self._flows))
            return True

    def unmark_flow(self, src_ip: int, dst_ip: int) -> None:
        key = self._pack(src_ip, dst_ip)
        with self._lock:
            if key in self._flows:
                self._flows.discard(key)
                self._flow_keys = np.fromiter(
                    sorted(self._flows), np.uint64, len(self._flows))

    def flow_count(self) -> int:
        with self._lock:
            return len(self._flows)

    def prefix_count(self) -> int:
        """Number of static CIDR rules (CLI/observability; the
        internal representation is private)."""
        return len(self._nets)

    def match_mask(self, src_ip: np.ndarray, dst_ip: np.ndarray,
                   proto: np.ndarray, sport: np.ndarray,
                   dport: np.ndarray) -> np.ndarray:
        """Per-packet priority mask (bool [n]) over column arrays."""
        src = np.asarray(src_ip, np.uint32)
        dst = np.asarray(dst_ip, np.uint32)
        m = np.zeros(src.shape, bool)
        if self.ports.size:
            m |= np.isin(np.asarray(dport, np.int64), self.ports)
            m |= np.isin(np.asarray(sport, np.int64), self.ports)
        if self.protos.size:
            m |= np.isin(np.asarray(proto, np.int64), self.protos)
        for net, mask in self._nets:
            m |= (src & np.uint32(mask)) == np.uint32(net)
            m |= (dst & np.uint32(mask)) == np.uint32(net)
        with self._lock:
            keys = self._flow_keys
        if keys.size:
            packed = (src.astype(np.uint64) << np.uint64(32)
                      | dst.astype(np.uint64))
            m |= np.isin(packed, keys)
        return m

    def frame_match(self, frame) -> bool:
        """True when ANY of the frame's valid packets is priority."""
        n = frame.n
        if not n:
            return False
        c = frame.cols
        return bool(self.match_mask(
            c["src_ip"][:n], c["dst_ip"][:n], c["proto"][:n],
            c["sport"][:n], c["dport"][:n]).any())


def validate_governor_config(io_cfg) -> None:
    """Fail FAST on governor/priority misconfiguration at YAML load
    (cmd/config.py; the validate_ring_geometry pattern) — a bad knob
    is rejected when the config is read, not at the first pump tick."""
    slo = float(getattr(io_cfg, "latency_slo_us", 0) or 0)
    if slo < 0:
        raise ValueError(f"latency_slo_us must be >= 0, got {slo}")
    if slo > 0:
        # construct once: the ctor owns the bound checks
        LatencyGovernor(
            slo,
            tick_s=float(io_cfg.governor_tick_s),
            hysteresis_pct=float(io_cfg.governor_hysteresis_pct),
            brownout_ticks=int(io_cfg.governor_brownout_ticks),
            recover_ticks=int(io_cfg.governor_recover_ticks),
        )
        if float(io_cfg.governor_tick_s) <= 0:
            raise ValueError("governor_tick_s must be > 0")
    # priority rules parse (CIDR syntax) even with the governor off —
    # the lane works ungoverned too
    PriorityFilter(ports=getattr(io_cfg, "priority_ports", ()) or (),
                   prefixes=getattr(io_cfg, "priority_prefixes", ()) or (),
                   protos=getattr(io_cfg, "priority_protos", ()) or ())
