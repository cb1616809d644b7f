"""PacketTracer: a bounded ring of sampled per-packet pipeline paths.

The counterpart of the reference's ``vpp_tpu/trace/tracer.py``, over
the port's ``StepResult`` (torch tensors, on the card or the CPU).
Reference analog: VPP's packet tracer — `trace add dpdk-input 50`
captures the next 50 packets with their node-by-node path; `show trace`
prints them (docs/VPP_PACKET_TRACING_K8S.md:20-50). Here the "path" is
reconstructed from the fused step's per-packet outputs (drop cause,
session/DNAT flags, disposition), so arming the tracer costs nothing on
the device: tracing copies back columns the step already produced, and
only while armed.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, List

import numpy as np

from vpp_tpu_torch.pipeline.graph import DROP_CAUSE_NAMES, StepResult
from vpp_tpu_torch.pipeline.vector import Disposition, ip4_str


def _host(x) -> np.ndarray:
    """A step column as a host array (a device tensor is copied back)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    frame_seq: int
    slot: int              # packet lane within the frame
    src: str
    dst: str
    proto: int
    sport: int
    dport: int
    rx_if: int
    path: tuple            # node names the packet visited
    disposition: str
    tx_if: int
    drop_cause: str

    def format(self) -> str:
        l4 = f"{self.sport}->{self.dport}" if self.proto in (6, 17) else ""
        lines = [
            f"Packet (frame {self.frame_seq}, slot {self.slot}): "
            f"proto {self.proto} {self.src} -> {self.dst} {l4}".rstrip(),
        ]
        for node in self.path:
            lines.append(f"  {node}")
        return "\n".join(lines)


class PacketTracer:
    """Arm with ``add(count)``; feed every processed frame to
    ``record``; read back with ``entries()`` / ``format_trace()``."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._buf: Deque[TraceEntry] = deque(maxlen=max_entries)
        self._armed = 0
        self._frame_seq = 0
        self._lock = threading.Lock()

    def add(self, count: int = 50) -> None:
        """Capture the next ``count`` valid packets (VPP `trace add`)."""
        with self._lock:
            self._armed = min(count, self.max_entries)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._armed = 0

    @property
    def armed(self) -> int:
        # unlocked: lock-free peek on the per-frame hot path — a stale
        # read only starts/stops capture one frame late, and record()
        # re-checks under the lock before touching the buffer
        return self._armed

    def record(self, result: StepResult) -> int:
        """Sample packets from a processed frame while armed. Returns
        how many packets were captured from this frame."""
        with self._lock:
            if self._armed <= 0:
                self._frame_seq += 1
                return 0
            seq = self._frame_seq
            self._frame_seq += 1
        pkts = result.pkts
        valid = _host(pkts.valid)
        idxs = np.nonzero(valid)[0]
        if idxs.size == 0:
            return 0
        disp = _host(result.disp)
        tx_if = _host(result.tx_if)
        node_id = _host(result.node_id)
        cause = _host(result.drop_cause)
        established = _host(result.established)
        dnat = _host(result.dnat_applied)
        # per-packet ML stage: when the
        # step scored this batch, render an ml-score node with the raw
        # score (StepResult.ml_scores — zeros with the stage off) and
        # attribute DROP_ML verdicts to their own error-drop leaf
        ml_on = int(_host(result.stats.ml_scored)) > 0
        ml_scores = _host(result.ml_scores)
        ml_flagged = _host(result.ml_flagged)
        src = _host(pkts.src_ip)
        dst = _host(pkts.dst_ip)
        proto = _host(pkts.proto)
        sport = _host(pkts.sport)
        dport = _host(pkts.dport)
        rx_if = _host(pkts.rx_if)

        captured = 0
        with self._lock:
            for i in idxs:
                if self._armed <= 0:
                    break
                i = int(i)
                path: List[str] = ["ip4-input"]
                c = int(cause[i])
                d = int(disp[i])
                if c == 1:  # DROP_IP4
                    path.append("error-drop (ip4-input)")
                elif c == 7:  # DROP_TENANT: the per-tenant
                    # token bucket drops right after ip4-input, BEFORE
                    # session lookup / ML / NAT / ACL — no later stage
                    # ever saw the packet
                    path.append("tenant-limit")
                    path.append("error-drop (tenant-quota)")
                else:
                    if established[i]:
                        path.append("session-lookup (established)")
                    # the ML stage evaluates on the post-NAT-reverse
                    # header, BEFORE DNAT/classify (graph._ml_eval);
                    # its drop verdict folds after the ACL's, so the
                    # ml-drop leaf renders below acl-classify
                    if ml_on:
                        path.append(
                            "ml-score (score {}{})".format(
                                int(ml_scores[i]),
                                ", flagged" if ml_flagged[i] else ""))
                    if dnat[i]:
                        path.append("nat44-dnat")
                    path.append("acl-classify")
                    if c == 2:
                        path.append("error-drop (acl-deny)")
                    elif c == 6:  # DROP_ML (deny beat it already)
                        path.append("error-drop (ml-drop)")
                    else:
                        path.append("ip4-lookup")
                        if c == 3:
                            path.append("error-drop (no-route)")
                        elif c == 4:
                            path.append("error-drop (fib-drop)")
                        elif d == int(Disposition.REMOTE):
                            path.append("vxlan/ici-encap")
                            path.append("interface-output (uplink)")
                        elif d == int(Disposition.HOST):
                            path.append("host-punt")
                        else:
                            path.append(
                                f"interface-output (if {int(tx_if[i])})"
                            )
                self._buf.append(TraceEntry(
                    frame_seq=seq,
                    slot=i,
                    src=ip4_str(int(src[i])),
                    dst=ip4_str(int(dst[i])),
                    proto=int(proto[i]),
                    sport=int(sport[i]),
                    dport=int(dport[i]),
                    rx_if=int(rx_if[i]),
                    path=tuple(path),
                    disposition=Disposition(d).name,
                    tx_if=int(tx_if[i]),
                    drop_cause=DROP_CAUSE_NAMES.get(c, str(c)),
                ))
                self._armed -= 1
                captured += 1
        return captured

    def entries(self) -> List[TraceEntry]:
        with self._lock:
            return list(self._buf)

    def format_trace(self) -> str:
        """`show trace` analog."""
        entries = self.entries()
        if not entries:
            return "No packets in trace buffer"
        return "\n------\n".join(e.format() for e in entries)
