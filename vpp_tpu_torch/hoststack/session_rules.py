"""Session-rule tables + the vectorized connection filter.

Reference analog: VPP session-layer rule tables driven by the VPPTCP
renderer over the binary API (plugins/policy/renderer/vpptcp/rule/
session_rule.go:32-83 — scope LOCAL per app-namespace / GLOBAL, 5-tuple
match, allow/deny action, batched SessionRuleAddDel updates
vpptcp_renderer.go:269-327, dump :195-238).

Device shape: rules for *all* namespaces live in one packed SoA
table in device memory; a connection batch (direction + app-ns index +
5-tuple per connection) is filtered in one pass of tensor ops on the
engine's device (the agent's dataplane device; no hand-written kernel:
the reference's filter is a ``jax.jit`` of plain array ops). Scope selects
which connections a rule can see, mirroring where the reference's
tables sit in the path: LOCAL rules filter their namespace's *outbound
connects* (traffic entering the vswitch from the app — the ingress
orientation), the GLOBAL table filters *inbound accepts* arriving from
outside the node. The two directions are disjoint, so a connection is
only ever evaluated against one scope; within it, specificity
precedence decides (see SessionRule).
"""

from __future__ import annotations

import enum
import threading
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vpp_tpu_torch.pipeline.tables import resolve_device

GLOBAL_NS = -1  # namespace value marking GLOBAL scope rules


class RuleScope(enum.IntEnum):
    LOCAL = 1
    GLOBAL = 2


class ConnDirection(enum.IntEnum):
    CONNECT = 0   # outbound connect() from a local namespace → LOCAL rules
    ACCEPT = 1    # inbound accept() from outside the node → GLOBAL rules


class RuleAction(enum.IntEnum):
    DENY = 0
    ALLOW = 1


class SessionRule(NamedTuple):
    """One installed session rule (hashable — engine state is a set).

    No insertion order: like VPP's session lookup tables, precedence is
    *specificity* (longer prefixes + exact ports win; LOCAL scope over
    GLOBAL; deny over allow on exact ties). The renderer-cache's tables
    are canonically most-specific-first, so specificity precedence
    reproduces their first-match verdicts while keeping rule identity
    stable across table rebuilds — which is what makes wire deltas
    minimal (a reordered table doesn't change its rules' identities).
    """

    scope: int              # RuleScope
    appns_index: int        # app namespace index (LOCAL), -1 for GLOBAL
    transport_proto: int    # 6 TCP / 17 UDP
    lcl_net: int            # local (pod-side) network, pre-masked uint32
    lcl_plen: int
    rmt_net: int            # remote network, pre-masked uint32
    rmt_plen: int
    lcl_port: int           # 0 = any
    rmt_port: int           # 0 = any
    action: int             # RuleAction
    tag: str = ""           # originating table id (dump/debug)

    def specificity_key(self) -> Tuple[int, ...]:
        """Sort key: most specific first (dump/debug ordering)."""
        return (
            self.scope,
            -(self.lcl_plen + self.rmt_plen),
            -int(self.lcl_port != 0) - int(self.rmt_port != 0),
            self.action,
        )


def _mask_of(plen: int) -> int:
    return 0 if plen == 0 else ((1 << 32) - 1) ^ ((1 << (32 - plen)) - 1)


class _Packed(NamedTuple):
    ns: torch.Tensor        # int32 [R], GLOBAL_NS for global scope
    proto: torch.Tensor     # int32 [R]
    lcl_net: torch.Tensor   # int64 [R] (uint32 value)
    lcl_mask: torch.Tensor  # int64 [R]
    rmt_net: torch.Tensor   # int64 [R]
    rmt_mask: torch.Tensor  # int64 [R]
    lcl_port: torch.Tensor  # int32 [R] (0 = any)
    rmt_port: torch.Tensor  # int32 [R]
    action: torch.Tensor    # int32 [R]
    prio: torch.Tensor      # int32 [R] lower wins (scope-major, then order)
    n: int                  # live rules


def _filter_kernel(
    packed: _Packed,
    direction: torch.Tensor, ns: torch.Tensor, proto: torch.Tensor,
    lcl_ip: torch.Tensor, lcl_port: torch.Tensor,
    rmt_ip: torch.Tensor, rmt_port: torch.Tensor,
) -> torch.Tensor:
    """[C] connections × [R] rules → allow mask [C] (default allow).

    Addresses are int64 holding uint32 values, so the prefix compares
    are unsigned. ``argmin`` picks the first index among equal
    priorities, as ``jnp.argmin`` does."""
    live = torch.arange(packed.ns.shape[0], device=packed.ns.device) \
        < packed.n
    is_global = packed.ns[None, :] == GLOBAL_NS
    scope_ok = torch.where(
        direction[:, None] == int(ConnDirection.ACCEPT),
        is_global,
        ~is_global & (packed.ns[None, :] == ns[:, None]),
    )
    m = (
        live[None, :]
        & scope_ok
        & (packed.proto[None, :] == proto[:, None])
        & ((lcl_ip[:, None] & packed.lcl_mask[None, :]) == packed.lcl_net[None, :])
        & ((rmt_ip[:, None] & packed.rmt_mask[None, :]) == packed.rmt_net[None, :])
        & ((packed.lcl_port[None, :] == 0) | (packed.lcl_port[None, :] == lcl_port[:, None]))
        & ((packed.rmt_port[None, :] == 0) | (packed.rmt_port[None, :] == rmt_port[:, None]))
    )
    big = 1 << 30
    prio = torch.where(m, packed.prio[None, :], big)
    best = prio.min(dim=1).values
    idx = prio.argmin(dim=1)
    matched = best < big
    return torch.where(matched, packed.action[idx] == int(RuleAction.ALLOW),
                       True)


class SessionRuleEngine:
    """Installed-rule store + batch filter on one device.

    ``apply(add, delete)`` is the batched SessionRuleAddDel analog: one
    call repacks and republishes the device table once regardless of how
    many rules changed. ``dump()`` returns the installed set (resync).
    ``device`` defaults to the card and raises without one; pass
    ``"cpu"`` to filter on the CPU.
    """

    def __init__(self, capacity: int = 4096, device=None):
        self.capacity = capacity
        self.device = resolve_device(device)
        self._rules: set = set()
        self._packed: Optional[_Packed] = None
        self._lock = threading.RLock()
        self._repack()

    # --- updates ---
    def apply(self, add: Iterable[SessionRule] = (), delete: Iterable[SessionRule] = ()) -> None:
        with self._lock:
            for r in delete:
                self._rules.discard(r)
            for r in add:
                self._rules.add(r)
            if len(self._rules) > self.capacity:
                raise RuntimeError(
                    f"session rule capacity {self.capacity} exceeded"
                )
            self._repack()

    def dump(self, scope: Optional[int] = None) -> List[SessionRule]:
        with self._lock:
            rules = list(self._rules)
        if scope is not None:
            rules = [r for r in rules if r.scope == scope]
        return sorted(rules, key=lambda r: (r.appns_index,) + r.specificity_key())

    def flush(self) -> None:
        with self._lock:
            self._rules.clear()
            self._repack()

    @property
    def num_rules(self) -> int:
        return len(self._rules)

    # --- filtering ---
    def check(
        self,
        conns: Sequence[Tuple[int, int, int, int, int, int, int]],
    ) -> np.ndarray:
        """Filter a connection batch.

        Each entry: (direction, appns_index, proto, lcl_ip, lcl_port,
        rmt_ip, rmt_port) — direction per ConnDirection; the appns index
        is ignored for ACCEPT (global) checks. Returns a bool array:
        True = allow. Unmatched connections default to allow (isolation
        arrives as explicit deny-all rules from the renderer, same as
        the reference).
        """
        if not conns:
            return np.zeros((0,), bool)
        with self._lock:
            packed = self._packed
        a = np.asarray(conns, np.int64)
        n = a.shape[0]
        cols = torch.from_numpy(a).to(self.device)
        i32 = [cols[:, k].to(torch.int32) for k in (0, 1, 2, 4, 6)]
        out = _filter_kernel(
            packed, i32[0], i32[1], i32[2],
            cols[:, 3] & 0xFFFFFFFF, i32[3],
            cols[:, 5] & 0xFFFFFFFF, i32[4],
        )
        return out.cpu().numpy()

    def check_connect(self, conns) -> np.ndarray:
        """Outbound connects: each entry (appns_index, proto, lcl_ip,
        lcl_port, rmt_ip, rmt_port), filtered by LOCAL-scope rules."""
        return self.check([(int(ConnDirection.CONNECT),) + tuple(c) for c in conns])

    def check_accept(self, conns) -> np.ndarray:
        """Inbound accepts from outside the node: each entry (proto,
        lcl_ip, lcl_port, rmt_ip, rmt_port), filtered by GLOBAL rules."""
        return self.check(
            [(int(ConnDirection.ACCEPT), GLOBAL_NS) + tuple(c) for c in conns]
        )

    # --- internals ---
    def _repack(self) -> None:
        rules = sorted(self._rules, key=lambda r: r.specificity_key())
        cap = self.capacity
        ns = np.full(cap, GLOBAL_NS - 1, np.int32)  # never matches when dead
        proto = np.zeros(cap, np.int32)
        lcl_net = np.zeros(cap, np.int64)
        lcl_mask = np.zeros(cap, np.int64)
        rmt_net = np.zeros(cap, np.int64)
        rmt_mask = np.zeros(cap, np.int64)
        lcl_port = np.zeros(cap, np.int32)
        rmt_port = np.zeros(cap, np.int32)
        action = np.zeros(cap, np.int32)
        prio = np.zeros(cap, np.int32)
        for i, r in enumerate(rules):
            ns[i] = GLOBAL_NS if r.scope == RuleScope.GLOBAL else r.appns_index
            proto[i] = r.transport_proto
            lcl_mask[i] = _mask_of(r.lcl_plen)
            lcl_net[i] = r.lcl_net & _mask_of(r.lcl_plen)
            rmt_mask[i] = _mask_of(r.rmt_plen)
            rmt_net[i] = r.rmt_net & _mask_of(r.rmt_plen)
            lcl_port[i] = r.lcl_port
            rmt_port[i] = r.rmt_port
            action[i] = r.action
            # Specificity precedence (see SessionRule doc): LOCAL scope
            # outranks GLOBAL, longer combined prefix wins, exact ports
            # win, deny wins exact ties. Lower prio value wins.
            scope_rank = 0 if r.scope == RuleScope.LOCAL else 1
            nports = int(r.lcl_port != 0) + int(r.rmt_port != 0)
            prio[i] = (
                scope_rank * (1 << 20)
                + (64 - (r.lcl_plen + r.rmt_plen)) * 8
                + (2 - nports) * 2
                + (1 if r.action == int(RuleAction.ALLOW) else 0)
            )
        dev = self.device
        self._packed = _Packed(
            *(torch.from_numpy(x).to(dev) for x in (
                ns, proto, lcl_net, lcl_mask, rmt_net, rmt_mask, lcl_port,
                rmt_port, action, prio)),
            n=len(rules),
        )
