"""The ring window program and PersistentPump: vpp_tpu_torch vs vpp_tpu.

* The port's window program (the ``RingProgram`` of pipeline/capture.py
  that ``Dataplane.ring_checkout`` hands the persistent pump) against the
  reference's
  ``_jitted_step(..., "ring", ring_slots=S)`` on the same tables (carried
  across with ``interop.tables_from_numpy``) and the same ``rx_ring``,
  ``rx_now`` and fill: fills 1, S - 1 and S on the full chain and on the
  auto path, then the ring form under each knob ported since the ring
  was refused (``telemetry: full`` with its rider and stamp lane,
  ``tenancy: on``, ``svc_vips``, ``fib_ecmp_groups``, ``ml_stage:
  enforce``, ``sess_hash: sym``): the tx ring, the aux ring, the cursor,
  the rider and every state plane after the window must be equal;
* under the overlay the ring form raises the reference's ValueError;
* ``PersistentPump`` against the reference's on the same frames at the
  same explicit clocks: every result in order, a mid-stream
  ``checkpoint_sessions``, the final tables, ``stop`` with and without
  traffic, and the ``ring.dispatch`` / ``ring.fetch`` faults surfacing
  as the reference's RuntimeError;
* a ring restart that changes no shape captures nothing.

Frames come from a NumPy seed. Every quantity compared is an integer:
the tolerance is exact equality.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpp_tpu.ir import rule as jrule
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import persistent as jpers
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline.vector import Disposition, ip4
from vpp_tpu.testing import faults as jfaults
from vpp_tpu_torch.interop import tables_from_numpy, tables_to_numpy
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.pipeline import capture as tcap
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import persistent as tpers
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.testing import faults as tfaults

from test_ml_stage import proto_model

B, S = 32, 4
_CFG = dict(max_tables=2, max_rules=16, max_global_rules=32, max_ifaces=8,
            fib_slots=32, sess_slots=256, nat_mappings=4, nat_backends=4)
VIP = ip4("10.96.0.10")
PEER = ip4("192.168.16.2")
TENANTS = ({"id": 1, "prefixes": ["10.9.0.0/16"], "rate": 1, "burst": 12,
            "sess_buckets": 8},
           {"id": 2, "prefixes": ["10.8.0.0/16"], "ml_mode": "score"})
# each knob ported since the ring form was refused (the auto path)
KNOBS = {
    "telemetry": dict(telemetry="full"),
    "tenancy": dict(tenancy="on"),
    "svc_vips": dict(svc_vips=4),
    "fib_ecmp_groups": dict(fib_ecmp_groups=2),
    "ml_stage": dict(ml_stage="enforce"),
    "sess_hash": dict(sess_hash="sym"),
}


def _stage(dp, m, cfg):
    """An uplink, a pod /24, a default route out of the uplink (through
    an ECMP group when the config has groups), deny TCP 23 + permit,
    and whatever the config's knobs stage: a service VIP, tenants, a
    model."""
    up = dp.add_uplink()
    pod = dp.add_pod_interface(("default", "web"))
    b = dp.builder
    b.add_route("10.1.1.0/24", pod, Disposition.LOCAL)
    if cfg.fib_ecmp_groups:
        b.set_nh_group(1, [(PEER, up, 1), (PEER + 1, up, 2)])
        b.add_route("0.0.0.0/0", up, Disposition.REMOTE, node_id=1,
                    group=1)
    else:
        b.add_route("0.0.0.0/0", up, Disposition.REMOTE, node_id=1)
    R, A, P = m.ContivRule, m.Action, m.Protocol
    b.set_global_table([R(action=A.DENY, protocol=P.TCP, dest_port=23),
                        R(action=A.PERMIT)])
    if cfg.svc_vips:
        b.set_service(VIP, 80, 6, [(ip4("10.1.1.40"), 8080, 1),
                                   (ip4("10.1.1.41"), 8080, 2)])
    if cfg.tenancy == "on":
        for e in TENANTS:
            b.set_tenant(e["id"], **{k: v for k, v in e.items()
                                     if k != "id"})
    if cfg.ml_stage != "off":
        b.set_ml_model(proto_model(flag_thresh=10).to_dict())
    dp.swap()
    return up, pod


def pair(**over):
    """One dataplane per package, staged alike."""
    kw = dict(_CFG, **over)
    j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
    t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
    up, pod = _stage(j, jrule, j.config)
    assert _stage(t, trule, t.config) == (up, pod)
    return j, t, up, pod


def packed(cols: dict, n: int = B) -> np.ndarray:
    flat = np.zeros((5, n), np.int32)
    jdp.pack_packet_columns(flat.view(np.uint32), cols, n)
    return flat


def forward(up: int, seed: int, n: int = B) -> dict:
    """Flows from outside to the pod /24: TCP 80 (permitted), TCP 23
    (denied), UDP, a few to the service VIP, from two tenants' nets."""
    r = np.random.default_rng(seed)
    src = np.where(r.random(n) < 0.5, ip4("10.9.0.0"), ip4("10.8.0.0"))
    dst = ip4("10.1.1.0") + r.integers(2, 30, n)
    dst = np.where(r.random(n) < 0.15, VIP, dst)
    return {"src_ip": (src + r.integers(1, 60, n)).astype(np.uint32),
            "dst_ip": dst.astype(np.uint32),
            "proto": r.choice([6, 6, 6, 17], n).astype(np.uint32),
            "sport": r.integers(1024, 1100, n).astype(np.uint32),
            "dport": r.choice([80, 80, 23, 53], n).astype(np.uint32),
            "ttl": np.full(n, 64, np.uint32),
            "pkt_len": r.integers(60, 1500, n).astype(np.uint32),
            "rx_if": np.full(n, up, np.uint32),
            "flags": (r.random(n) < 0.9).astype(np.uint32)}


def replies(cols: dict, pod: int, t=None) -> dict:
    """The replies of ``cols``' packets, from the pods; with the port's
    dataplane ``t``, only of those it forwards to a pod
    (``process_packed(commit=False)`` keeps nothing), each of which
    hits its session: the other lanes invalid. Both sides then get the
    same frames."""
    out = dict(cols)
    out.update(src_ip=cols["dst_ip"], dst_ip=cols["src_ip"],
               sport=cols["dport"], dport=cols["sport"],
               rx_if=np.full(len(cols["flags"]), pod, np.uint32))
    if t is not None:
        res = t.process_packed(packed(cols), commit=False).numpy()
        disp = (res.view(np.uint32)[3] >> 24) & 0xF
        out["flags"] = cols["flags"] * (
            (disp == int(Disposition.LOCAL)) & (cols["dst_ip"] != VIP))
    return out


def window_frames(t, up: int, pod: int, seed: int):
    """S frames: forward, the replies of its forwarded packets
    (established: the fast tier on the auto path), forward, its
    replies."""
    f0, f2 = forward(up, seed), forward(up, seed + 1)
    return np.stack([packed(c) for c in (
        f0, replies(f0, pod, t), f2, replies(f2, pod, t))][:S])


def _ref_ring(j, rx, now, stamps, now_us, n, cursor):
    """The reference's window program over a copy of ``j``'s tables."""
    step = jdp._jitted_step(
        j._classifier_impl, j._skip_local, j._use_fastpath, "ring",
        sweep_stride=j._sweep_stride, ring_slots=S, ml_mode=j._ml_mode,
        ml_kind=j._ml_kind, tel_mode=j._tel_mode, tnt_mode=j._tnt_mode,
        fib_impl=j._fib_impl, sess_impl=j._session_impl,
        sess_hash=j._sess_hash)
    tables = jax.tree_util.tree_map(jnp.copy, j.tables)
    args = (tables, jnp.int32(cursor), rx.copy(), now.copy())
    if j._tel_mode != "off":
        out = step(*args, stamps.copy(), np.int32(now_us), np.int32(n))
    else:
        out = step(*args, np.int32(n)) + (None,)
    _tables, cursor, tx, aux, tel = out
    return [np.asarray(tx), np.asarray(aux), int(cursor),
            None if tel is None else np.asarray(tel)], out[0]


def _port_ring(t, tables_np, rx, now, stamps, now_us, n, cursor):
    """The port's window program, as the persistent pump checks it out
    (``ring_checkout`` copies the live tables into its private clone),
    over ``tables_np`` (a fresh copy of the reference's tables) on
    ``t``'s selection."""
    t.tables = tables_from_numpy(tables_np, torch.device("cpu"), t.config)
    ring = t.ring_checkout(S, B)
    try:
        ring.cursor.fill_(cursor)
        ring.rx.copy_(torch.from_numpy(np.concatenate(
            [rx.reshape(-1), now, stamps]).astype(np.int32)))
        tx, aux, tel = ring.views(ring.run(n, now_us).numpy())
    finally:
        t.ring_checkin(ring)
    return [tx, aux, int(ring.cursor), tel], ring


def assert_window(j, t, rx, now, n, stamps=None, now_us=0, cursor=7):
    """One window through both programs; everything equal. Returns the
    reference's aux ring and the port's ring program."""
    stamps = np.zeros(S, np.int32) if stamps is None else stamps
    arrays = {f: np.asarray(getattr(j.tables, f)) for f in
              j.tables._fields}
    (jtx, jaux, jcur, jtel), jtabs = _ref_ring(j, rx, now, stamps, now_us,
                                              n, cursor)
    (ttx, taux, tcur, ttel), ring = _port_ring(t, arrays, rx, now, stamps,
                                               now_us, n, cursor)
    np.testing.assert_array_equal(ttx, jtx, err_msg="tx ring")
    np.testing.assert_array_equal(taux, jaux, err_msg="aux ring")
    assert tcur == int(jcur) == cursor + n
    if jtel is None:
        assert ttel is None
    else:
        np.testing.assert_array_equal(ttel, jtel, err_msg="rider")
    got = tables_to_numpy(ring.tables)
    for f, v in got.items():
        np.testing.assert_array_equal(
            v, np.asarray(getattr(jtabs, f)).astype(v.dtype), err_msg=f)
    return jaux, ring


@pytest.mark.parametrize("fastpath", [False, True], ids=["full", "auto"])
@pytest.mark.parametrize("n", [1, S - 1, S])
def test_window_program_matches_reference(fastpath, n):
    j, t, up, pod = pair(fastpath=fastpath)
    assert (j._use_fastpath, t._use_fastpath) == (fastpath, fastpath)
    rx = window_frames(t, up, pod, seed=3)
    now = np.array([5, 5, 9, 12], np.int32)
    aux, ring = assert_window(j, t, rx, now, n)
    # the auto path read one dispatch flag a slot, the full chain none
    assert ring.prog.host_reads == (n if fastpath else 0)
    if fastpath and n > 1:
        # the replies rode the fast tier inside the window
        assert aux[1, 0] == 1 and aux[0, 0] == 0


@pytest.fixture(scope="module")
def every_knob():
    """One window at fill S under every knob at once, checked equal to
    the reference's (tx, aux, cursor, rider, every state plane): the
    per-knob cases below read what their knob did in it."""
    j, t, up, pod = pair(**{k: v for o in KNOBS.values()
                            for k, v in o.items()})
    assert t._sess_hash == "sym" and t._ml_mode == "enforce"
    rx = window_frames(t, up, pod, seed=11)
    now = np.array([40, 41, 41, 50], np.int32)
    stamps = np.array([1000, 0, 1500, 3], np.int32)
    aux, ring = assert_window(j, t, rx, now, S, stamps=stamps, now_us=2100)
    tx, _aux, _tel = ring.views(ring.out.numpy())
    return dict(rx=rx, aux=aux, tx=tx, tables=tables_to_numpy(ring.tables))


def _aux(w, name):
    return w["aux"][:, jdp.PACKED_AUX_SCHEMA.index(name)]


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_ring_form_runs_under_knob(knob, every_knob):
    """The ring form under each knob the port once refused it under
    (the window of ``every_knob``, equal to the reference's), and the
    knob's own mark on that window."""
    w = every_knob
    if knob == "telemetry":
        # slots 0 and 2 stamped (latencies 1,100 and 600 µs), slot 1
        # unstamped, slot 3 observed at 2,097 µs; the rider compared
        assert (_aux(w, "tel_observed")[[0, 2, 3]] > 0).all()
        assert _aux(w, "tel_observed")[1] == 0
        assert w["tables"]["tel_lat_hist"].sum() > 0
    elif knob == "tenancy":
        assert _aux(w, "tnt_limited").sum() > 0
    elif knob == "ml_stage":
        assert _aux(w, "ml_scored").sum() > 0
        assert _aux(w, "ml_flagged").sum() > 0  # the UDP packets
    elif knob == "svc_vips":
        # packets to the VIP left DNAT'd to its backends
        vip = (w["rx"][:, 1] == np.int32(np.uint32(VIP).view(np.int32)))
        backends = {ip4("10.1.1.40"), ip4("10.1.1.41")}
        got = set(w["tx"][:, 1][vip].view(np.uint32).tolist())
        assert vip.any() and got & backends
    elif knob == "fib_ecmp_groups":
        assert w["tables"]["fib_ecmp_c"].sum() > 0
    else:
        assert _aux(w, "sess_hits").sum() > 0  # replies hit, sym hash


def test_ring_form_refused_under_the_overlay():
    """The packed ring boundary carries no inner-header sidecar: the
    port raises the reference's own ValueError, before anything else."""
    with pytest.raises(ValueError) as ref:
        jdp._jitted_step("dense", False, False, "ring", ring_slots=S,
                         overlay="vxlan")
    t = tdp.Dataplane(ttables.DataplaneConfig(**dict(_CFG,
                                                     overlay="vxlan")),
                      device="cpu")
    with pytest.raises(ValueError) as got:
        t.ring_checkout(S, B)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as got, t._lock:
        t._program(False, "ring", (S, 5, B))
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="supports only the plain"):
        tpers.PersistentPump(t, batch=B, ring_slots=S)


# --- PersistentPump --------------------------------------------------------

def _ref_pump(j, slots=S):
    """The reference's PersistentPump on ``j``'s selection (unstarted)."""
    return jpers.PersistentPump(
        j.tables, batch=B, fastpath=j._use_fastpath,
        classifier=j._classifier_impl, skip_local=j._skip_local,
        sweep_stride=j._sweep_stride, ring_slots=slots, ring_windows=2,
        ml_mode=j._ml_mode, ml_kind=j._ml_kind, tel_mode=j._tel_mode,
        tnt_mode=j._tnt_mode, sess_hash=j._sess_hash)


def _pumps(j, t, slots=S):
    return _ref_pump(j, slots).start(), tpers.PersistentPump(
        t, batch=B, ring_slots=slots, ring_windows=2).start()


def test_persistent_pump_matches_reference():
    """Ten frames at explicit clocks through both pumps: the same rows,
    aux rows and order; a checkpoint mid-stream equal; the final tables
    equal; the live dataplane untouched until the graft; no callback."""
    j, t, up, pod = pair()
    before = tables_to_numpy(t.tables)
    frames = []
    for k in range(3):
        f = forward(up, 20 + k)
        frames += [packed(f), packed(replies(f, pod, t))]
    frames += [packed(forward(up, 30)) for _ in range(4)]
    jp, tp = _pumps(j, t)
    try:
        for k, flat in enumerate(frames[:6]):
            for p in (jp, tp):
                p.submit(flat, now=3 * k + 1)
        got = [(jp.result_ex(timeout=30), tp.result_ex(timeout=30))
               for _ in range(6)]
        jck = jp.checkpoint_sessions(timeout=30)
        tck = tp.checkpoint_sessions(timeout=30)
        assert jck is not None and tck is not None
        for f in ttables.SESSION_FIELDS:
            np.testing.assert_array_equal(
                ttables.numpy_of(f, tck[f]),
                np.asarray(jck[f]).astype(
                    ttables.numpy_of(f, tck[f]).dtype), err_msg=f)
        for k, flat in enumerate(frames[6:]):
            for p in (jp, tp):
                p.submit(flat, now=40 + k)
        got += [(jp.result_ex(timeout=30), tp.result_ex(timeout=30))
                for _ in range(4)]
    finally:
        jfinal, tfinal = jp.stop(), tp.stop()
    for k, ((jo, ja), (to, ta)) in enumerate(got):
        np.testing.assert_array_equal(to, np.asarray(jo), err_msg=str(k))
        np.testing.assert_array_equal(ta, np.asarray(ja), err_msg=str(k))
    assert sum(int(a[0]) for _, (_, a) in got) >= 2  # the fast tier ran
    want = {f: np.asarray(getattr(jfinal, f)) for f in jfinal._fields}
    for f, v in tables_to_numpy(tfinal).items():
        np.testing.assert_array_equal(v, want[f].astype(v.dtype),
                                      err_msg=f)
    assert int(want["sess_valid"].sum()) > 0
    snap = tp.stats_snapshot()
    assert snap["io_callbacks"] == 0 and snap["ring_lag"] == 0
    assert snap["ring_frames"] == len(frames)
    assert snap["host_reads"] == len(frames)  # the auto path's flags
    # the ring stepped its private clone: the live tables are as staged
    for f, v in tables_to_numpy(t.tables).items():
        np.testing.assert_array_equal(v, before[f], err_msg=f)


def test_stop_without_traffic():
    j, t, _up, _pod = pair(fastpath=False)
    jp, tp = _pumps(j, t)
    jf, tf = jp.stop(), tp.stop()
    assert tf is not None and jf is not None
    assert int(tf.sess_valid.sum()) == int(np.asarray(jf.sess_valid).sum())
    assert tp.stats_snapshot()["host_reads"] == 0  # the full chain


@pytest.mark.parametrize("point", ["ring.dispatch", "ring.fetch"])
def test_faults_surface_as_the_reference_runtime_error(point):
    """An injected dispatch or fetch failure kills the ring on both
    sides: the next result raises the reference's RuntimeError, and so
    does stop (after the port's ring program went back)."""
    j, t, up, _pod = pair(fastpath=False)
    errors = []
    for mod in (jfaults, tfaults):
        mod.install(mod.FaultPlan(seed=1)).inject(point, times=-1)
        try:
            p = (tpers.PersistentPump(t, batch=B, ring_slots=S)
                 if mod is tfaults else _ref_pump(j)).start()
            p.submit(packed(forward(up, 1)), now=1)
            deadline = time.monotonic() + 30
            while not p.failed and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(RuntimeError) as err:
                p.result_ex(timeout=0.01)
            errors.append(str(err.value))
            with pytest.raises(RuntimeError):
                p.stop()
            assert p.failed
        finally:
            mod.uninstall()
    assert errors[0] == errors[1] == "persistent loop died"
    # the port's ring program went back: a new ring checks it out
    tpers.PersistentPump(t, batch=B, ring_slots=S).start().stop()


def test_restart_that_changes_no_shape_captures_nothing():
    """A swap that changes no shape, then a new ring: the held clone
    takes the new epoch's tables and replays the programs captured for
    the first ring — zero captures — and steps the new epoch."""
    _j, t, up, pod = pair()
    tp = tpers.PersistentPump(t, batch=B, ring_slots=S).start()
    tp.submit(packed(forward(up, 5)), now=1)
    tp.result_ex(timeout=30)
    tp.stop()
    ring = t._ring[1]
    t.builder.set_global_table([trule.ContivRule(
        action=trule.Action.DENY, protocol=trule.Protocol.TCP,
        dest_port=80), trule.ContivRule(action=trule.Action.PERMIT)])
    t.swap()
    with tcap.capture_budget(0):
        tp = tpers.PersistentPump(t, batch=B, ring_slots=S).start()
        f = forward(up, 6)
        tp.submit(packed(f), now=2)
        out, _aux = tp.result_ex(timeout=30)
        tp.stop()
    assert t._ring[1] is ring
    # the new epoch's policy: every valid TCP 80 packet dropped
    disp = (out.view(np.uint32)[3] >> 24) & 0xF
    tcp80 = (f["proto"] == 6) & (f["dport"] == 80) & (f["flags"] == 1) \
        & (f["dst_ip"] != VIP)
    assert tcp80.any() and (disp[tcp80] == int(Disposition.DROP)).all()


def test_only_the_current_selections_ring_is_held():
    """The dataplane holds one ring program, under the key its step
    programs use: a checkout under another geometry or selection drops
    the held clone and its graphs, and a checkout under the held key
    while that ring is live is refused."""
    _j, t, _up, _pod = pair()
    assert t._use_fastpath
    first = t.ring_checkout(S, B)
    with pytest.raises(RuntimeError, match="already live"):
        t.ring_checkout(S, B)
    t.ring_checkin(first)
    with t._lock:
        key = t._key(True, t._skip_local, "ring", (S, 5, B))
    assert t._ring == (key, first)
    other = t.ring_checkout(S // 2, B)
    t.ring_checkin(other)
    assert t._ring[1] is other and other is not first
    t.fastpath_enabled = False
    t.swap()
    full = t.ring_checkout(S // 2, B)
    t.ring_checkin(full)
    assert t._ring[1] is full and full.prog.prefix is None
    assert t._ring[0][2] is False  # the tier in the shared key
