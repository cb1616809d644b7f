"""Frame rings and device descriptor rings: vpp_tpu_torch vs vpp_tpu.

* ``DeviceDescRing``: geometry validation, cyclic acquire and
  backpressure, the double-buffer swap raced against concurrent
  releases (tests/test_device_rings.py's cases on the port's copy), and
  the port's one-buffer window layout;
* ``IORing`` edges: ``peek_nth`` across the slot wraparound, and
  ``push_packed`` into the last free slot and then a full ring;
* interop: a frame pushed through the reference's ring is read
  identically by the port's over the same buffers, and the other way
  round (the layout is byte-identical: the IO daemon shares these rings
  across a process boundary); ``PacketCodec.parse`` and ``pack_batch``
  give equal columns in both packages on tests/wire.py frames.

Every quantity compared is an integer or a byte: the tolerance is exact
equality.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from wire import make_frame

from vpp_tpu.io import rings as jrings
from vpp_tpu.native import pktio as jpktio
from vpp_tpu_torch.io import rings as trings
from vpp_tpu_torch.native import pktio as tpktio
from vpp_tpu_torch.native.ring import PV_COLUMNS, RING_COLUMNS, FrameRing

VEC = trings.VEC
CLIENT_IP = "10.1.1.2"
SERVER_IP = "10.1.1.3"


def _push_one(rings, codec, scratch, rx_if, tag, per=4):
    frames = [make_frame(CLIENT_IP, SERVER_IP, proto=17, sport=tag,
                         dport=2000 + j) for j in range(per)]
    cols, n = codec.parse(frames, rx_if, scratch)
    return rings.rx.push(cols, n, payload=scratch)


# --- DeviceDescRing --------------------------------------------------------

def test_geometry_validation():
    for kw in (dict(slots=3), dict(windows=1), dict(windows=3)):
        with pytest.raises(ValueError) as ref:
            jrings.DeviceDescRing(**kw)
        with pytest.raises(ValueError) as got:
            trings.DeviceDescRing(**kw)
        assert str(got.value) == str(ref.value)


def test_acquire_is_cyclic_and_backpressures():
    ring = trings.DeviceDescRing(slots=2, batch=8, windows=2)
    w0, d0, n0, s0 = ring.acquire(timeout=1)
    w1, _d1, _n1, _s1 = ring.acquire(timeout=1)
    assert (w0, w1) == (0, 1)
    assert d0.shape == (2, 5, 8) and n0.shape == (2,) and s0.shape == (2,)
    assert ring.in_flight() == 2
    assert ring.acquire(timeout=0.05) is None  # every window in flight
    ring.release(w0)
    got = ring.acquire(timeout=1)
    assert got is not None and got[0] == 0  # strict ring order
    ring.release(0)
    ring.release(1)
    with pytest.raises(RuntimeError):
        ring.release(0)  # double release
    assert ring.window_bytes() == jrings.DeviceDescRing(
        slots=2, batch=8, windows=2).window_bytes()


def test_double_buffer_swap_under_concurrent_release():
    """The stager's cyclic acquire raced against a fetcher releasing
    from another thread: strictly cyclic, never a held window, a
    blocked acquire woken when its window frees."""
    ring = trings.DeviceDescRing(slots=2, batch=4, windows=2)
    release_q: "queue.Queue" = queue.Queue()
    errors: list = []

    def fetcher():
        while True:
            w = release_q.get()
            if w is None:
                return
            time.sleep(0.0005)
            try:
                ring.release(w)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

    t = threading.Thread(target=fetcher)
    t.start()
    order = []
    try:
        for _ in range(200):
            got = ring.acquire(timeout=5)
            assert got is not None, "acquire starved"
            order.append(got[0])
            release_q.put(got[0])
    finally:
        release_q.put(None)
        t.join(timeout=30)
    assert not t.is_alive()
    assert not errors
    assert order == [i % 2 for i in range(200)]
    assert ring.in_flight() == 0


def test_window_is_one_buffer_in_the_window_program_layout():
    """A window's descriptors, clocks and stamps are views of ONE int32
    buffer — ``[S, 5, B]``, then ``[S]`` clocks, then ``[S]`` stamps —
    the layout of the window program's device rx buffer, so a window
    ships in one copy (pipeline/capture.py ``RingProgram``)."""
    ring = trings.DeviceDescRing(slots=4, batch=8, windows=2)
    w, desc, now, stamp = ring.acquire(timeout=1)
    rng = np.random.default_rng(0)
    desc[...] = rng.integers(-2 ** 31, 2 ** 31, desc.shape, np.int64)
    now[...] = [3, 1, 4, 1]
    stamp[...] = [5, 9, 2, 6]
    flat = ring.window(w)
    assert flat.dtype == np.int32 and flat.size == ring.window_words()
    assert ring.window_words() == 4 * (5 * 8 + 2)
    np.testing.assert_array_equal(flat[:160].reshape(4, 5, 8), desc)
    np.testing.assert_array_equal(flat[160:164], now)
    np.testing.assert_array_equal(flat[164:], stamp)
    # the other window is a buffer of its own
    assert not np.shares_memory(flat, ring.window(1 - w))


# --- IORing edges ------------------------------------------------------------

def test_peek_nth_across_slot_wraparound():
    rings = trings.IORingPair(n_slots=4)
    codec = tpktio.PacketCodec(snap=rings.rx.snap)
    scratch = np.zeros((VEC, rings.rx.snap), np.uint8)
    try:
        for tag in (100, 101, 102, 103):
            assert _push_one(rings, codec, scratch, 1, tag)
        assert not _push_one(rings, codec, scratch, 1, 999)  # full
        for expect in (100, 101):
            f = rings.rx.peek()
            assert int(f.cols["sport"][0]) == expect
            rings.rx.release()
        for tag in (104, 105):
            assert _push_one(rings, codec, scratch, 1, tag)
        assert rings.rx.pending() == 4
        for k, expect in enumerate((102, 103, 104, 105)):
            f = rings.rx.peek_nth(k)
            assert f is not None and int(f.cols["sport"][0]) == expect
            assert f.payload is not None
        assert rings.rx.peek_nth(4) is None
    finally:
        rings.close()


def test_push_packed_one_slot_short_then_full():
    rings = trings.IORingPair(n_slots=2)
    codec = tpktio.PacketCodec(snap=rings.rx.snap)
    scratch = np.zeros((VEC, rings.rx.snap), np.uint8)
    try:
        assert _push_one(rings, codec, scratch, 1, 100, per=3)
        rx_frame = rings.rx.peek()
        n = rx_frame.n
        batch = np.zeros((5, VEC), np.int32)
        cause = np.zeros(VEC, np.int32)
        for _ in range(2):  # the last free slot still takes one
            assert rings.tx.push_packed(batch, 0, n, rx_frame, -1, 0,
                                        cause)
        assert rings.tx.pending() == 2
        # a full ring refuses without corrupting state
        assert not rings.tx.push_packed(batch, 0, n, rx_frame, -1, 0,
                                        cause)
        assert rings.tx.pending() == 2
        assert rings.tx.peek().n == n
    finally:
        rings.close()


# --- interop with the reference ---------------------------------------------

def _shared_rings(writer, reader, n_slots=4, snap=256):
    """Two IORings over the same buffers: ``writer``'s package creates
    the ring, ``reader``'s attaches to it."""
    ring_sz, pay_sz = writer.IORing.required_sizes(n_slots, snap)
    assert (ring_sz, pay_sz) == reader.IORing.required_sizes(n_slots, snap)
    ring_buf, pay_buf = bytearray(ring_sz), bytearray(pay_sz)
    w = writer.IORing(ring_buf, pay_buf, n_slots, snap, create=True)
    r = reader.IORing(ring_buf, pay_buf, n_slots, snap, create=False)
    return w, r


def _frames(k, per=5):
    return [make_frame(CLIENT_IP, SERVER_IP, proto=6 if j % 2 else 17,
                       sport=30000 + k, dport=1000 + j, ttl=64 - j,
                       payload=bytes([k + j]) * (20 + 7 * j))
            for j in range(per)]


@pytest.mark.parametrize("writer,reader", [(jrings, trings),
                                           (trings, jrings)],
                         ids=["reference-to-port", "port-to-reference"])
def test_a_frame_crosses_the_packages_unchanged(writer, reader):
    w, r = _shared_rings(writer, reader)
    codec_w = (jpktio if writer is jrings else tpktio).PacketCodec(snap=256)
    scratch = np.zeros((VEC, 256), np.uint8)
    sent = []
    for k in range(6):  # past the 4 slots: the cursors wrap
        cols, n = codec_w.parse(_frames(k), 3, scratch)
        assert w.push(cols, n, payload=scratch, epoch=40 + k)
        sent.append(({c: np.array(v[:n]) for c, v in cols.items()}, n,
                     scratch[:n].copy()))
        got = r.peek()
        assert got is not None and got.n == n and got.epoch == 40 + k
        for c, v in sent[-1][0].items():
            np.testing.assert_array_equal(got.cols[c][:n], v, err_msg=c)
        wire = sent[-1][0]["pkt_len"] + 14
        for j in range(n):
            assert bytes(got.payload[j, :wire[j]]) == \
                bytes(sent[-1][2][j, :wire[j]])
        r.release()
    assert r.pending() == w.pending() == 0


def test_packed_results_cross_the_packages_unchanged():
    """``push_packed`` into a reference ring is read back by the port's
    (and the other way round) with the same decoded columns and drop
    causes as the same call on a ring of the reader's own package."""
    rng = np.random.default_rng(7)
    batch = rng.integers(-2 ** 31, 2 ** 31, (5, VEC), np.int64).astype(
        np.int32)
    out = {}
    for writer, reader in ((jrings, trings), (trings, jrings),
                           (trings, trings)):
        w, r = _shared_rings(writer, reader)
        rx_w, rx_r = _shared_rings(writer, writer)
        codec = (jpktio if writer is jrings else tpktio).PacketCodec(
            snap=256)
        scratch = np.zeros((VEC, 256), np.uint8)
        cols, n = codec.parse(_frames(1, per=7), 2, scratch)
        assert rx_w.push(cols, n, payload=scratch)
        cause = np.zeros(VEC, np.int32)
        assert w.push_packed(batch, 3, n, rx_r.peek(), 9, 77, cause)
        got = r.peek()
        out[(writer, reader)] = ({c: np.array(got.cols[c][:n])
                                  for c, _ in RING_COLUMNS},
                                 cause[:n].copy(), got.epoch)
    base = out[(trings, trings)]
    for key, (cols, cause, epoch) in out.items():
        assert epoch == base[2] == 77
        np.testing.assert_array_equal(cause, base[1])
        for c, v in cols.items():
            np.testing.assert_array_equal(v, base[0][c], err_msg=c)


def test_codec_parse_and_pack_match_the_reference():
    frames = _frames(3, per=9) + [b"\x00" * 10,  # truncated, not IPv4
                                  make_frame(SERVER_IP, CLIENT_IP, ttl=1)]
    got = []
    for pkg in (jpktio, tpktio):
        codec = pkg.PacketCodec(snap=512)
        scratch = np.zeros((VEC, 512), np.uint8)
        cols, n = codec.parse(frames, 5, scratch)
        block = pkg.flatten_cols({c: np.array(v) for c, v in cols.items()})
        got.append((cols, n, scratch[:n].copy(), block))
    (jc, jn, jp, jb), (tc, tn, tp, tb) = got
    assert tn == jn == len(frames)
    for c, _dt in RING_COLUMNS:
        np.testing.assert_array_equal(tc[c], jc[c], err_msg=c)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb, jb)
    # pack_batch (the pump's native packer) over both packages' blocks
    packed = []
    for pkg, block in ((jpktio, jb), (tpktio, tb)):
        block = np.ascontiguousarray(block)
        flat = np.zeros((5, VEC), np.int32)
        non_ip = np.zeros(VEC, np.uint8)
        bases = np.array([block.ctypes.data], np.uint64)
        pkg.pack_batch(bases, np.array([tn], np.uint32), 1, flat, non_ip)
        packed.append((flat, non_ip))
    np.testing.assert_array_equal(packed[1][0], packed[0][0])
    np.testing.assert_array_equal(packed[1][1], packed[0][1])


def test_to_packet_vector_lifts_the_pipeline_columns():
    ring_sz = FrameRing.required_size(2)
    ring = FrameRing(bytearray(ring_sz), n_slots=2)
    rng = np.random.default_rng(1)
    cols = {c: rng.integers(0, 2 ** 31, VEC).astype(dt)
            for c, dt in RING_COLUMNS}
    cols["src_ip"] = np.full(VEC, 0xFFFFFFFE, np.uint32)
    pv = ring.to_packet_vector(cols)
    assert pv._fields == tuple(c for c, _ in PV_COLUMNS)
    for c, _dt in PV_COLUMNS:
        t = getattr(pv, c)
        assert t.dtype == torch.int32 and t.shape == (VEC,)
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      cols[c].view(np.uint32))


# --- the shared-memory attach: an IO daemon's exit leaves the rings ------

_ATTACH_CHILD = """
import os, signal, sys
import numpy as np
sys.path.insert(0, {root!r})
from vpp_tpu_torch.io.rings import IORingPair
from vpp_tpu_torch.native.pktio import PacketCodec
rings = IORingPair(n_slots=4, snap=256, shm_name={name!r}, create=False)
scratch = np.zeros((256, 256), np.uint8)
cols, n = PacketCodec(snap=256).parse([bytes.fromhex({frame!r})], {rx_if},
                                      scratch)
assert rings.rx.push(cols, n, payload=scratch)
if {kill}:
    os.kill(os.getpid(), signal.SIGKILL)
rings.close()
"""


def test_attached_daemon_exit_leaves_the_rings(tmp_path):
    """Two processes in turn attach to the creator's rings, push one
    frame and exit, the first by SIGKILL (an IO daemon that dies and is
    respawned from its plan): the second still attaches, and the creator
    reads both frames. An attaching ``IORingPair`` that left its segment
    to its own resource tracker would have the segment unlinked at the
    first child's exit, and the second child's attach would fail."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    name = f"vpp_tpu_torch_attach_{os.getpid()}"
    rings = trings.IORingPair(n_slots=4, snap=256, shm_name=name,
                              create=True)
    try:
        for k, kill in enumerate((True, False)):
            frame = make_frame(CLIENT_IP, SERVER_IP, proto=17,
                               sport=7000 + k, dport=80)
            code = _ATTACH_CHILD.format(root=root, name=name,
                                        frame=frame.hex(), rx_if=3 + k,
                                        kill=kill)
            proc = subprocess.run([sys.executable, "-c", code],
                                  capture_output=True, text=True,
                                  timeout=30)
            want = -9 if kill else 0
            assert proc.returncode == want, proc.stderr
            assert os.path.exists(f"/dev/shm/{name}")
        got = []
        for _ in range(2):
            f = rings.rx.peek()
            assert f is not None
            got.append((int(f.n), int(f.cols["rx_if"][0]),
                        int(f.cols["sport"][0])))
            rings.rx.release()
        del f  # its views pin the segment's buffer
        assert got == [(1, 3, 7000), (1, 4, 7001)]
    finally:
        rings.close(unlink=True)
    assert not os.path.exists(f"/dev/shm/{name}")
