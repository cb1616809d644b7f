"""The bit-packed entry points: vpp_tpu_torch against vpp_tpu.

* The numpy surface — ``PACKED_*``, ``packed_input_zeros``,
  ``pack_packet_columns``, ``unpack_packet_input`` and
  ``unpack_packet_result`` — equals the reference's on the
  tests/test_packed_boundary.py field ranges (seeded batches), and the
  device decode ``graph.packed_vector`` equals the host decode.
* ``process_packed`` and ``process_packed_chain`` (K = 1, 3; the fast
  path engaged and forced off) on the
  ``test_packed_step_equals_unpacked_step`` staging: every packed
  output row, every aux row and the final session / NAT state equal the
  reference's, the fast-path aux rows included on an all-established
  reply batch; ``commit=False`` keeps nothing.
* The whole step called with the clock as a 0-d int32 tensor equals
  the reference's step.

Every quantity is an integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from test_packed_boundary import VEC, field_ranges
from test_torch_pipeline import _STATE, _assert_results
from test_torch_tables import assert_same
from vpp_tpu.ir import rule as jrule
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import graph as tgraph
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

VIP = "10.96.0.10"


def _columns(seed: int):
    """A seeded batch of header columns over the boundary's ranges."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, VEC + 1))
    cols = {}
    for name, (lo, hi) in field_ranges.items():
        vals = rng.integers(lo, hi + 1, n, dtype=np.uint64)
        cols[name] = (vals.astype(np.uint32) if name in ("src_ip", "dst_ip")
                      else vals.astype(np.int32))
    return cols, n


def test_numpy_constants_match_reference():
    assert tdp.PACKED_IN_ROWS == jdp.PACKED_IN_ROWS
    assert tdp.PACKED_OUT_ROWS_N == jdp.PACKED_OUT_ROWS_N
    assert tdp.PACKED_AUX_SCHEMA == jdp.PACKED_AUX_SCHEMA
    assert tdp.PACKED_AUX_ROWS == jdp.PACKED_AUX_ROWS == 12
    for n in (1, VEC):
        want = jdp.packed_input_zeros(n)
        got = tdp.packed_input_zeros(n)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_pack_and_unpack_input_match_reference(seed):
    cols, n = _columns(seed)
    flats = []
    for mod in (jdp, tdp):
        flat = mod.packed_input_zeros(VEC)
        mod.pack_packet_columns(flat.view(np.uint32), cols, n)
        flats.append(flat)
    assert np.array_equal(flats[0], flats[1])
    want = jdp.unpack_packet_input(flats[0])
    got = tdp.unpack_packet_input(flats[1])
    for name in field_ranges:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
        assert np.array_equal(got[name][:n].astype(np.uint32),
                              cols[name].astype(np.uint32)), name
    # the device decode of the step equals the host decode
    pv = tgraph.packed_vector(torch.from_numpy(flats[1]))
    for name in field_ranges:
        assert_same(want[name], getattr(pv, name), name)


@pytest.mark.parametrize("seed", range(4))
def test_unpack_result_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    out = rng.integers(0, 1 << 32, (5, VEC), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    out[3, ::7] = out[3, ::7] | 0xFFFF  # the tx_if sentinel
    want = jdp.unpack_packet_result(np.array(out))
    got = tdp.unpack_packet_result(np.array(out))
    assert want.keys() == got.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name


def _stage(dp, rule, disp, ip4):
    """tests/test_packed_boundary.py
    ``test_packed_step_equals_unpacked_step``: two pods on an uplink, a
    UDP/53-only local table on pod a, a one-backend VIP."""
    uplink = dp.add_uplink()
    a = dp.add_pod_interface(("default", "a"))
    b = dp.add_pod_interface(("default", "b"))
    dp.builder.add_route("10.1.1.2/32", a, disp.LOCAL)
    dp.builder.add_route("10.1.1.3/32", b, disp.LOCAL)
    dp.builder.add_route("0.0.0.0/0", uplink, disp.REMOTE, node_id=1)
    slot = dp.alloc_table_slot("t")
    dp.builder.set_local_table(slot, [
        rule.ContivRule(action=rule.Action.PERMIT,
                        protocol=rule.Protocol.UDP, dest_port=53),
        rule.ContivRule(action=rule.Action.DENY)])
    dp.assign_pod_table(("default", "a"), "t")
    dp.builder.set_nat_mapping(0, ext_ip=ip4(VIP), ext_port=80, proto=6,
                               backends=[(ip4("10.1.1.3"), 8080, 1)],
                               boff=0)
    dp.swap()
    return a


def _traffic(seed: int, rx: int) -> np.ndarray:
    """That test's four kinds of packets from pod a, sports seeded."""
    rng = np.random.default_rng(seed)
    kinds = [("10.1.1.3", 17, 53), ("10.1.1.3", 6, 80), (VIP, 6, 80),
             ("8.8.8.8", 17, 53)]
    specs = []
    for i in range(VEC):
        d, proto, dport = kinds[i % 4]
        specs.append({"src": "10.1.1.2", "dst": d, "proto": proto,
                      "sport": int(rng.integers(1024, 65535)),
                      "dport": dport, "rx_if": rx})
    pv = jvector.make_packet_vector(specs)
    flat = jdp.packed_input_zeros(VEC)
    jdp.pack_packet_columns(flat.view(np.uint32), {
        f: np.asarray(getattr(pv, f)) for f in jvector.PacketVector._fields},
        VEC)
    return flat


def _replies(flat: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The replies of the forwarded packets of a packed batch ``flat``
    and its result ``out``: endpoints and ports swapped, received on the
    egress interface; the other slots invalid."""
    dec = jdp.unpack_packet_result(np.array(out))
    fwd = dec["disp"] != int(jvector.Disposition.DROP)
    n = out.shape[1]
    cols = dict(src_ip=dec["dst_ip"], dst_ip=dec["src_ip"],
                proto=jdp.unpack_packet_input(flat)["proto"],
                sport=dec["dport"], dport=dec["sport"],
                ttl=np.full(n, 64, np.int32),
                pkt_len=np.full(n, 64, np.int32),
                rx_if=np.where(fwd, dec["tx_if"], 0).astype(np.int32),
                flags=fwd.astype(np.int32))
    flat = jdp.packed_input_zeros(n)
    jdp.pack_packet_columns(flat.view(np.uint32), cols, n)
    return flat


class Pair:
    """The staging on one Dataplane per package (the reference's
    default config, fast path on unless ``fastpath=False``)."""

    def __init__(self, fastpath: bool = True, graphs: bool = True):
        self.j = jdp.Dataplane(jtables.DataplaneConfig(fastpath=fastpath))
        self.t = tdp.Dataplane(ttables.DataplaneConfig(fastpath=fastpath),
                               device="cpu", graphs=graphs)
        self.rx = _stage(self.j, jrule, jvector.Disposition, jvector.ip4)
        assert self.rx == _stage(self.t, trule, tvector.Disposition,
                                 tvector.ip4)
        assert self.t._use_fastpath == self.j._use_fastpath == fastpath

    def state_equal(self):
        for f in _STATE:
            assert_same(getattr(self.j.tables, f), getattr(self.t.tables, f),
                        f)


def _equal(j, t, what):
    assert tuple(t.shape) == tuple(np.asarray(j).shape), what
    assert_same(j, t, what)


@pytest.mark.parametrize("graphs", [True, False])
def test_process_packed_matches_reference(graphs):
    pair = Pair(graphs=graphs)
    flat = _traffic(7, pair.rx)
    jo, ja = pair.j.process_packed(flat, now=1000, with_aux=True)
    to, ta = pair.t.process_packed(flat, now=1000, with_aux=True)
    _equal(jo, to, "out")
    _equal(ja, ta, "aux")
    assert int(ta[0]) == 0 and int(ta[1]) == VEC  # full chain, all rx
    pair.state_equal()
    # the replies: all established, the fast tier's aux rows
    rep = _replies(flat, np.asarray(jo))
    jo2, ja2 = pair.j.process_packed(rep, now=1001, with_aux=True)
    to2, ta2 = pair.t.process_packed(rep, now=1001, with_aux=True)
    _equal(jo2, to2, "reply out")
    _equal(ja2, ta2, "reply aux")
    assert int(ta2[0]) == 1 and int(ta2[2]) == int(ta2[1]) > 0
    pair.state_equal()
    # without aux, the same out; commit=False keeps nothing
    live = {f: getattr(pair.t.tables, f).clone() for f in _STATE}
    jo3 = pair.j.process_packed(_traffic(8, pair.rx), now=1002,
                                commit=False)
    to3 = pair.t.process_packed(_traffic(8, pair.rx), now=1002,
                                commit=False)
    _equal(jo3, to3, "probe out")
    for f in _STATE:
        assert torch.equal(getattr(pair.t.tables, f), live[f]), f
    pair.state_equal()


@pytest.mark.parametrize("fastpath", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_process_packed_chain_matches_reference(k, fastpath):
    pair = Pair(fastpath=fastpath)
    first = _traffic(11, pair.rx)
    jo = pair.j.process_packed(first, now=50)
    pair.t.process_packed(first, now=50)
    # fresh flows, then the replies of the first batch (established)
    flats = np.stack([_traffic(12 + i, pair.rx) for i in range(k - 1)]
                     + [_replies(first, np.asarray(jo))])
    jouts, jauxs = pair.j.process_packed_chain(flats, now=60, with_aux=True)
    touts, tauxs = pair.t.process_packed_chain(flats, now=60, with_aux=True)
    _equal(jouts, touts, "outs")
    _equal(jauxs, tauxs, "auxs")
    assert int(tauxs[-1, 0]) == int(fastpath)
    pair.state_equal()
    assert pair.t._steps_since_expire == pair.j._steps_since_expire


def test_step_with_a_tensor_clock_matches_reference():
    """``make_pipeline_step``'s step called with ``now`` as a 0-d int32
    tensor (as every entry now passes it) equals the reference's."""
    pair = Pair(fastpath=False)
    flat = _traffic(5, pair.rx)
    cols = jdp.unpack_packet_input(flat)
    t = pair.t
    step = tgraph.make_pipeline_step(
        t.classifier_impl, t._skip_local, False, t._sweep_stride,
        fib_impl=t.fib_impl, sess_impl=t.session_impl)
    for now in (7, 9):
        jr = pair.j.process(jvector.PacketVector(
            **{f: np.asarray(v) for f, v in cols.items()}), now=now)
        tr = step(t.tables, tvector.packet_vector_from_numpy(cols, "cpu"),
                  torch.tensor(now, dtype=torch.int32))
        _assert_results(jr, tr)
