"""The step program cache (pipeline/capture.py) and capture safety.

* Capture safety, on the CPU: the op stream of a step — op names,
  non-tensor arguments, the shapes and dtypes of tensor arguments,
  recorded under a ``TorchDispatchMode`` — is the same for two clocks
  and two seeded traffic batches on the pallas-rung and MXU-rung full
  chains and on the fast tier, and holds no host read
  (``_local_scalar_dense``, ``item``, ``nonzero``, ``is_nonzero``): a
  CUDA graph of it bakes in nothing of the data or the clock. The auto
  path's prefix plus its flag read holds exactly one.
* The cache and its buffers: ten ``process`` calls build one program
  per key; a swap that changes no shape and an ``expire_sessions`` keep
  every live table tensor (same ``data_ptr``) and build nothing; a swap
  that changes the classifier builds a new key; the result of step N is
  unchanged by step N+1; ``capture_budget`` raises on a second build of
  a key. The programs' results equal the eager steps' (``graphs=False``)
  through ``process``, ``process_packed`` and ``process_packed_chain``,
  across a swap and an expiry, on both tiers.

Every quantity is an integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from test_torch_fastpath import N, VIP, _CFG, _mixed, _stage
from test_torch_pipeline import _STATE, _KernelRungs
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.pipeline import capture
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
              "aten.is_nonzero")
RUNGS = {
    "pallas": dict(classifier="pallas", fib_impl="pallas",
                   session_impl="pallas"),
    "mxu": dict(classifier="mxu", fib_impl="lpm", session_impl="gather"),
}


class _Ops(TorchDispatchMode):
    """Records (op, argument signature) of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, _ = tree_flatten((args, kwargs))
        self.ops.append((str(func), tuple(
            (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
            else repr(a) for a in leaves)))
        return func(*args, **kwargs)


def _record(fn):
    with _Ops() as rec:
        fn()
    return rec.ops


def _host_reads(ops):
    return [name for name, _ in ops if name.startswith(HOST_READS)]


def _dataplane(rungs: str, fastpath: bool, graphs: bool = True):
    cfg = ttables.DataplaneConfig(**dict(_CFG, **RUNGS[rungs],
                                         fastpath=fastpath))
    dp = _KernelRungs(cfg, device="cpu", graphs=graphs)
    up, pod = _stage(dp, trule, tvector.Disposition)
    return dp, up, pod


def _batch(seed: int, up: int, pod: int):
    """Seeded traffic: fresh flows from the uplink (permitted, denied,
    to the VIP) and from the pod."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(N - 2):
        own = rng.random() < 0.3
        specs.append(dict(
            src=f"10.1.1.{rng.integers(2, 30)}" if own
            else f"172.16.{rng.integers(0, 4)}.{rng.integers(1, 250)}",
            dst=("8.8.8.8" if own else VIP if rng.random() < 0.2
                 else f"10.1.1.{rng.integers(2, 30)}"),
            proto=int(rng.choice([6, 17, 1])),
            sport=int(rng.integers(1024, 65535)),
            dport=int(rng.choice([80, 8080, 9999])),
            rx_if=pod if own else up))
    return tvector.make_packet_vector(specs, n=N)


def _replies(res):
    fwd = np.nonzero(res.disp.numpy() != int(tvector.Disposition.DROP))[0]
    pk = {f: getattr(res.pkts, f).numpy() for f in res.pkts._fields}
    return tvector.make_packet_vector(
        [dict(src=int(pk["dst_ip"][i]) & 0xFFFFFFFF,
              dst=int(pk["src_ip"][i]) & 0xFFFFFFFF,
              proto=int(pk["proto"][i]), sport=int(pk["dport"][i]),
              dport=int(pk["sport"][i]), rx_if=int(res.tx_if[i]))
         for i in fwd], n=N)


def _now(v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("tier", ["pallas", "mxu", "fast"])
def test_op_stream_bakes_in_no_data_and_no_clock(tier):
    dp, up, pod = _dataplane("mxu" if tier == "fast" else tier,
                             fastpath=tier == "fast")
    first = dp.process(_batch(1, up, pod), now=5)
    batches = (_batch(2, up, pod), _replies(first))
    streams = []
    for pkts in batches:
        for now in (6, 4000):
            scratch = dp._scratch()
            if tier == "fast":
                step = dp._get_step(True)
                pre = step.prefix(scratch, pkts, _now(now))
                streams.append(_record(
                    lambda: step.fast(scratch, pre, _now(now))))
            else:
                step = dp._get_step(False)
                streams.append(_record(
                    lambda: step(scratch, pkts, _now(now))))
    assert len(streams[0]) > 100
    for s in streams[1:]:
        assert s == streams[0]
    assert _host_reads(streams[0]) == []


def test_auto_prefix_and_flag_read_hold_exactly_one_host_read():
    dp, up, pod = _dataplane("mxu", fastpath=True)
    first = dp.process(_batch(1, up, pod), now=5)
    step = dp._get_step(True)
    for pkts in (_batch(3, up, pod), _replies(first)):
        ops = _record(lambda: bool(step.prefix(dp._scratch(), pkts,
                                                 _now(6)).ok))
        assert len(_host_reads(ops)) == 1, _host_reads(ops)


def _labels():
    return capture.capture_totals()


def test_one_program_per_key_and_results_outlive_the_next_step():
    for fastpath in (False, True):
        dp, up, pod = _dataplane("mxu", fastpath=fastpath)
        with capture.capture_budget(3) as budget:
            results, snaps = [], []
            first = dp.process(_batch(1, up, pod), now=5)
            for k in range(10):
                pkts = _replies(first) if k % 2 else _batch(10 + k, up, pod)
                res = dp.process(pkts, now=6 + k)
                results.append(res)
                snaps.append({f: getattr(res, f).clone()
                              for f in ("disp", "tx_if", "established")})
                snaps[-1]["stats"] = [s.clone() for s in res.stats]
        assert len(dp.programs()) == 1
        prog = dp.programs()[0]
        assert budget.spent == len(prog.parts()) == (3 if fastpath else 1)
        assert [int(r.stats.fastpath) for r in results] == [
            int(fastpath and k % 2 == 1) for k in range(10)]
        # step N's result is unchanged by the steps after it
        for res, snap in zip(results, snaps):
            for f in ("disp", "tx_if", "established"):
                assert torch.equal(getattr(res, f), snap[f])
            assert all(torch.equal(a, b)
                       for a, b in zip(res.stats, snap["stats"]))
            assert res.tables is dp.tables


def test_swap_and_expire_write_the_held_tensors():
    dp, up, pod = _dataplane("pallas", fastpath=False)
    pkts = _batch(1, up, pod)
    dp.process(pkts, now=5)
    ptrs = [t.data_ptr() for t in dp.tables]
    rules = trule
    with capture.capture_budget(0):
        # a new rule set of the same capacity: no shape changes
        dp.builder.set_global_table([
            rules.ContivRule(action=rules.Action.PERMIT,
                             protocol=rules.Protocol.TCP, dest_port=9999),
            rules.ContivRule(action=rules.Action.DENY)])
        dp.swap()
        assert [t.data_ptr() for t in dp.tables] == ptrs
        res = dp.process(pkts, now=6)
        dp.advance_clock(1000.0)
        assert dp.expire_sessions(max_age=0) > 0
        assert [t.data_ptr() for t in dp.tables] == ptrs
        res = dp.process(_replies(res), now=dp._now)
    assert int(dp.tables.sess_valid.sum()) == int(res.stats.sess_occupancy)
    # a swap that changes the classifier builds a new key
    dp.classifier = "mxu"
    dp.swap()
    assert dp.classifier_impl == "mxu"
    with capture.capture_budget(1) as budget:
        dp.process(pkts, now=dp._now + 1)
        dp.process(pkts, now=dp._now + 2)
    assert budget.spent == 1 and len(dp.programs()) == 2


def test_budget_raises_on_a_second_build_of_a_key():
    dp, up, pod = _dataplane("mxu", fastpath=False)
    pkts = _batch(1, up, pod)
    with pytest.raises(capture.CaptureBudgetExceeded, match="budget 0"):
        with capture.capture_budget(0):
            dp.process(pkts, now=5)
    dp._programs.clear()
    with pytest.raises(capture.CaptureBudgetExceeded,
                       match="captured again"):
        with capture.capture_budget(5):
            dp.process(pkts, now=6)


def test_packing_round_trips_views():
    rng = np.random.default_rng(0)
    tensors = [torch.from_numpy(rng.integers(-9, 9, (7,)).astype(np.int32)),
               torch.tensor(True), torch.tensor(-3, dtype=torch.int32),
               torch.from_numpy(rng.random((3, 5)) < 0.5),
               torch.from_numpy(rng.integers(0, 9, (2, 4)).astype(np.int32))]
    packing = capture.Packing(tensors)
    buf = packing.pack(tensors)
    assert buf.dtype == torch.uint8 and buf.numel() == 4 * 16 + 16
    back = packing.unpack(buf.clone())
    for a, b in zip(tensors, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError):
        capture.Packing([torch.zeros(3, dtype=torch.int64)])


def _same(a, b, what):
    assert a.shape == b.shape and torch.equal(a, b), what


@pytest.mark.parametrize("fastpath", [False, True])
def test_programs_equal_eager_steps(fastpath):
    """The same traffic through a program dataplane and an eager one:
    ``process`` (forward vectors and replies), ``process_packed``,
    ``process_packed_chain`` (K = 3), with a same-shape swap and an
    expiry in the middle: every result, aux row and the state equal."""
    dps = [_dataplane("pallas", fastpath, graphs=g) for g in (True, False)]
    (pg, up, pod), (pe, _, _) = dps
    now = 5

    def both(fn):
        return [fn(dp) for dp in (pg, pe)]

    for rnd in range(2):
        fwd = _batch(20 + rnd, up, pod)
        rg, re = both(lambda dp: dp.process(fwd, now=now))
        for name in ("disp", "tx_if", "node_id", "next_hop", "drop_cause",
                     "established", "dnat_applied", "snat_applied"):
            _same(getattr(rg, name), getattr(re, name), name)
        for f in rg.pkts._fields:
            _same(getattr(rg.pkts, f), getattr(re.pkts, f), f)
        for a, b, f in zip(rg.stats, re.stats, rg.stats._fields):
            _same(a, b, f)
        rep = _replies(rg)
        flat = tdp.packed_input_zeros(N)
        tdp.pack_packet_columns(flat.view(np.uint32), {
            f: getattr(rep, f).numpy() for f in rep._fields}, N)
        (og, ag), (oe, ae) = both(lambda dp: dp.process_packed(
            flat, now=now + 1, with_aux=True))
        _same(og, oe, "packed out")
        _same(ag, ae, "packed aux")
        assert int(ag[0]) == int(fastpath)
        flats = np.stack([flat, flat, tdp.packed_input_zeros(N)])
        (og, ag), (oe, ae) = both(lambda dp: dp.process_packed_chain(
            flats, now=now + 2, with_aux=True))
        _same(og, oe, "chain outs")
        _same(ag, ae, "chain auxs")
        for f in _STATE:
            _same(getattr(pg.tables, f), getattr(pe.tables, f), f)
        if rnd == 0:
            for dp in (pg, pe):
                dp.builder.add_route("10.1.2.0/24", pod,
                                     tvector.Disposition.LOCAL)
                dp.swap()
                dp.advance_clock(1000.0)
            assert pg.expire_sessions(max_age=1) == \
                pe.expire_sessions(max_age=1)
        now += 10
