"""FIB parity: vpp_tpu_torch/ops/fib.py + ops/lpm.py vs vpp_tpu's.

The plain version of the ``lpm_fused_lookup`` kernel against the Pallas
kernel in interpret mode (the same biased, stacked planes fed to both),
and the ``dense``, ``lpm`` and ``pallas`` FIB rungs against the JAX
rungs and the independent NumPy oracle of tests/test_lpm.py, over
seeded random tables (ECMP groups included, staged through the
reference builder and carried over with ``tables_from_numpy``) and the
edge tables: empty planes, /0 only, /32 host routes and a duplicate
prefix. A NumPy model of the CUDA kernel's search (populated lengths,
the shared-memory fits rule, the 8-ary search) is held against the
plain version on both sides of the fits rule. The ``pallas`` rung runs on CPU tensors, so the wrapper takes
its plain version; the launch counter proves it. Every quantity is an
integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ops import fib as jfib
from vpp_tpu.ops import lpm as jlpm
from vpp_tpu.pipeline.tables import TableBuilder
from vpp_tpu.pipeline.vector import Disposition
from vpp_tpu_torch.ops import fib as tfib
from vpp_tpu_torch.ops import lpm as tlpm

from test_lpm import NumpyLpmOracle, _cfg, _probe_traffic, _random_table
from test_torch_tables import assert_same, torch_packets, torch_tables

_RUNGS = {"dense": (jfib.fib_lookup_dense, tfib.fib_lookup_dense),
          "lpm": (jlpm.fib_lookup_lpm, tlpm.fib_lookup_lpm),
          "pallas": (jlpm.fib_lookup_lpm_fused, tlpm.fib_lookup_lpm_fused)}


def _assert_fib(jres, tres, what=""):
    for f in jres._fields:
        assert_same(getattr(jres, f), getattr(tres, f), f"{what} {f}")


def _assert_oracle(tres, oracle):
    for f in ("matched", "tx_if", "disp", "node_id", "snat", "grp"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(), oracle[f],
                                      err_msg=f)
    np.testing.assert_array_equal(
        tres.next_hop.numpy().view(np.uint32).astype(np.int64),
        oracle["next_hop"].astype(np.int64))


def _kernel_pair(tt, jp):
    """(JAX interpret kernel, port plain version) on the port's stack."""
    lens = tt.fib_lpm_lens.numpy()
    masks = jnp.asarray([jlpm.LPM_MASKS[L] for L in lens], jnp.uint32)
    m_cols = jlpm._lpm_bias(jp.dst_ip[:, None] & masks[None, :])
    jf, js = jlpm.lpm_fused_lookup(
        m_cols, jnp.asarray(tt.fib_lpm_stk_cnt.numpy())[:, None],
        jnp.asarray(tt.fib_lpm_stk_pfx.numpy()),
        jnp.asarray(tt.fib_lpm_stk_slot.numpy()), interpret=True)
    tf, ts = tlpm.lpm_fused_lookup(torch_packets(jp).dst_ip,
                                   tt.fib_lpm_lens, tt.fib_lpm_stk_cnt,
                                   tt.fib_lpm_stk_pfx, tt.fib_lpm_stk_slot)
    return (jf, js), (tf, ts)


@pytest.mark.parametrize("seed,n_routes,fib_slots",
                         [(3, 40, 64), (7, 200, 256)])
def test_lpm_plain_matches_interpret_kernel(seed, n_routes, fib_slots):
    b = _random_table(seed, n_routes, fib_slots)
    tt = torch_tables(b.to_device())
    jp = _probe_traffic(b, np.random.default_rng(seed + 2), 257)
    (jf, js), (tf, ts) = _kernel_pair(tt, jp)
    assert bool(tf.any())
    assert_same(jf, tf, "found")
    assert_same(js, ts, "slot")
    assert tlpm.lpm_fused_lookup.launches == 0


@pytest.mark.parametrize("rung", ["dense", "lpm", "pallas"])
@pytest.mark.parametrize("seed,n_routes,fib_slots,groups",
                         [(3, 40, 64, 0), (7, 200, 256, 4)])
def test_fib_rungs_match_reference_and_oracle(rung, seed, n_routes,
                                              fib_slots, groups):
    b = _random_table(seed, n_routes, fib_slots, ecmp_groups=groups)
    jt = b.to_device()
    tt = torch_tables(jt)
    jp = _probe_traffic(b, np.random.default_rng(seed + 2), 200)
    tp = torch_packets(jp)
    jfn, tfn = _RUNGS[rung]
    tres = tfn(tt, tp)
    _assert_fib(jfn(jt, jp), tres, rung)
    _assert_oracle(tres, NumpyLpmOracle(b).lookup(jp))
    assert tlpm.lpm_fused_lookup.launches == 0


def _edge_builders():
    empty = TableBuilder(_cfg(fib_slots=16, fib_impl="lpm"))
    empty.add_route("10.0.0.0/8", 1, Disposition.REMOTE, slot=0)
    empty_probe = empty
    default = TableBuilder(_cfg(fib_slots=16, fib_impl="lpm"))
    default.add_route("0.0.0.0/0", 1, Disposition.REMOTE, next_hop=9)
    hosts = TableBuilder(_cfg(fib_slots=16, fib_impl="lpm"))
    hosts.add_route("10.1.1.7/32", 2, Disposition.LOCAL, slot=3)
    hosts.add_route("10.1.1.8/32", 3, Disposition.LOCAL, slot=1)
    hosts.add_route("10.1.1.0/24", 4, Disposition.REMOTE, slot=0)
    hosts.add_route("10.1.1.0/24", 5, Disposition.HOST, slot=6)  # dup
    hosts.add_route("255.255.255.255/32", 6, Disposition.HOST, slot=9)
    return [("empty", empty, empty_probe), ("default", default, default),
            ("hosts", hosts, hosts)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_lpm_edge_tables(case):
    """Empty planes (all miss), /0 only (all hit), /32 host routes, the
    all-ones address and a duplicate prefix (lowest slot wins): every
    rung, the interpret kernel and the oracle agree."""
    name, b, probe_b = _edge_builders()[case]
    rng = np.random.default_rng(21 + case)
    jp = _probe_traffic(probe_b, rng, 65)
    if name == "empty":
        b.del_route("10.0.0.0/8")
    jt = b.to_device()
    tt = torch_tables(jt)
    tp = torch_packets(jp)
    oracle = NumpyLpmOracle(b).lookup(jp)
    for rung, (jfn, tfn) in _RUNGS.items():
        tres = tfn(tt, tp)
        _assert_fib(jfn(jt, jp), tres, f"{name} {rung}")
        _assert_oracle(tres, oracle)
    (jf, js), (tf, ts) = _kernel_pair(tt, jp)
    assert_same(jf, tf, "found")
    assert_same(js, ts, "slot")


def _find8(row, n, m):
    """csrc/lpm_lookup.cu ``find``: 8-ary lower bound, then the hit."""
    lo, hi = 0, n
    while hi - lo > 8:
        span = hi - lo
        below = sum(int(row[lo + span * j // 8] < m) for j in range(1, 8))
        new_lo = lo + span * below // 8 + 1 if below else lo
        hi = lo + span * (below + 1) // 8 if below < 7 else hi
        lo = new_lo
    at = lo + sum(1 for j in range(8) if lo + j < hi and row[lo + j] < m)
    return at if at < n and row[at] == m else -1


def _kernel_model(dst, lens, cnt, pfx, slot, budget):
    """NumPy model of csrc/lpm_lookup.cu: the populated lengths, their
    4-rounded live regions packed by a prefix sum, the on-device fits
    rule, and the longest-first walk with the 8-ary search. Returns
    (found, slot, fits)."""
    pop = [k for k in range(len(lens)) if cnt[k] > 0]
    fits = pfx.shape[1] % 4 == 0 and sum(
        (int(cnt[k]) + 3) // 4 * 4 for k in pop) <= budget
    found = np.zeros(len(dst), bool)
    out = np.zeros(len(dst), np.int32)
    for i, d in enumerate(dst.astype(np.int64) & 0xFFFFFFFF):
        for k in pop:
            mask = (0xFFFFFFFF << (32 - int(lens[k]))) & 0xFFFFFFFF \
                if lens[k] else 0
            u = (int(d) & mask) ^ 0x80000000  # the int32 bits of m
            m = u - (1 << 32) if u >> 31 else u
            at = _find8(pfx[k].astype(np.int64), int(cnt[k]), m)
            if at >= 0:
                found[i], out[i] = True, slot[k, at]
                break
    return found, out, fits


@pytest.mark.parametrize("seed,n_routes,fib_slots,budget", [
    (3, 40, 64, 16384), (7, 200, 256, 16384), (7, 200, 256, 8)])
def test_kernel_search_model_matches_plain(seed, n_routes, fib_slots,
                                           budget):
    """The kernel's search, modelled in NumPy, equals the plain version
    on staged tables, whether the live set fits the shared-memory budget
    or not (a budget of 8 entries forces the device-memory walk)."""
    b = _random_table(seed, n_routes, fib_slots)
    tt = torch_tables(b.to_device())
    jp = _probe_traffic(b, np.random.default_rng(seed + 2), 257)
    dst = torch_packets(jp).dst_ip
    stack = (tt.fib_lpm_lens, tt.fib_lpm_stk_cnt, tt.fib_lpm_stk_pfx,
             tt.fib_lpm_stk_slot)
    found, slot, fits = _kernel_model(dst.numpy(),
                                      *(t.numpy() for t in stack), budget)
    assert fits == (budget > 8)
    want = tlpm.lpm_fused_lookup_plain(dst, *stack)
    assert found.any()
    np.testing.assert_array_equal(found, want[0].numpy())
    np.testing.assert_array_equal(slot, want[1].numpy())


def test_lpm_disabled_stack_is_empty_and_misses():
    """A dense-only FIB allocates no LPM plane: the derived stack has
    no lengths and the fused lookup misses every packet."""
    b = TableBuilder(_cfg(fib_slots=16, fib_impl="dense",
                          fib_lpm_plen_caps=()))
    b.add_route("10.0.0.0/8", 1, Disposition.REMOTE)
    tt = torch_tables(b.to_device())
    assert tt.fib_lpm_lens.shape == (0,)
    found, slot = tlpm.lpm_fused_lookup(
        torch.tensor([1, 2, -1], dtype=torch.int32), tt.fib_lpm_lens,
        tt.fib_lpm_stk_cnt, tt.fib_lpm_stk_pfx, tt.fib_lpm_stk_slot)
    assert not bool(found.any()) and int(slot.abs().sum()) == 0


def test_host_layout_helpers_match_reference():
    from vpp_tpu.ops import lpm as ref

    for cfg in (_cfg(fib_slots=64), _cfg(fib_slots=1 << 14, fib_impl="lpm",
                                         fib_lpm_plen_caps=()),
                _cfg(fib_slots=16, fib_impl="dense")):
        assert tlpm.lpm_len_caps(cfg) == ref.lpm_len_caps(cfg)
        assert tlpm.lpm_enabled_for(cfg) == ref.lpm_enabled_for(cfg)
        assert tlpm.populated_lengths(cfg) == ref.populated_lengths(cfg)
        assert tlpm.ecmp_capacity(cfg) == ref.ecmp_capacity(cfg)
        caps = tlpm.lpm_len_caps(cfg)
        assert tlpm.lpm_hint_layout(caps) == ref.lpm_hint_layout(caps)
