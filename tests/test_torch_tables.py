"""Table staging parity: vpp_tpu_torch's TableBuilder vs vpp_tpu's.

The same staging (interfaces, local + global rules, ~50 routes, NAT
mappings, SNAT address) goes through both packages' builders, and
``host_arrays()`` must agree field by field — same keys, same dtypes,
same values. ``tables_from_numpy``/``tables_to_numpy`` must round-trip
every field of a JAX ``DataplaneTables``. Every quantity is an
integer (or an exactly copied float placeholder), so the tolerance is
exact equality.

Also home of the small parity helpers the other ``test_torch_*``
files import (packet vectors built once from NumPy and handed to both
packages, and bit-exact comparisons of JAX arrays with torch tensors).
"""

import ipaddress

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir.rule import Action as JAction
from vpp_tpu.ir.rule import ContivRule as JRule
from vpp_tpu.ir.rule import Protocol as JProto
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.interop import tables_from_numpy, tables_to_numpy
from vpp_tpu_torch.ir.rule import Action, ContivRule, Protocol
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector
from vpp_tpu_torch.pipeline.vector import PacketVector

CPU = torch.device("cpu")
PV_FIELDS = tuple(jvector.PacketVector._fields)


# --- parity helpers (imported by the other test_torch_* files) -------


def np_bits(a) -> np.ndarray:
    """A JAX/NumPy array as NumPy, uint32 viewed as int32 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def assert_same(ref, got, what=""):
    """Bit-exact equality of a JAX array and a torch tensor."""
    r = np_bits(ref)
    g = got.detach().cpu().numpy()
    if r.dtype == np.bool_ or g.dtype == np.bool_:
        r, g = r.astype(bool), g.astype(bool)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    np.testing.assert_array_equal(g, r, err_msg=what)


def packet_pair(cols: dict):
    """One packet vector for each package from the same NumPy columns
    (``PacketVector`` field names; src_ip/dst_ip uint32)."""
    jpv = jvector.PacketVector(**{
        f: jnp.asarray(np.asarray(cols[f],
                                  np.uint32 if f in ("src_ip", "dst_ip")
                                  else np.int32))
        for f in PV_FIELDS})
    tpv = tvector.packet_vector_from_numpy(
        {f: np.asarray(cols[f]) for f in PV_FIELDS}, CPU)
    return jpv, tpv


def torch_packets(jpv) -> PacketVector:
    """The port's packet vector of a JAX one."""
    return tvector.packet_vector_from_numpy(
        {f: np.asarray(getattr(jpv, f)) for f in PV_FIELDS}, CPU)


def torch_tables(jt, device=CPU):
    """The port's tables of a JAX ``DataplaneTables`` (every field)."""
    return tables_from_numpy({f: np.asarray(getattr(jt, f))
                              for f in jt._fields}, device)


def assert_tables_equal(jt, tt, fields):
    for f in fields:
        assert_same(getattr(jt, f), getattr(tt, f), f)


# --- the staging under test -------------------------------------------


def _cfg(mod):
    return mod.DataplaneConfig(
        max_tables=4, max_rules=16, max_global_rules=64, max_ifaces=16,
        fib_slots=64, sess_slots=256, nat_mappings=4, nat_backends=16,
        classifier="bv", fib_impl="lpm", fastpath=False)


def _rules(rule_cls, action, proto, rng, n):
    out = []
    for _ in range(n):
        plen = int(rng.integers(0, 33))
        net = ipaddress.ip_network(
            (int(rng.integers(0, 2 ** 32)) & ((0xFFFFFFFF << (32 - plen))
                                              & 0xFFFFFFFF), plen))
        out.append(rule_cls(
            action=action.PERMIT if rng.random() < 0.5 else action.DENY,
            src_network=net if rng.random() < 0.5 else None,
            dest_network=None if rng.random() < 0.5 else net,
            protocol=[proto.ANY, proto.TCP, proto.UDP][
                int(rng.integers(0, 3))],
            dest_port=int(rng.choice([0, 80, 443, 40000])),
        ))
    return out


def _stage(b, rule_cls, action, proto, seed=7):
    """Identical staging on either package's builder."""
    rng = np.random.default_rng(seed)
    b.set_interface(1, 2, apply_global=True)
    for i in range(2, 8):
        b.set_interface(i, 1, local_table=(i % 3) - 1)
    b.set_interface(9, 3)
    for slot in range(3):
        b.set_local_table(slot, _rules(rule_cls, action, proto, rng, 5 + slot))
    b.set_global_table(_rules(rule_cls, action, proto, rng, 40))
    for i in range(50):
        plen = int(rng.choice([0, 8, 16, 20, 24, 28, 32]))
        addr = int(rng.integers(0, 2 ** 32)) & ((0xFFFFFFFF << (32 - plen))
                                                & 0xFFFFFFFF)
        b.add_route(f"{ipaddress.ip_address(addr)}/{plen}",
                    int(rng.integers(0, 16)), int(rng.integers(0, 4)),
                    next_hop=int(rng.integers(0, 2 ** 32)),
                    node_id=int(rng.integers(-1, 3)),
                    snat=bool(rng.random() < 0.2))
    b.del_route("0.0.0.0/0")
    b.set_nat_mapping(0, 0xC0A80001, 80, 6,
                      [(0x0A010101, 8080, 1), (0xF0000001, 8081, 3)], 0)
    b.set_nat_mapping(2, 0xC0A80002, 0, 17, [(0x0A010102, 0, 1)], 4,
                      self_snat=True)
    b.set_snat_ip(0xC0A80064)
    return b


def _builders():
    jb = jtables.TableBuilder(_cfg(jtables))
    _stage(jb, JRule, JAction, JProto)
    tb = _stage(ttables.TableBuilder(_cfg(ttables), device="cpu"),
                ContivRule, Action, Protocol)
    return jb, tb


def test_host_arrays_match_reference_field_by_field():
    jb, tb = _builders()
    ja, ta = jb.host_arrays(), tb.host_arrays()
    assert set(ja) == set(ta)
    for f in ja:
        j, t = np.asarray(ja[f]), np.asarray(ta[f])
        assert j.dtype == t.dtype, (f, j.dtype, t.dtype)
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert jb.bv_ok() == tb.bv_ok() and jb.lpm_ok() == tb.lpm_ok()
    assert jb.fib_route_count() == tb.fib_route_count()


def test_to_device_matches_reference_tables():
    jb, tb = _builders()
    jt, tt = jb.to_device(), tb.to_device()
    assert set(jt._fields) == set(ttables.HOST_FIELDS) | set(
        ttables.STATE_FIELDS)
    assert_tables_equal(jt, tt, jt._fields)


def test_interop_round_trips_every_field():
    jb, _ = _builders()
    jt = jb.to_device()
    rng = np.random.default_rng(3)
    # live-looking session / NAT state, high bits set
    live = {}
    for f, dt in jtables.SESSION_FIELDS.items():
        shape = np.shape(getattr(jt, f))
        live[f] = (rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
                   .astype(np.uint32).astype(dt))
    jt = jt._replace(**{f: jnp.asarray(v) for f, v in live.items()})
    arrays = {f: np.asarray(getattr(jt, f)) for f in jt._fields}
    tt = tables_from_numpy(arrays, CPU)
    back = tables_to_numpy(tt)
    assert set(back) == set(arrays)
    for f, a in arrays.items():
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    # the derived LPM stack equals the builder's own
    tt2 = _builders()[1].to_device()
    for f in ttables.DERIVED_FIELDS:
        assert torch.equal(getattr(tt, f), getattr(tt2, f)), f


def test_interop_zero_fills_state_from_config():
    jb, _ = _builders()
    host = jb.host_arrays()
    with pytest.raises(KeyError):
        tables_from_numpy(host, CPU)
    tt = tables_from_numpy(host, CPU, config=_cfg(ttables))
    assert tt.sess_valid.shape == (64, 4)
    assert int(tt.sess_valid.sum()) == 0


def test_swap_carries_session_state_by_reference():
    _, tb = _builders()
    t1 = tb.to_device()
    t1.sess_valid[3, 1] = 1
    tb.add_route("10.9.9.0/24", 2, 1)
    t2 = tb.to_device(sessions=t1)
    assert t2.sess_valid is t1.sess_valid
    assert int(t2.sess_valid[3, 1]) == 1
    assert t2.fib_prefix is not t1.fib_prefix


@pytest.mark.parametrize("knob,value", [
    ("ml_stage", "score"), ("telemetry", "latency"), ("tenancy", "on"),
    ("overlay", "vxlan"), ("svc_vips", 4), ("fib_ecmp_groups", 2)])
def test_unported_stages_refused_with_roadmap_item(knob, value):
    """Every stage knob is ported now: with each on, the builder stages
    the reference's arrays (the ML planes at the configured capacity,
    the tenant, service and ECMP planes at theirs) and state shapes (the
    telemetry, tenancy and ECMP planes)."""
    cfg = _cfg(ttables)._replace(**{knob: value})
    tb = ttables.TableBuilder(cfg, device="cpu")
    jb = jtables.TableBuilder(_cfg(jtables)._replace(**{knob: value}))
    ja, ta = jb.host_arrays(), tb.host_arrays()
    for f in ja:
        assert_same(ja[f], torch.from_numpy(np.array(
            np.asarray(ta[f]).view(np.int32)
            if np.asarray(ta[f]).dtype == np.uint32 else ta[f])), f)
    jt, tt = jb.to_device(), tb.to_device()
    for f in (tuple(ttables.TELEMETRY_FIELDS)
              + tuple(ttables.TENANCY_STATE_FIELDS) + ("fib_ecmp_c",)):
        assert tuple(getattr(tt, f).shape) == getattr(jt, f).shape, f


@pytest.mark.parametrize("kw,match", [
    (dict(sess_slots=3000), "sess_slots"), (dict(sess_ways=3), "sess_ways"),
    (dict(sess_sweep_stride=3), "sess_sweep_stride"),
    (dict(fib_impl="trie"), "fib_impl"),
    (dict(session_impl="x"), "session_impl")])
def test_bad_knobs_rejected_like_reference(kw, match):
    for mod in (jtables, ttables):
        with pytest.raises(ValueError, match=match):
            mod.validate_dataplane_config(_cfg(mod)._replace(**kw))
