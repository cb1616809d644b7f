"""The config transaction journal: vpp_tpu_torch/pipeline/txn.py vs
vpp_tpu/pipeline/txn.py, and the builder's op recording.

* ``ConfigTxn.to_dict`` is equal across the packages for every op kind
  of the DSL (the set of legal ops is the builder's mutators).
* A live dataplane with ``enable_journal`` records every epoch's builder
  ops in both packages: the JSONL lines are equal but for their wall
  time, a journal written by the reference and replayed onto the port's
  builder gives the reference builder's ``host_arrays``, and the
  reverse; the replayed port dataplane's tensors equal the live one's.
* The reference's own ``tests/test_txn.py`` cases (serialization, one
  epoch per ``apply_txn``, replay, the unknown op, the ``apply_txn``
  rollback, the bounded ``load_tail_entries``) run on the port, and its
  torn trailing line case without the CLI part (the CLI comes with the
  agent).

The port runs on the CPU. Every quantity compared is an integer or a
string: the tolerance is exact equality.
"""

import ipaddress
import json

import numpy as np
import pytest
import torch

import test_txn as jtest
from test_torch_policy import run_case
from test_torch_upload import MLP
from vpp_tpu.ir import rule as jrule
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import txn as jtxn
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import txn as ttxn
from vpp_tpu_torch.pipeline import vector as tvector


class CpuDataplane(tdp.Dataplane):
    """The port's Dataplane on the CPU, constructed as the reference's."""

    def __init__(self, config=None):
        super().__init__(config, device="cpu")


def rules(r):
    """The reference test's rule list in one package's ContivRule."""
    return [
        r.ContivRule(action=r.Action.PERMIT,
                     src_network=ipaddress.ip_network("172.16.0.0/12"),
                     protocol=r.Protocol.TCP, dest_port=80),
        r.ContivRule(action=r.Action.DENY,
                     dest_network=ipaddress.ip_network("10.1.1.0/24"),
                     protocol=r.Protocol.UDP),
        r.ContivRule(action=r.Action.DENY),
    ]


def txn_names(port: bool) -> dict:
    if not port:
        return {}
    return dict(Action=trule.Action, ContivRule=trule.ContivRule,
                Protocol=trule.Protocol, Dataplane=CpuDataplane,
                DataplaneConfig=ttables.DataplaneConfig,
                InterfaceType=ttables.InterfaceType,
                ConfigTxn=ttxn.ConfigTxn, TxnJournal=ttxn.TxnJournal,
                apply_txn=ttxn.apply_txn, rule_from_dict=ttxn.rule_from_dict,
                rule_to_dict=ttxn.rule_to_dict,
                Disposition=tvector.Disposition,
                make_packet_vector=tvector.make_packet_vector,
                RULES=rules(trule))


# --- every op kind ------------------------------------------------------

VIP, BACKEND, NH = 0x0A600001, 0x0A010103, 0xC0A81E02


def op_calls(r, disp):
    """One DSL call per op kind: {op: (method name, args, kwargs)}."""
    return {
        "set_interface": ((2, 2), dict(local_table=-1, apply_global=True)),
        "set_if_local_table": ((3, 1), {}),
        "add_route": (("10.2.0.0/16", 2, disp.REMOTE),
                      dict(next_hop=NH, node_id=2, snat=True, slot=5,
                           group=1)),
        "del_route": (("10.2.0.0/16",), {}),
        "set_nh_group": ((1, [(NH, 2, 1), (NH + 1, 2, 2)]), {}),
        "del_nh_group": ((1,), {}),
        "set_local_table": ((0, rules(r)), {}),
        "clear_local_table": ((0,), {}),
        "set_global_table": ((rules(r),), {}),
        "set_nat_mapping": ((0, VIP, 80, 6, [(BACKEND, 8080, 1)], 0),
                            dict(self_snat=True)),
        "clear_nat": ((), {}),
        "set_snat_ip": ((0xC0A81001,), {}),
        "set_ml_model": ((MLP,), {}),
        "clear_ml_model": ((), {}),
        "set_tenant": ((1,), dict(prefixes=["10.1.0.0/16"], rate=100,
                                  burst=200, sess_buckets=16)),
        "clear_tenants": ((), {}),
        "set_tenant_ml": ((1, "score", 10), {}),
        "set_service": ((VIP, 80, 6, [(BACKEND, 8080, 2)]),
                        dict(self_snat=True)),
        "del_service": ((VIP, 80, 6), {}),
        "clear_services": ((), {}),
        "set_vtep_ip": ((0xC0A81002,), {}),
    }


def test_op_list_is_the_references():
    assert ttxn._OPS == jtxn._OPS
    assert ttxn._RULE_OPS == jtxn._RULE_OPS
    assert sorted(op_calls(trule, tvector.Disposition)) == sorted(jtxn._OPS)


@pytest.mark.parametrize("op", sorted(jtxn._OPS))
def test_to_dict_equal_for_every_op_kind(op):
    dicts = []
    for r, v, txn_mod in ((jrule, jvector, jtxn), (trule, tvector, ttxn)):
        args, kw = op_calls(r, v.Disposition)[op]
        txn = txn_mod.ConfigTxn(label=f"one {op}")
        getattr(txn, op)(*args, **kw)
        d = txn.to_dict()
        dicts.append(json.dumps(d, separators=(",", ":")))
        assert txn_mod.ConfigTxn.from_dict(json.loads(dicts[-1])).to_dict() \
            == json.loads(dicts[-1])
    assert dicts[0] == dicts[1]


# --- a live journal, replayed both ways ---------------------------------

_CFG = dict(max_tables=4, max_rules=16, max_global_rules=64, max_ifaces=16,
            fib_slots=64, sess_slots=256, nat_mappings=4, nat_backends=16,
            svc_vips=8, svc_backend_ways=4, fib_ecmp_groups=4,
            fib_ecmp_ways=4, tenancy="on", ml_stage="enforce", ml_hidden=8,
            ml_trees=2, ml_depth=2, fastpath=False)


def _journaled_history(port: bool, path: str):
    """A node's config history on one package's live dataplane with its
    journal on: interfaces, pod routes, a local and a global table, NAT,
    a service VIP, an ECMP group, a tenant, an ML model, then churn."""
    r, v = (trule, tvector) if port else (jrule, jvector)
    D = v.Disposition
    cfg = (ttables if port else jtables).DataplaneConfig(**_CFG)
    dp = CpuDataplane(cfg) if port else jdp.Dataplane(cfg)
    dp.enable_journal(path)
    b = dp.builder
    up = dp.add_uplink()
    pods = [dp.add_pod_interface(("default", f"p{i}")) for i in range(3)]
    for i, idx in enumerate(pods):
        b.add_route(f"10.1.1.{i + 2}/32", idx, D.LOCAL)
    b.add_route("0.0.0.0/0", up, D.REMOTE, snat=True)
    b.txn_label = "bootstrap"
    dp.swap()
    slot = dp.alloc_table_slot("t0")
    b.set_local_table(slot, rules(r))
    dp.assign_pod_table(("default", "p1"), "t0")
    b.set_global_table(rules(r) * 3)
    b.set_nat_mapping(0, VIP, 80, 6, [(BACKEND, 8080, 1),
                                      (BACKEND + 1, 8080, 2)], 0)
    b.set_snat_ip(0xC0A81001)
    b.set_service(VIP + 1, 443, 6, [(BACKEND, 8443, 1), (BACKEND + 2,
                                                          8443, 3)])
    b.set_nh_group(2, [(NH, up, 1), (NH + 1, up, 2)])
    b.add_route("10.2.0.0/16", up, D.REMOTE, next_hop=NH, node_id=1,
                group=2)
    b.set_tenant(1, prefixes=["10.1.1.0/24"], rate=100, burst=200,
                 sess_buckets=16)
    b.set_tenant_ml(1, "score", 10)
    b.set_ml_model(MLP)
    b.set_vtep_ip(0xC0A81002)
    b.txn_label = "stage"
    dp.swap()
    b.del_route("10.1.1.4/32")
    b.del_service(VIP + 1, 443, 6)
    dp.free_table_slot("t0")
    dp.del_pod_interface(("default", "p2"))
    b.set_global_table(rules(r)[1:])
    dp.swap()
    dp.swap()  # nothing staged: no entry
    return dp


def _host(builder) -> dict:
    return {k: np.array(a) for k, a in builder.host_arrays().items()}


def _assert_same_host(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        if y.dtype == np.uint32:
            y = y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_live_journals_are_the_same_text(tmp_path):
    """Both packages journal the same history as the same JSONL, line
    for line, but for each entry's wall time ``t``."""
    paths = [str(tmp_path / f"{side}.jsonl") for side in ("ref", "port")]
    dps = [_journaled_history(port, p) for port, p in zip((False, True),
                                                          paths)]
    lines = []
    for p in paths:
        with open(p) as f:
            raw = f.read().splitlines()
        lines.append([ln.split(",", 1)[1] for ln in raw])
        assert all(ln.startswith('{"t":') for ln in raw)
    assert lines[0] == lines[1]
    assert len(lines[1]) == 3
    assert [json.loads("{" + ln)["label"] for ln in lines[1]] == [
        "bootstrap", "stage", ""]
    assert dps[0].journal.applied == dps[1].journal.applied == 3
    _assert_same_host(_host(dps[0].builder), _host(dps[1].builder))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    """A journal written by one package replays onto the other's fresh
    builder to the writer's staged tables."""
    path = str(tmp_path / "j.jsonl")
    live = _journaled_history(writer == "port", path)
    if writer == "port":
        fresh = jtables.TableBuilder(jtables.DataplaneConfig(**_CFG))
        n = jtxn.TxnJournal(path).replay(fresh)
    else:
        fresh = ttables.TableBuilder(ttables.DataplaneConfig(**_CFG),
                                     device="cpu")
        n = ttxn.TxnJournal(path).replay(fresh)
    assert n == 3
    _assert_same_host(_host(fresh), _host(live.builder))


def test_replayed_dataplane_holds_the_live_tensors(tmp_path):
    """The port's journal replayed onto a fresh port dataplane and
    swapped: every table field but the state equals the live one."""
    path = str(tmp_path / "j.jsonl")
    live = _journaled_history(True, path)
    fresh = CpuDataplane(ttables.DataplaneConfig(**_CFG))
    assert ttxn.TxnJournal(path).replay(fresh.builder) == 3
    fresh.swap()
    for f in ttables.HOST_FIELDS + ttables.DERIVED_FIELDS:
        assert torch.equal(getattr(fresh.tables, f),
                           getattr(live.tables, f)), f


def test_rolled_back_staging_drops_its_recorded_ops():
    """``state_restore`` puts the recording back too: a rolled-back
    stage leaves no op for the next swap to journal (as the
    reference's)."""
    for mod in (ttables, jtables):
        kw = dict(device="cpu") if mod is ttables else {}
        b = mod.TableBuilder(mod.DataplaneConfig(**_CFG), **kw)
        b.start_recording()
        b.set_snat_ip(1)
        snap = b.state_snapshot()
        b.set_snat_ip(2)
        b.clear_nat()
        b.state_restore(snap)
        b.txn_label = "kept"
        txn = b.drain_recording()
        assert (txn.label, [o["op"] for o in txn.ops]) == (
            "kept", ["set_snat_ip"])
        assert b.drain_recording() is None and b.txn_label == ""


# --- the reference's cases on the port -----------------------------------

TXN_CASES = ("test_rule_serialization_roundtrip",
             "test_apply_txn_is_one_epoch_and_enforces",
             "test_journal_replay_reproduces_config",
             "test_unknown_op_rejected",
             "test_failed_txn_rolls_back_completely",
             "test_load_tail_entries_is_bounded_and_tolerant")


@pytest.mark.parametrize("case", TXN_CASES)
def test_reference_txn_cases_on_the_port(case, tmp_path):
    fn = getattr(jtest, case)
    args = (tmp_path,) if "tmp_path" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else ()
    run_case(jtest, case, txn_names(True), *args)


def test_torn_trailing_journal_line_tolerated(tmp_path):
    """The reference's torn-line case on the port (its CLI part belongs
    to the agent): a truncated last line is counted in ``torn_lines``
    and the intact prefix replays; corruption mid-file raises."""
    path = str(tmp_path / "torn.jsonl")
    g = txn_names(True)
    dp = CpuDataplane(ttables.DataplaneConfig())
    journal = ttxn.TxnJournal(path)
    ttxn.apply_txn(dp, run_case(jtest, "make_txn", g), journal)
    ttxn.apply_txn(dp, ttxn.ConfigTxn(label="second").add_route(
        "10.3.0.0/16", 2, tvector.Disposition.REMOTE), journal)
    with open(path) as f:
        raw = f.read()
    torn = raw.rstrip("\n")[:-17] + "\n"
    with open(path, "w") as f:
        f.write(torn)
    reloaded = ttxn.TxnJournal(path)
    assert [t.label for t in reloaded.load()] == ["bootstrap"]
    assert reloaded.torn_lines == 1
    dp2 = CpuDataplane(ttables.DataplaneConfig())
    replayer = ttxn.TxnJournal(path)
    assert replayer.replay(dp2.builder) == 1 and replayer.torn_lines == 1
    dp2.swap()
    assert run_case(jtest, "verdicts", g, dp2) == \
        run_case(jtest, "verdicts", g, dp)
    with open(path, "w") as f:
        f.write(raw.splitlines()[0] + "\n")
    clean = ttxn.TxnJournal(path)
    clean.load()
    assert clean.torn_lines == 0
    lines = raw.splitlines()
    with open(path, "w") as f:
        f.write(lines[0][:-10] + "\n" + lines[1] + "\n")
    with pytest.raises(json.JSONDecodeError):
        ttxn.TxnJournal(path).load()
