"""The per-packet ML stage: vpp_tpu_torch vs vpp_tpu.

Op level, the same NumPy-seeded inputs and the same model (a dict from
``vpp_tpu.ml.train`` or built here, staged through both packages'
builders) go through ``ml_features``, ``ml_score`` (MLP and forest) and
``ml_policy`` (the four actions, several ``rl_shift``) of both packages;
the port's plain stage ``ml_stage_plain`` is also held against a NumPy
model of csrc/ml_score.cu's per-thread arithmetic (uint32 sums, the
forest's feature select, the policy's unsigned shifts) on random planes
with wrapping biases, shifts past 31 and feature indices outside the
vector, so the kernel's first chip call has a checked model.

Pipeline level, both packages' ``Dataplane`` are staged alike with
``ml_stage`` score / enforce and driven in lockstep through ``process``
and ``process_packed`` on both tiers: every StepResult field, counter
and the session / NAT / ECMP state must agree. Pinned as in
tests/test_ml_stage.py (whose oracles are imported): deny > ml-drop >
permit, an ML drop installs no session, no model keeps the stage off, a
capacity refusal leaves the staging intact, the fast tier scores with
the full chain's pre-touch age, the packed aux carries the ML rows, and
a swap from an MLP to a forest builds a new program while an action
swap replays the old one. Every quantity is an integer: the tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpp_tpu.ir import rule as jrule
from vpp_tpu.ml import model as jmodel
from vpp_tpu.ml import train as jtrain
from vpp_tpu.ops import mlscore as jml
from vpp_tpu.pipeline import dataplane as jdp
from vpp_tpu.pipeline import tables as jtables
from vpp_tpu.pipeline import vector as jvector
from vpp_tpu_torch.ir import rule as trule
from vpp_tpu_torch.ml import model as tmodel
from vpp_tpu_torch.ml import train as ttrain
from vpp_tpu_torch.ops import mlscore as tml
from vpp_tpu_torch.pipeline import capture as tcap
from vpp_tpu_torch.pipeline import dataplane as tdp
from vpp_tpu_torch.pipeline import graph as tgraph
from vpp_tpu_torch.pipeline import tables as ttables
from vpp_tpu_torch.pipeline import vector as tvector

from test_ml_stage import (
    oracle_features,
    oracle_flow_hash,
    oracle_scores,
    proto_model,
)
from test_torch_pipeline import _assert_results
from test_torch_tables import assert_same, packet_pair

F = jmodel.ML_FEATURES
N = 32
_CFG = dict(max_tables=2, max_rules=8, max_global_rules=32, max_ifaces=8,
            fib_slots=16, sess_slots=256, nat_mappings=2, nat_backends=4)
_TEL = tuple(ttables.TELEMETRY_FIELDS)


# --- inputs ---------------------------------------------------------------


def rand_cols(rng, n: int) -> dict:
    """Header columns with every edge the features see: addresses with
    the top bit set, ports and lengths past 16 bits and negative, flags
    over 255, every protocol byte."""
    u32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return dict(
        src_ip=u32 | np.uint32(1 << 31),
        dst_ip=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        proto=rng.integers(-300, 300, n).astype(np.int32),
        sport=rng.integers(-70000, 70000, n).astype(np.int32),
        dport=rng.integers(0, 65536, n).astype(np.int32),
        ttl=np.full(n, 64, np.int32),
        pkt_len=rng.integers(-5000, 9000, n).astype(np.int32),
        rx_if=np.ones(n, np.int32),
        flags=rng.integers(0, 1024, n).astype(np.int32))


def rand_session(rng, n: int):
    est = rng.random(n) < 0.4
    age = np.where(est, rng.integers(-20, 400, n), 0).astype(np.int32)
    return est, age


def model_cases():
    """name -> the model dict both builders stage (and its capacity)."""
    rng = np.random.default_rng(11)
    mlp, _ = jtrain.train_and_pack(kind="mlp", hidden=8, samples=512,
                                   action="drop")
    forest, _ = jtrain.train_and_pack(kind="forest", trees=4, depth=3,
                                      samples=512, action="ratelimit",
                                      rl_shift=2)
    zero = jmodel.MlModel(
        kind="mlp", n_features=F, w1=np.zeros((F, 2), np.int8),
        b1=np.zeros(2, np.int32), s1=0, w2=np.zeros(2, np.int8), b2=0)
    single = jmodel.MlModel(
        kind="mlp", n_features=1, w1=np.array([[2]], np.int8),
        b1=np.array([-10], np.int32), s1=1, w2=np.array([3], np.int8),
        b2=7, flag_thresh=50)
    rforest = jmodel.MlModel(
        kind="forest", version=3, n_features=F,
        f_feat=rng.integers(0, F, (4, 3)).astype(np.int32),
        f_thresh=rng.integers(0, 256, (4, 3)).astype(np.int32),
        f_leaf=rng.integers(-500, 500, (4, 8)).astype(np.int32),
        b2=-17, flag_thresh=0)
    wide = jmodel.MlModel(
        kind="mlp", n_features=F,
        w1=rng.integers(-127, 128, (F, 16)).astype(np.int8),
        b1=rng.integers(-(1 << 20), 1 << 20, 16).astype(np.int32), s1=9,
        w2=rng.integers(-127, 128, 16).astype(np.int8), b2=-3,
        flag_thresh=-(1 << 31), action="mirror")
    return {"trained-mlp": mlp, "trained-forest": forest, "zero": zero,
            "single-feature": single, "random-forest": rforest,
            "wide-mlp": wide}


_MODELS = model_cases()


def staged_pair(model, **over):
    """Both packages' tables with ``model`` staged at capacity 16 / 4 x
    3 (the same dict through each builder's ``set_ml_model``)."""
    kw = dict(_CFG, ml_stage="enforce", ml_hidden=16, ml_trees=4,
              ml_depth=3, **over)
    jb = jtables.TableBuilder(jtables.DataplaneConfig(**kw))
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    for b in (jb, tb):
        b.set_ml_model(model.to_dict())
    assert jb.ml_kind == tb.ml_kind
    for f, a in jb.ml.items():
        np.testing.assert_array_equal(np.asarray(tb.ml[f]), np.asarray(a))
    return jb.to_device(), tb.to_device()


# --- op level -------------------------------------------------------------


def test_ml_features_match_reference():
    rng = np.random.default_rng(1)
    cols = rand_cols(rng, 200)
    est, age = rand_session(rng, 200)
    jpv, tpv = packet_pair(cols)
    want = jml.ml_features(jpv, jnp.asarray(est), jnp.asarray(age))
    got = tml.ml_features(tpv, torch.from_numpy(est), torch.from_numpy(age))
    assert got.dtype == torch.uint8
    assert_same(want, got, "features")
    assert_same(jml._centered(want), tml._centered(got), "centered")
    np.testing.assert_array_equal(
        got.numpy(), tmodel.packet_features(cols, est, age))


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_ml_score_matches_reference(name):
    model = _MODELS[name]
    jt, tt = staged_pair(model)
    kind = model.kind
    rng = np.random.default_rng(2)
    for _ in range(2):
        cols = rand_cols(rng, 96)
        est, age = rand_session(rng, 96)
        jpv, tpv = packet_pair(cols)
        want = jml.ml_score(jt, jpv, jnp.asarray(est), jnp.asarray(age),
                            kind=kind)
        got = tml.ml_score(tt, tpv, torch.from_numpy(est),
                           torch.from_numpy(age), kind=kind)
        assert_same(want, got, f"{name} scores")
        # and the unfolded oracle of tests/test_ml_stage.py, which
        # takes the length bucket of a negative length as is (the
        # stage keeps its low byte): held on the other lanes
        ora = oracle_scores(model, oracle_features(jpv, est, age))
        ok = cols["pkt_len"] >= 0
        np.testing.assert_array_equal(got.numpy()[ok],
                                      ora.astype(np.int32)[ok])


@pytest.mark.parametrize("action", ["mark", "drop", "ratelimit", "mirror"])
@pytest.mark.parametrize("rl_shift", [0, 1, 3, 31])
def test_ml_policy_matches_reference(action, rl_shift):
    model = proto_model(flag_thresh=10, action=action, rl_shift=rl_shift)
    jt, tt = staged_pair(model)
    rng = np.random.default_rng(rl_shift)
    cols = rand_cols(rng, 128)
    cols["proto"] = rng.choice([1, 6, 17], 128).astype(np.int32)
    alive = rng.random(128) < 0.8
    jpv, tpv = packet_pair(cols)
    scores = rng.integers(-30, 30, 128).astype(np.int32)
    jf, jd = jml.ml_policy(jt, jpv, jnp.asarray(alive), jnp.asarray(scores))
    tf, td = tml.ml_policy(tt, tpv, torch.from_numpy(alive),
                           torch.from_numpy(scores))
    assert_same(jf, tf, "flagged")
    assert_same(jd, td, "drop_wanted")
    if action == "ratelimit":
        admit = (oracle_flow_hash(jpv) & np.uint32((1 << rl_shift) - 1)) == 0
        np.testing.assert_array_equal(td.numpy(), tf.numpy() & ~admit)
    # the whole stage: scores, then the policy
    est, age = rand_session(rng, 128)
    out = tml.ml_stage(tt, tpv, torch.from_numpy(alive),
                       torch.from_numpy(est), torch.from_numpy(age))
    want = jml.ml_score(jt, jpv, jnp.asarray(est), jnp.asarray(age))
    wf, wd = jml.ml_policy(jt, jpv, jnp.asarray(alive), want)
    for w, g, what in zip((want, wf, wd), out, ("scores", "flag", "drop")):
        assert_same(w, g, what)
    assert tml.ml_stage.launches == 0


# --- a NumPy model of csrc/ml_score.cu ---------------------------------


def kernel_model(cols, est, age, alive, planes, kind, tnt=None):
    """csrc/ml_score.cu's arithmetic, one lane per packet, in NumPy:
    uint32 sums, the unrolled feature select, the policy's unsigned
    shift and mask; with ``tnt`` = (tid, modes, threshs) the per-tenant
    policy (the tenant's threshold unless INT32_MIN, nothing flagged
    under mode 1, drops only under modes 0 and 3)."""
    u, i32 = np.uint32, np.int32
    src = cols["src_ip"].astype(u)
    dst = cols["dst_ip"].astype(u)
    sp, dp, pr = (cols[k].astype(np.int64) for k in ("sport", "dport",
                                                      "proto"))
    n = len(src)
    xc = np.zeros((n, F), np.int64)
    for k in range(4):
        xc[:, k] = (src >> u(24 - 8 * k)) & u(0xFF)
        xc[:, 4 + k] = (dst >> u(24 - 8 * k)) & u(0xFF)
    xc[:, 8], xc[:, 9] = (sp >> 8) & 0xFF, sp & 0xFF
    xc[:, 10], xc[:, 11] = (dp >> 8) & 0xFF, dp & 0xFF
    xc[:, 12] = pr & 0xFF
    xc[:, 13] = np.minimum(cols["pkt_len"].astype(np.int64) >> 4, 255) \
        & 0xFF
    xc[:, 14] = cols["flags"].astype(np.int64) & 0xFF
    xc[:, 15] = np.where(est, 255, 0)
    xc[:, 16] = np.clip(age.astype(np.int64), 0, 255)
    xc -= 128

    def wrap(x):  # an int64 value as the uint32 a C cast makes
        return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(u)

    acc = np.zeros(n, u)
    with np.errstate(over="ignore"):
        if kind == "mlp":
            w1 = planes["glb_ml_w1"].astype(np.int64)
            b1 = planes["glb_ml_b1"].astype(np.int64)
            w2 = planes["glb_ml_w2"].astype(np.int64)
            s1 = int(planes["glb_ml_s1"]) & 0xFFFFFFFF
            for j in range(w1.shape[1]):
                a = np.full(n, wrap(b1[j]), u)
                for f in range(F):
                    a = a + wrap(xc[:, f] * w1[f, j])
                r = np.maximum(a.view(i32).astype(np.int64), 0)
                q = np.minimum(r >> s1 if s1 < 32 else 0 * r, 255)
                acc = acc + wrap((q - 128) * w2[j])
        else:
            feat = planes["glb_ml_f_feat"]
            thr = planes["glb_ml_f_thresh"].astype(np.int64)
            leaf_votes = planes["glb_ml_f_leaf"]
            trees, depth = feat.shape
            for t in range(trees):
                leaf = np.zeros(n, np.int64)
                for lv in range(depth):
                    fi = int(feat[t, lv])
                    v = xc[:, fi] if 0 <= fi < F else np.zeros(n, np.int64)
                    leaf |= (v + 128 > thr[t, lv]).astype(np.int64) << lv
                acc = acc + wrap(leaf_votes[t][leaf])
        score = (acc + wrap(int(planes["glb_ml_b2"]))).view(i32)
        thresh = np.full(n, int(planes["glb_ml_thresh"]), np.int64)
        scored = drop_ok = np.ones(n, bool)
        if tnt is not None:
            tid, modes, threshs = (np.asarray(a) for a in tnt)
            t_thr = threshs[tid].astype(np.int64)
            thresh = np.where(t_thr != -(1 << 31), t_thr, thresh)
            scored = modes[tid] != 1
            drop_ok = (modes[tid] == 0) | (modes[tid] == 3)
        flag = alive & (score > thresh) & scored
        ports = wrap((sp << 16) | (dp & 0xFFFF))
        h = ((src * u(0x9E3779B1)) ^ (dst * u(0x85EBCA77))
             ^ (ports * u(0xC2B2AE3D)) ^ (wrap(pr) * u(0x27D4EB2F)))
        h = h ^ (h >> u(15))
        rl = int(planes["glb_ml_rl_shift"]) & 0xFFFFFFFF
        mask = u(0xFFFFFFFF) if rl >= 32 else u((1 << rl) - 1)
        admit = (h & mask) == 0
    action = int(planes["glb_ml_action"])
    drop = flag & drop_ok & ((action == 1) | ((action == 2) & ~admit))
    return score, flag, drop


def rand_planes(rng, kind, hidden=16, trees=4, depth=3):
    """Random model planes with wrapping biases, shifts past 31 or
    negative, feature indices off the vector, extreme thresholds."""
    i32 = (-(1 << 31), (1 << 31) - 1)
    return {
        "glb_ml_w1": rng.integers(-128, 128, (F, hidden)).astype(np.int8),
        "glb_ml_b1": rng.integers(*i32, hidden, dtype=np.int64).astype(
            np.int32),
        "glb_ml_s1": np.int32(rng.choice([-1, 0, 3, 9, 31, 32, 40])),
        "glb_ml_w2": rng.integers(-128, 128, hidden).astype(np.int8),
        "glb_ml_b2": np.int32(rng.integers(*i32, dtype=np.int64)),
        "glb_ml_f_feat": rng.integers(-2, F + 3, (trees, depth)).astype(
            np.int32),
        "glb_ml_f_thresh": rng.choice(
            [i32[0], -1, 0, 100, 127, 128, 200, 255, i32[1]],
            (trees, depth)).astype(np.int32),
        "glb_ml_f_leaf": rng.integers(*i32, (trees, 1 << depth),
                                      dtype=np.int64).astype(np.int32),
        "glb_ml_thresh": np.int32(rng.choice([i32[0], -5, 0, 77, i32[1]])),
        "glb_ml_action": np.int32(rng.choice([0, 1, 2, 3, 7])),
        "glb_ml_rl_shift": np.int32(rng.choice([-1, 0, 1, 5, 31, 32])),
    }


@pytest.mark.parametrize("kind", ["mlp", "forest"])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_model_matches_plain_version(kind, seed):
    rng = np.random.default_rng(100 + seed)
    planes = rand_planes(rng, kind, hidden=int(rng.integers(1, 17)),
                         trees=int(rng.integers(1, 6)),
                         depth=int(rng.integers(1, 5)))
    cols = rand_cols(rng, 64)
    est, age = rand_session(rng, 64)
    alive = rng.random(64) < 0.9
    tables = type("Planes", (), {f: torch.from_numpy(np.array(a))
                                 for f, a in planes.items()})
    _, tpv = packet_pair(cols)
    got = tml.ml_stage_plain(tables, tpv, torch.from_numpy(alive),
                             torch.from_numpy(est), torch.from_numpy(age),
                             kind)
    want = kernel_model(cols, est, age, alive, planes, kind)
    for w, g, what in zip(want, got, ("scores", "flagged", "drop")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


def test_trainer_copy_packs_the_reference_model(tmp_path):
    """The port's NumPy trainer and artifact layer are the reference's:
    the same seed packs the same model, and each package reads the
    other's file."""
    for kind in ("mlp", "forest"):
        jm, jrep = jtrain.train_and_pack(kind=kind, samples=512, seed=4,
                                         action="drop")
        tm, trep = ttrain.train_and_pack(kind=kind, samples=512, seed=4,
                                         action="drop")
        assert jm.to_dict() == tm.to_dict() and jrep == trep
        path = tmp_path / f"{kind}.json"
        tmodel.save_model(tm, str(path))
        assert jmodel.load_model(str(path)).to_dict() == tm.to_dict()
    bad = dict(tm.to_dict(), format_version=99)
    with pytest.raises(tmodel.MlModelError, match="format_version"):
        tmodel.MlModel.from_dict(bad)


# --- pipeline level: both Dataplanes in lockstep ------------------------


def _permit_all(m):
    return m.ContivRule(action=m.Action.PERMIT, protocol=m.Protocol.ANY)


def _deny_rule(m, cidr):
    import ipaddress

    return m.ContivRule(action=m.Action.DENY, protocol=m.Protocol.TCP,
                        src_network=ipaddress.ip_network(cidr))


class Pair:
    """One Dataplane per package (the port's on the CPU), staged with
    the same rules and model, driven in lockstep."""

    def __init__(self, ml_stage="enforce", model=None, rules=(),
                 fastpath=True, **over):
        kw = dict(_CFG, ml_stage=ml_stage, fastpath=fastpath, **over)
        self.j = jdp.Dataplane(jtables.DataplaneConfig(**kw))
        self.t = tdp.Dataplane(ttables.DataplaneConfig(**kw), device="cpu")
        for dp, m in ((self.j, jrule), (self.t, trule)):
            self.up = dp.add_uplink()
            self.pod = dp.add_pod_interface(("default", "pod"))
            dp.builder.add_route("10.1.1.0/24", self.pod,
                                 jvector.Disposition.LOCAL)
            dp.builder.add_route("0.0.0.0/0", self.up,
                                 jvector.Disposition.REMOTE, node_id=1)
            if rules:
                dp.builder.set_global_table([r(m) for r in rules])
            if model is not None:
                dp.builder.set_ml_model(model.to_dict())
            dp.swap()
        assert (self.t._ml_mode, self.t._ml_kind) == (self.j._ml_mode,
                                                      self.j._ml_kind)

    def set_model(self, model):
        for dp in (self.j, self.t):
            dp.builder.set_ml_model(model.to_dict())
            dp.swap()
        assert (self.t._ml_mode, self.t._ml_kind) == (self.j._ml_mode,
                                                      self.j._ml_kind)

    def step(self, specs, now, n=16):
        jr = self.j.process(jvector.make_packet_vector(specs, n=n), now=now)
        tr = self.t.process(tvector.make_packet_vector(specs, n=n), now=now)
        _assert_results(jr, tr)
        for f in _TEL:
            assert_same(getattr(jr.tables, f), getattr(tr.tables, f), f)
        return tr


def _fwd(n, now_base=0):
    return [dict(src=f"10.1.1.{2 + i}", dst=f"172.16.0.{10 + i}", proto=6,
                 sport=5000 + i, dport=80, rx_if=1) for i in range(n)]


def _replies(n, up, proto=6):
    return [dict(src=f"172.16.0.{10 + i}", dst=f"10.1.1.{2 + i}",
                 proto=proto, sport=80, dport=5000 + i, len=600, rx_if=up)
            for i in range(n)]


def _mixed(up):
    """8 replies to established flows, 8 fresh UDP, 8 fresh TCP."""
    return (_replies(8, up)
            + [dict(src=f"198.18.0.{i}", dst=f"10.1.1.{2 + i}", proto=17,
                    sport=53, dport=9000 + i, len=60, rx_if=up)
               for i in range(8)]
            + [dict(src=f"198.19.0.{i}", dst=f"10.1.1.{2 + i}", proto=6,
                    sport=443, dport=9100 + i, len=1500, rx_if=up)
               for i in range(8)])


@pytest.mark.parametrize("ml_stage", ["score", "enforce"])
@pytest.mark.parametrize("action", ["drop", "ratelimit"])
def test_pipeline_matches_reference_on_mixed_traffic(ml_stage, action):
    """Priming (full chain), a mixed reply batch (full chain, sessions
    of several ages), then the established replies alone (the fast
    tier), under a proto-keyed model: bit-exact every step."""
    pair = Pair(ml_stage, proto_model(action=action, rl_shift=1),
                rules=[_permit_all])
    r0 = pair.step(_fwd(8), now=100, n=32)
    assert int(r0.stats.tx) == 8 and int(r0.stats.ml_scored) == 8
    res = pair.step(_mixed(pair.up), now=107, n=32)
    assert int(res.stats.fastpath) == 0
    assert int(res.stats.ml_flagged) == 8
    drops = int(res.stats.ml_drops)
    assert (drops > 0) == (ml_stage == "enforce")
    assert int(res.stats.drop_acl) == 0
    udp = _mixed(pair.up)[8:16]
    res = pair.step(_replies(8, pair.up) + udp, now=109, n=32)
    fast = pair.step(_replies(8, pair.up), now=111)
    assert int(fast.stats.fastpath) == 1 and int(fast.stats.ml_scored) == 8


def test_deny_beats_ml_drop_beats_permit():
    pair = Pair("enforce", proto_model(flag_thresh=-1, action="drop"),
                rules=[lambda m: _deny_rule(m, "198.51.100.0/24"),
                       _permit_all])
    specs = [dict(src="198.51.100.7", dst="10.1.1.2", proto=6, sport=1234,
                  dport=80, rx_if=pair.up),
             dict(src="172.16.0.9", dst="10.1.1.3", proto=6, sport=1234,
                  dport=80, rx_if=pair.up)]
    res = pair.step(specs, now=1, n=8)
    cause = res.drop_cause.numpy()
    assert (cause[0], cause[1]) == (tgraph.DROP_ACL, tgraph.DROP_ML)
    pair.set_model(proto_model(flag_thresh=1 << 30, action="drop"))
    res = pair.step(specs, now=2, n=8)
    assert tuple(res.drop_cause.numpy()[:2]) == (tgraph.DROP_ACL, 0)
    assert int(res.stats.tx) == 1


def test_ml_drop_installs_no_session():
    pair = Pair("enforce", proto_model(flag_thresh=-1, action="drop"),
                rules=[_permit_all])
    res = pair.step(_fwd(1), now=1, n=8)
    assert int(res.stats.ml_drops) == 1
    assert int(pair.t.tables.sess_valid.sum()) == 0


def test_no_model_keeps_the_stage_off():
    pair = Pair("enforce", None, rules=[_permit_all])
    assert pair.t._ml_mode == pair.j._ml_mode == "off"
    res = pair.step(_fwd(4), now=1)
    assert int(res.stats.ml_scored) == 0
    pair.set_model(proto_model())
    assert pair.t._ml_mode == "enforce"
    res = pair.step(_fwd(4), now=2)
    assert int(res.stats.ml_scored) == 4
    # and back off with clear_ml_model
    for dp in (pair.j, pair.t):
        dp.builder.clear_ml_model()
        dp.swap()
    assert pair.t._ml_mode == pair.j._ml_mode == "off"
    pair.step(_fwd(4), now=3)


def test_capacity_refusal_leaves_staging_intact():
    kw = dict(_CFG, ml_stage="enforce", ml_hidden=4)
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    tb.set_ml_model(proto_model(version=1).to_dict())
    before = {f: np.array(a) for f, a in tb.ml.items()}
    too_big = jmodel.MlModel(
        kind="mlp", version=2, n_features=F,
        w1=np.zeros((F, 8), np.int8), b1=np.zeros(8, np.int32), s1=0,
        w2=np.zeros(8, np.int8), b2=0)
    for bad in (too_big.to_dict(), dict(too_big.to_dict(), kind="tree")):
        with pytest.raises(tmodel.MlModelError):
            tb.set_ml_model(bad)
        assert tb.ml_kind == 1
        for f, a in before.items():
            np.testing.assert_array_equal(tb.ml[f], a, err_msg=f)


def test_fast_tier_age_feature_matches_full_chain():
    """A model keyed on the session-age feature: the fast tier reads
    the age before its touch, as the full chain does. Each auto step is
    also replayed on a copy through the port's forced full chain."""
    w1 = np.zeros((F, 2), np.int8)
    w1[16, 0] = 1
    model = jmodel.MlModel(
        kind="mlp", n_features=F, w1=w1, b1=np.zeros(2, np.int32), s1=0,
        w2=np.array([1, 0], np.int8), b2=0, flag_thresh=5, action="drop")
    pair = Pair("enforce", model, rules=[_permit_all])
    pair.step(_fwd(1), now=10, n=8)
    t = pair.t
    full = tgraph.make_pipeline_step(
        t.classifier_impl, t._skip_local, False, t._sweep_stride,
        ml_mode="enforce", fib_impl=t.fib_impl, sess_impl=t.session_impl)
    for now, drops in ((13, 0), (22, 1)):
        tb = t.tables
        copy = tb._replace(**{f: getattr(tb, f).clone()
                              for f in tdp._MUTABLE_FIELDS})
        ref = full(copy, tvector.make_packet_vector(_replies(1, pair.up),
                                                    n=8), now)
        res = pair.step(_replies(1, pair.up), now=now, n=8)
        assert int(res.stats.fastpath) == 1 and int(ref.stats.fastpath) == 0
        assert int(res.stats.ml_drops) == drops
        for f in ("ml_scores", "ml_flagged", "drop_cause", "disp"):
            assert torch.equal(getattr(ref, f), getattr(res, f)), f
        assert int(res.ml_scores[0]) == now - (10 if now == 13 else 13)


def test_packed_aux_carries_the_ml_rows():
    pair = Pair("enforce", proto_model(action="drop"), rules=[_permit_all])
    specs = ([dict(src=f"198.18.0.{i}", dst=f"10.1.1.{2 + i}", proto=17,
                   sport=53, dport=9000 + i, rx_if=pair.up)
              for i in range(5)]
             + [dict(src=f"198.19.0.{i}", dst=f"10.1.1.{2 + i}", proto=6,
                     sport=443, dport=9100 + i, rx_if=pair.up)
                for i in range(3)])
    jpv = jvector.make_packet_vector(specs, n=16)
    cols = {f: np.asarray(getattr(jpv, f)) for f in jvector.PacketVector
            ._fields}
    flat = jdp.packed_input_zeros(16)
    jdp.pack_packet_columns(flat.view(np.uint32), cols, 16)
    jo, ja = pair.j.process_packed(flat, now=3, with_aux=True)
    to, ta = pair.t.process_packed(flat, now=3, with_aux=True)
    assert_same(jo, to, "out")
    assert_same(ja, ta, "aux")
    schema = tdp.PACKED_AUX_SCHEMA
    aux = ta.numpy()
    assert (aux[schema.index("ml_scored")], aux[schema.index("ml_flagged")],
            aux[schema.index("ml_drops")]) == (8, 5, 5)
    # K = 3 chained, on the auto path's packed program
    flats = np.stack([flat] * 3)
    jo, ja = pair.j.process_packed_chain(flats, now=4, with_aux=True)
    to, ta = pair.t.process_packed_chain(flats, now=4, with_aux=True)
    assert_same(jo, to, "chain out")
    assert_same(ja, ta, "chain aux")


def test_model_swaps_pick_their_program():
    """An MLP -> forest swap re-gates ``ml_kind`` and builds a program
    under a new key (and label); an action swap is table values only:
    the same program replays and sees them."""
    pair = Pair("enforce", proto_model(action="mark"), rules=[_permit_all],
                ml_trees=4, ml_depth=3)
    t = pair.t
    specs = _fwd(6) + _replies(4, pair.up, proto=17)
    pair.step(specs, now=1)
    keys = set(t._programs)
    labels = {p.full.label for p in t.programs()}
    forest = jmodel.MlModel(
        kind="forest", n_features=F, f_feat=np.full((2, 2), 12, np.int32),
        f_thresh=np.array([[10, 255], [0, 5]], np.int32),
        f_leaf=np.array([[0, 40, 0, 0], [1, 2, 3, 4]], np.int32),
        flag_thresh=30, action="drop")
    pair.set_model(forest)
    assert t._ml_kind == "forest"
    res = pair.step(specs, now=2)
    assert int(res.stats.ml_drops) == 4
    new = set(t._programs) - keys
    assert len(new) == 1 and next(iter(new))[8:11] == (
        "enforce", "forest", "off")
    assert any("_mlenforce_forest" in p.full.label for p in t.programs()
               if p.full.label not in labels)
    before = tcap.capture_counts()
    pair.set_model(jmodel.MlModel.from_dict(dict(
        forest.to_dict(), action="ratelimit", rl_shift=1)))
    res = pair.step(specs, now=3)
    assert tcap.capture_counts() == before
    assert int(res.stats.ml_flagged) == 4
    assert int(res.stats.ml_drops) < 4


# --- the loader, its fault seam and the trainer's command line ---------

import test_chaos as jchaos_tests  # noqa: E402
import test_ml_stage as jml_tests  # noqa: E402
from test_torch_kvserver import run_port_case  # noqa: E402

# the reference's cases of the artifact, the loader (its refusal ledger,
# `show ml`, the agent's ml_model_path) and the chaos schedule over the
# ``ml.load`` seam, each run on the port
LOADER_CASES = [
    (jml_tests, "TestArtifact.test_bad_magic_version_and_corrupt_json"),
    (jml_tests, "TestArtifact.test_shape_validation"),
    (jml_tests, "TestLoader.test_refusal_keeps_previous_model_serving"),
    (jml_tests, "TestShowMl.test_show_ml_page"),
    (jml_tests, "TestShowMl.test_show_ml_without_model"),
    (jml_tests, "TestAgentWiring.test_yaml_config_to_scoring_epoch"),
    (jchaos_tests, "TestMlModelRefusals."
                   "test_refusal_schedule_keeps_previous_generation_serving"),
]


@pytest.mark.parametrize("module,case", LOADER_CASES,
                         ids=[c.split(".")[1] for _, c in LOADER_CASES])
def test_reference_loader_cases(module, case, request):
    from vpp_tpu_torch.testing import faults as tfaults

    try:
        run_port_case(module, case, request)
    finally:
        tfaults.uninstall()  # the plan is process-global


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_trainer_main_round_trips_across_packages(writer, tmp_path,
                                                  capsys):
    """``vpp-tpu-torch-ml-train`` and the reference's trainer write the
    same artifact for the same arguments; either package loads it and
    stages it to the same packed planes."""
    argv = ["--kind", "mlp", "--hidden", "16", "--samples", "512",
            "--seed", "5", "--action", "drop", "--version", "3"]
    paths = {}
    for pkg, main in (("ref", jtrain.main), ("port", ttrain.main)):
        paths[pkg] = tmp_path / f"{pkg}.json"
        assert main(["--out", str(paths[pkg])] + argv) == 0
    out = capsys.readouterr().out
    assert out.count("wrote mlp model v3") == 2
    assert paths["ref"].read_text() == paths["port"].read_text()
    path = str(paths[writer])
    jm, tm = jmodel.load_model(path), tmodel.load_model(path)
    assert jm.to_dict() == tm.to_dict()
    kw = dict(_CFG, ml_stage="enforce", ml_hidden=16)
    jb = jtables.TableBuilder(jtables.DataplaneConfig(**kw))
    tb = ttables.TableBuilder(ttables.DataplaneConfig(**kw), device="cpu")
    jb.set_ml_model(jm)
    tb.set_ml_model(tm)
    assert jb.ml_kind == tb.ml_kind == 1
    for f, a in jb.ml.items():
        np.testing.assert_array_equal(np.asarray(tb.ml[f]), np.asarray(a))
