"""Offline trainer/packer for the per-packet ML stage: a copy of
``vpp_tpu/ml/train.py`` (the port never imports the JAX package).

NumPy-only: trains a tiny float MLP (full-batch gradient descent — the
model is ~300 weights; sophistication belongs to the operator's real
pipeline, this is the in-tree reference packer) or fits an oblivious
decision forest, quantizes to the int8 fixed-point contract of
ops/mlscore.py, validates the quantized artifact against the
fixed-point oracle, and returns the versioned artifact
(``TableBuilder.set_ml_model`` stages it; ``ml.model.save_model``
writes it as JSON).

The synthetic dataset labels a "DDoS-ish" slice of traffic (tiny
packets, low ports, no established session) — enough to make the
acceptance tests meaningful end to end; swap in real features/labels
via train_mlp()/quantize_mlp() for anything serious.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vpp_tpu_torch.ml.model import (
    MlModel,
    flagged_oracle,
    packet_features,
    score_oracle,
)


def make_synth_dataset(n: int = 8192, seed: int = 0,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded synthetic (features, labels). Attack slice: short frames
    from a concentrated /16, low source ports, sessionless."""
    rng = np.random.default_rng(seed)
    attack = rng.random(n) < 0.35
    src = np.where(
        attack,
        (198 << 24) | (18 << 16) | rng.integers(0, 1 << 16, n),
        (172 << 24) | (16 << 16) | rng.integers(0, 1 << 16, n),
    ).astype(np.uint32)
    dst = ((10 << 24) | (1 << 16) | (1 << 8)
           | rng.integers(2, 250, n)).astype(np.uint32)
    cols = {
        "src_ip": src,
        "dst_ip": dst,
        "sport": np.where(attack, rng.integers(1, 1024, n),
                          rng.integers(1024, 65535, n)),
        "dport": np.full(n, 80),
        "proto": np.where(attack & (rng.random(n) < 0.5), 17, 6),
        "pkt_len": np.where(attack, rng.integers(40, 80, n),
                            rng.integers(200, 1500, n)),
        "flags": np.ones(n, np.int64),
    }
    established = ~attack & (rng.random(n) < 0.6)
    age = np.where(established, rng.integers(0, 200, n), 0)
    feats = packet_features(cols, established, age)
    return feats, attack.astype(np.float64)


def train_mlp(feats: np.ndarray, labels: np.ndarray, hidden: int = 16,
              epochs: int = 300, lr: float = 0.5, seed: int = 0,
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Full-batch GD on a 1-hidden-layer relu MLP with logistic output.
    Inputs are normalized to [-0.5, 0.5]; returns FLOAT (w1, b1, w2,
    b2) in that normalized space (quantize_mlp folds the scaling)."""
    rng = np.random.default_rng(seed)
    x = feats.astype(np.float64) / 255.0 - 0.5
    y = labels.astype(np.float64)
    f = x.shape[1]
    w1 = rng.normal(0, 1.0 / np.sqrt(f), (f, hidden))
    b1 = np.zeros(hidden)
    w2 = rng.normal(0, 1.0 / np.sqrt(hidden), hidden)
    b2 = 0.0
    n = len(y)
    for _ in range(epochs):
        a1 = x @ w1 + b1
        r1 = np.maximum(a1, 0.0)
        z = r1 @ w2 + b2
        p = 1.0 / (1.0 + np.exp(-z))
        dz = (p - y) / n
        dw2 = r1.T @ dz
        db2 = dz.sum()
        dr1 = np.outer(dz, w2) * (a1 > 0)
        dw1 = x.T @ dr1
        db1 = dr1.sum(axis=0)
        w1 -= lr * dw1
        b1 -= lr * db1
        w2 -= lr * dw2
        b2 -= lr * db2
    return w1, b1, w2, float(b2)


def quantize_mlp(w1: np.ndarray, b1: np.ndarray, w2: np.ndarray,
                 b2: float, calib: np.ndarray,
                 flag_quantile: float = 0.65, action: str = "mark",
                 rl_shift: int = 0, version: int = 1) -> MlModel:
    """Float weights (normalized-input space) → the int8 fixed-point
    artifact. Per-tensor symmetric weight scaling, input scale folded
    (x/255 - 0.5 == (x - 127.5)/255 — the 0.5 input offset lands in
    the integer bias), layer-1 requant as a pure right shift picked
    from the calibration activations, and the flag threshold taken at
    ``flag_quantile`` of the calibration scores."""
    s_w1 = 127.0 / max(np.abs(w1).max(), 1e-9)
    q_w1 = np.clip(np.round(w1 * s_w1), -127, 127).astype(np.int8)
    # integer layer 1 computes x_u8 @ q_w1 + q_b1 (x in 0..255); the
    # float net computed (x/255 - 0.5) @ w1 + b1. Matching scales:
    # int_acc ≈ 255 * s_w1 * (float_acc) + 127.5 * colsum(q_w1); put
    # the -127.5*colsum correction plus the scaled b1 into q_b1.
    scale1 = 255.0 * s_w1
    q_b1 = np.round(
        b1 * scale1 - 127.5 * q_w1.astype(np.float64).sum(axis=0)
    ).astype(np.int32)
    # calibrate the requant shift so typical activations land in 0..255
    x = calib.astype(np.int64)
    a1 = np.maximum(
        x @ q_w1.astype(np.int64) + q_b1.astype(np.int64), 0)
    peak = max(float(np.quantile(a1, 0.999)), 1.0)
    s1 = max(int(np.ceil(np.log2(peak / 255.0))), 0)
    q1 = np.clip(a1 >> s1, 0, 255)
    s_w2 = 127.0 / max(np.abs(w2).max(), 1e-9)
    q_w2 = np.clip(np.round(w2 * s_w2), -127, 127).astype(np.int8)
    # output bias only shifts the score/threshold pair together; keep
    # the raw scaled term for b2
    q_b2 = int(np.round(b2 * s_w2 * 255.0))
    z = q1 @ q_w2.astype(np.int64) + q_b2
    flag_thresh = int(np.quantile(z, flag_quantile))
    return MlModel(
        kind="mlp", version=version, n_features=w1.shape[0],
        w1=q_w1, b1=q_b1, s1=s1, w2=q_w2, b2=q_b2,
        flag_thresh=flag_thresh, action=action, rl_shift=rl_shift,
    ).validate()


def train_forest(feats: np.ndarray, labels: np.ndarray, trees: int = 4,
                 depth: int = 3, seed: int = 0, flag_quantile: float = 0.65,
                 action: str = "mark", rl_shift: int = 0,
                 version: int = 1) -> MlModel:
    """Fit an oblivious forest: per tree, D (feature, threshold) levels
    picked greedily by absolute label/feature correlation on a seeded
    feature subset; leaf votes are scaled mean labels. Deliberately
    simple — the artifact contract is the point, not the fit."""
    rng = np.random.default_rng(seed)
    x = feats.astype(np.float64)
    y = labels.astype(np.float64)
    n_feat = x.shape[1]
    f_feat = np.zeros((trees, depth), np.int32)
    f_thresh = np.zeros((trees, depth), np.int32)
    f_leaf = np.zeros((trees, 1 << depth), np.int32)
    resid = y - y.mean()
    for t in range(trees):
        cand = rng.permutation(n_feat)[: max(4, n_feat // 2)]
        r_std = float(np.std(resid))
        corr = [abs(np.corrcoef(x[:, c], resid)[0, 1])
                if np.std(x[:, c]) > 0 and r_std > 0 else 0.0
                for c in cand]
        order = np.argsort(corr)[::-1]
        for d in range(depth):
            c = int(cand[order[d % len(cand)]])
            f_feat[t, d] = c
            f_thresh[t, d] = int(np.clip(np.median(x[:, c]), 0, 255))
        bits = (x[:, f_feat[t]] > f_thresh[t][None, :])
        leaf = (bits.astype(np.int64)
                << np.arange(depth, dtype=np.int64)[None, :]).sum(axis=1)
        for lf in range(1 << depth):
            m = leaf == lf
            if m.any():
                f_leaf[t, lf] = int(np.round(
                    (y[m].mean() - 0.5) * 256.0))
        pred = f_leaf[t][leaf] / 256.0
        resid = resid - pred
    model = MlModel(
        kind="forest", version=version, n_features=n_feat,
        f_feat=f_feat, f_thresh=f_thresh, f_leaf=f_leaf,
        action=action, rl_shift=rl_shift,
    )
    scores = score_oracle(model.validate(), feats)
    model.flag_thresh = int(np.quantile(scores, flag_quantile))
    return model.validate()


def train_and_pack(kind: str = "mlp", hidden: int = 16, trees: int = 4,
                   depth: int = 3, samples: int = 8192, seed: int = 0,
                   action: str = "mark", rl_shift: int = 0,
                   version: int = 1) -> Tuple[MlModel, dict]:
    """One-call train → quantize → self-validate. Returns (model,
    report); the report carries the quantized-vs-label accuracy the
    CLI prints (and refuses on when degenerate)."""
    feats, labels = make_synth_dataset(samples, seed)
    if kind == "forest":
        model = train_forest(feats, labels, trees, depth, seed,
                             action=action, rl_shift=rl_shift,
                             version=version)
    else:
        w1, b1, w2, b2 = train_mlp(feats, labels, hidden, seed=seed)
        model = quantize_mlp(w1, b1, w2, b2, feats, action=action,
                             rl_shift=rl_shift, version=version)
    flagged = flagged_oracle(model, feats)
    labels_b = labels > 0.5
    acc = float((flagged == labels_b).mean())
    recall = float(flagged[labels_b].mean()) if labels_b.any() else 0.0
    fpr = float(flagged[~labels_b].mean()) if (~labels_b).any() else 0.0
    return model, {"accuracy": acc, "recall": recall,
                   "false_positive_rate": fpr,
                   "flagged_pct": float(flagged.mean() * 100.0)}

