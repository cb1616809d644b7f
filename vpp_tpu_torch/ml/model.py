"""The versioned ML model artifact: what the trainer emits and what
``TableBuilder.set_ml_model`` stages onto the device.

A copy of ``vpp_tpu/ml/model.py`` (the port never imports the JAX
package): NumPy only, the same JSON format (magic, format version,
integer arrays as nested lists, every shape revalidated at load), so an
artifact either package writes the other reads. A corrupt or
mis-versioned document raises :class:`MlModelError`.

``score_oracle`` is the host-side fixed-point reference (int64 numpy,
bit-exact with the device stage, ops/mlscore.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

FORMAT_MAGIC = "vpp-tpu-ml-model"
FORMAT_VERSION = 1

# The per-packet feature-vector width: the device stage
# (ops/mlscore.py), the trainer (ml/train.py) and the table compiler
# read it from here; csrc/ml_score.cu holds the same number as
# kFeatures, which the wrapper checks.
ML_FEATURES = 18

ACTIONS = ("mark", "drop", "ratelimit", "mirror")


class MlModelError(ValueError):
    """Raised for a corrupt, mis-versioned or mis-shaped artifact."""


@dataclasses.dataclass
class MlModel:
    """One quantized model. ``kind`` selects the kernel variant; both
    variants share the feature vector, flag threshold and policy
    fields. Biases here are UNFOLDED (no zero-point correction) — the
    fold happens at staging (pipeline/tables.py), and integer math
    makes both forms exactly equal."""

    kind: str = "mlp"                    # "mlp" | "forest"
    version: int = 1                     # model generation (operator's)
    n_features: int = 0
    # --- mlp ---
    w1: Optional[np.ndarray] = None      # int8 [F, H]
    b1: Optional[np.ndarray] = None      # int32 [H]
    s1: int = 8                          # layer-1 requant right shift
    w2: Optional[np.ndarray] = None      # int8 [H]
    b2: int = 0                          # int32 output bias
    # --- forest ---
    f_feat: Optional[np.ndarray] = None    # int32 [T, D] feature index
    f_thresh: Optional[np.ndarray] = None  # int32 [T, D] (0..255)
    f_leaf: Optional[np.ndarray] = None    # int32 [T, 2^D] leaf votes
    # --- policy ---
    flag_thresh: int = 0                 # score > thresh => flagged
    action: str = "mark"                 # ACTIONS
    rl_shift: int = 0                    # ratelimit: admit 1/2^shift flows

    @property
    def hidden(self) -> int:
        return 0 if self.w1 is None else int(self.w1.shape[1])

    @property
    def trees(self) -> int:
        return 0 if self.f_feat is None else int(self.f_feat.shape[0])

    @property
    def depth(self) -> int:
        return 0 if self.f_feat is None else int(self.f_feat.shape[1])

    def validate(self) -> "MlModel":
        if self.kind not in ("mlp", "forest"):
            raise MlModelError(f"unknown model kind {self.kind!r}")
        if self.action not in ACTIONS:
            raise MlModelError(f"unknown action {self.action!r}")
        if not (0 <= int(self.rl_shift) <= 31):
            raise MlModelError(f"rl_shift {self.rl_shift} not in 0..31")
        if self.n_features <= 0:
            raise MlModelError("n_features must be positive")
        if self.kind == "mlp":
            if self.w1 is None or self.b1 is None or self.w2 is None:
                raise MlModelError("mlp model missing w1/b1/w2")
            f, h = self.w1.shape
            if f != self.n_features:
                raise MlModelError(
                    f"w1 rows {f} != n_features {self.n_features}")
            if self.b1.shape != (h,) or self.w2.shape != (h,):
                raise MlModelError(
                    f"b1/w2 shapes {self.b1.shape}/{self.w2.shape} do "
                    f"not match hidden {h}")
            if not (0 <= int(self.s1) <= 31):
                raise MlModelError(f"s1 shift {self.s1} not in 0..31")
        else:
            if self.f_feat is None or self.f_thresh is None \
                    or self.f_leaf is None:
                raise MlModelError("forest model missing f_feat/"
                                   "f_thresh/f_leaf")
            t, d = self.f_feat.shape
            if self.f_thresh.shape != (t, d):
                raise MlModelError(
                    f"f_thresh shape {self.f_thresh.shape} != ({t},{d})")
            if self.f_leaf.shape != (t, 1 << d):
                raise MlModelError(
                    f"f_leaf shape {self.f_leaf.shape} != ({t},{1 << d})")
            if int(self.f_feat.min(initial=0)) < 0 or \
                    int(self.f_feat.max(initial=0)) >= self.n_features:
                raise MlModelError("f_feat index out of feature range")
        return self

    # --- serialization ---
    def to_dict(self) -> Dict:
        def arr(a):
            return None if a is None else np.asarray(a).tolist()

        return {
            "format": FORMAT_MAGIC,
            "format_version": FORMAT_VERSION,
            "kind": self.kind,
            "version": int(self.version),
            "n_features": int(self.n_features),
            "w1": arr(self.w1), "b1": arr(self.b1), "s1": int(self.s1),
            "w2": arr(self.w2), "b2": int(self.b2),
            "f_feat": arr(self.f_feat), "f_thresh": arr(self.f_thresh),
            "f_leaf": arr(self.f_leaf),
            "flag_thresh": int(self.flag_thresh),
            "action": self.action,
            "rl_shift": int(self.rl_shift),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "MlModel":
        if not isinstance(d, dict):
            raise MlModelError("model document is not an object")
        if d.get("format") != FORMAT_MAGIC:
            raise MlModelError(
                f"bad magic {d.get('format')!r} (not a vpp-tpu ML model)")
        if d.get("format_version") != FORMAT_VERSION:
            raise MlModelError(
                f"unsupported format_version {d.get('format_version')!r} "
                f"(this build reads {FORMAT_VERSION})")

        def arr(key, dtype):
            v = d.get(key)
            if v is None:
                return None
            try:
                out = np.asarray(v, dtype=dtype)
            except (TypeError, ValueError) as e:
                raise MlModelError(f"field {key!r} not {dtype}: {e}")
            return out

        try:
            model = cls(
                kind=d.get("kind", "mlp"),
                version=int(d.get("version", 1)),
                n_features=int(d.get("n_features", 0)),
                w1=arr("w1", np.int8), b1=arr("b1", np.int32),
                s1=int(d.get("s1", 8)),
                w2=arr("w2", np.int8), b2=int(d.get("b2", 0)),
                f_feat=arr("f_feat", np.int32),
                f_thresh=arr("f_thresh", np.int32),
                f_leaf=arr("f_leaf", np.int32),
                flag_thresh=int(d.get("flag_thresh", 0)),
                action=d.get("action", "mark"),
                rl_shift=int(d.get("rl_shift", 0)),
            )
        except (TypeError, ValueError) as e:
            if isinstance(e, MlModelError):
                raise
            raise MlModelError(f"malformed model document: {e}")
        return model.validate()


def save_model(model: MlModel, path: str) -> None:
    model.validate()
    with open(path, "w") as f:
        json.dump(model.to_dict(), f)


def load_model(path: str) -> MlModel:
    """Load + validate one artifact. IO errors propagate as OSError;
    everything wrong with the CONTENT is an MlModelError."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise MlModelError(f"corrupt model file: {e}")
    return MlModel.from_dict(doc)


# --- host-side fixed-point reference -------------------------------


def packet_features(cols: Dict[str, np.ndarray],
                    established: np.ndarray,
                    sess_age: np.ndarray) -> np.ndarray:
    """NumPy mirror of ops/mlscore.ml_features over named header
    columns (uint8 [N, ML_FEATURES]); the trainer's feature extractor
    and the oracle's input."""
    n = len(np.asarray(cols["src_ip"]))
    out = np.zeros((n, ML_FEATURES), np.uint8)
    src = np.asarray(cols["src_ip"], np.uint32)
    dst = np.asarray(cols["dst_ip"], np.uint32)
    for j, shift in enumerate((24, 16, 8, 0)):
        out[:, j] = (src >> shift) & 0xFF
        out[:, 4 + j] = (dst >> shift) & 0xFF
    sport = np.asarray(cols["sport"], np.int64)
    dport = np.asarray(cols["dport"], np.int64)
    out[:, 8] = (sport >> 8) & 0xFF
    out[:, 9] = sport & 0xFF
    out[:, 10] = (dport >> 8) & 0xFF
    out[:, 11] = dport & 0xFF
    out[:, 12] = np.asarray(cols["proto"], np.int64) & 0xFF
    out[:, 13] = np.minimum(
        np.asarray(cols["pkt_len"], np.int64) >> 4, 255)
    out[:, 14] = np.asarray(cols["flags"], np.int64) & 0xFF
    out[:, 15] = np.where(np.asarray(established, bool), 255, 0)
    out[:, 16] = np.clip(np.asarray(sess_age, np.int64), 0, 255)
    return out


def score_oracle(model: MlModel, feats: np.ndarray) -> np.ndarray:
    """Fixed-point inference in int64 numpy — every intermediate is
    exact, so equality with the device int32 kernel is bit-exactness,
    not tolerance. ``feats`` is uint8 [N, n_features] (wider feature
    matrices are truncated to the model's width; the device pads the
    staged weights instead — same contract)."""
    x = feats[:, : model.n_features].astype(np.int64)
    if model.kind == "mlp":
        a1 = x @ model.w1.astype(np.int64) + model.b1.astype(np.int64)
        r1 = np.maximum(a1, 0)
        q1 = np.clip(r1 >> int(model.s1), 0, 255)
        z = q1 @ model.w2.astype(np.int64) + int(model.b2)
        return z.astype(np.int64)
    t, d = model.f_feat.shape
    x_sel = x[:, model.f_feat.reshape(-1)]            # [N, T*D]
    bits = x_sel > model.f_thresh.reshape(-1)[None, :]
    leaf = (bits.reshape(-1, t, d).astype(np.int64)
            << np.arange(d, dtype=np.int64)[None, None, :]).sum(axis=2)
    votes = model.f_leaf.astype(np.int64)[
        np.arange(t)[None, :], leaf]
    return votes.sum(axis=1) + int(model.b2)


def flagged_oracle(model: MlModel, feats: np.ndarray) -> np.ndarray:
    return score_oracle(model, feats) > int(model.flag_thresh)
