"""Per-packet ML scoring: an int8 fixed-point model over every packet.

The PyTorch counterpart of ``vpp_tpu/ops/mlscore.py``: a small
quantized MLP (or an oblivious decision forest) scores each packet of
the vector from 18 uint8 header features, and the policy folds the
score into a flag and a drop request. The fixed-point contract is the
reference's:

* features are uint8, centered to int8 as ``x - 128`` (the staged int32
  biases already hold the ``+128 * column_sum(W)`` fold,
  pipeline/tables.py ``_fold_ml``);
* MLP: ``a1 = xc @ W1 + b1`` (int32), relu, ``q1 = clip(a1 >> s1, 0,
  255)``, ``score = (q1 - 128) @ w2 + b2``;
* forest: per level the selected feature (``+128`` restores its uint8
  value) against a threshold gives one bit of the leaf index; the
  trees' leaf votes are summed, plus ``b2``;
* policy: ``flagged = alive & (score > thresh)``; ``drop`` requests
  every flagged packet, ``ratelimit`` the flagged flows whose
  ``tel_flow_hash`` has a nonzero ``rl_shift``-bit low part, ``mark`` /
  ``mirror`` none. With tenancy on, a tenant id per packet (``tid``)
  keys the per-tenant vectors ``glb_ml_tnt_mode`` / ``_thresh``: mode 0
  inherits the global threshold, 1 flags nothing, 2 flags with the
  tenant's threshold but never drops, 3 enforces with it; a threshold
  of ``ML_TNT_THRESH_INHERIT`` is the model's. The compiled stage
  (``ml_stage`` score | enforce) stays the ceiling: under score no
  tenant drops (pipeline/graph.py ``_ml_eval``).

Every int32 sum wraps as the reference's int32 arithmetic does (the
products themselves fit: |a1| < 2^22 at the widest model).

The stage is one kernel on the card: ``ml_stage`` launches
csrc/ml_score.cu (features, centering, the model and the policy in one
launch, one thread a packet) on CUDA tensors and takes its plain version
``ml_stage_plain`` on CPU tensors. The reference computes the stage in
plain ``jnp`` (no Pallas kernel): eager PyTorch would spend ~60-90 small
launches on it, and no exact integer product exists on CUDA (no integer
``matmul``; float products are exact only with TF32 off;
``torch._int_mm`` wants both dimensions in multiples of 8). Every model
value, the threshold, the action and ``rl_shift`` included, is read by
the kernel through a device pointer: a model swap writes them in place,
and a captured step must see the new values.

``ml_features``, ``_centered``, ``_mlp_partial``, ``_forest_partial``,
``ml_score`` and ``ml_policy`` keep the reference's signatures (the
tests hold each against its twin). Not ported: the sharded weight planes
(``shard``, ROADMAP Queue 1 item 10 (Mesh / cluster)).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vpp_tpu_torch.ml.model import ML_FEATURES
from vpp_tpu_torch.ops import _cuda
from vpp_tpu_torch.ops.telemetry import _flow_hash
from vpp_tpu_torch.pipeline.vector import PacketVector, to_i32

# glb_ml_kind values (staged by TableBuilder.set_ml_model; the kernel
# variant is a step gate, re-gated by the Dataplane at every swap)
ML_KIND_NONE = 0
ML_KIND_MLP = 1
ML_KIND_FOREST = 2

# glb_ml_action values (table values: a change is a swap, never a new
# program)
ML_ACTION_MARK = 0
ML_ACTION_DROP = 1
ML_ACTION_RATELIMIT = 2
ML_ACTION_MIRROR = 3

ML_ACTION_NAMES = {
    ML_ACTION_MARK: "mark",
    ML_ACTION_DROP: "drop",
    ML_ACTION_RATELIMIT: "ratelimit",
    ML_ACTION_MIRROR: "mirror",
}

ML_KINDS = ("mlp", "forest")
ML_KIND_NAMES = {ML_KIND_MLP: "mlp", ML_KIND_FOREST: "forest"}


# glb_ml_tnt_mode values (vpp_tpu_torch/tenancy/sched.py ML_MODE_CODES)
# and the glb_ml_tnt_thresh sentinel
ML_TNT_INHERIT = 0
ML_TNT_OFF = 1
ML_TNT_ENFORCE = 3
ML_TNT_THRESH_INHERIT = -(1 << 31)


def _refuse(shard=None) -> None:
    if shard is not None:
        raise NotImplementedError(
            "sharded ML weight planes are not ported to vpp_tpu_torch "
            "yet: ROADMAP Queue 1 item 10 (Mesh / cluster)")


def ml_features(pkts: PacketVector, established: torch.Tensor,
                sess_age: torch.Tensor) -> torch.Tensor:
    """The [P, ML_FEATURES] uint8 feature matrix: src / dst address
    bytes (MSB first), sport and dport bytes, proto, 16-byte length
    buckets (saturating at 255), flags, the session hit (255 / 0), the
    session age (clipped to 0..255) and a reserved 0. Each column is its
    value's low byte, as the reference's uint8 cast keeps it."""
    def b(x, shift):
        return (x >> shift) & 0xFF

    cols = [
        b(pkts.src_ip, 24), b(pkts.src_ip, 16),
        b(pkts.src_ip, 8), b(pkts.src_ip, 0),
        b(pkts.dst_ip, 24), b(pkts.dst_ip, 16),
        b(pkts.dst_ip, 8), b(pkts.dst_ip, 0),
        b(pkts.sport, 8), b(pkts.sport, 0),
        b(pkts.dport, 8), b(pkts.dport, 0),
        pkts.proto & 0xFF,
        torch.clamp(pkts.pkt_len >> 4, max=255) & 0xFF,
        pkts.flags & 0xFF,
        torch.where(established, 255, 0).to(torch.int32),
        torch.clamp(sess_age, 0, 255),
        torch.zeros_like(pkts.proto),
    ]
    return torch.stack(cols, dim=1).to(torch.uint8)


def _centered(feats: torch.Tensor) -> torch.Tensor:
    """uint8 features -> int8 ``x - 128``."""
    return (feats.to(torch.int32) - 128).to(torch.int8)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``x [P, F] @ w [F, H]`` of integer tensors, summed in int64
    (no integer matmul on CUDA)."""
    return (x.to(torch.int64)[:, :, None]
            * w.to(torch.int64)[None, :, :]).sum(dim=1)


def _shr(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``r >> s`` for ``r >= 0`` with XLA's rule past the width: a
    shift of 32 or more (or a negative one, read unsigned) gives 0."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, r >> torch.clamp(s, 0, 31), 0)


def _mlp_partial(tables, xc: torch.Tensor) -> torch.Tensor:
    """The quantized two-layer MLP without the output bias: int32 [P]."""
    a1 = to_i32(_dot(xc, tables.glb_ml_w1)
                + tables.glb_ml_b1.to(torch.int64)[None, :])
    q1 = torch.clamp(_shr(torch.clamp(a1, min=0), tables.glb_ml_s1),
                     0, 255)
    return to_i32(_dot(q1 - 128, tables.glb_ml_w2[:, None])[:, 0])


def _forest_partial(tables, xc: torch.Tensor) -> torch.Tensor:
    """The oblivious forest without the output bias: int32 [P]. A feature
    index outside the vector selects nothing (the reference's one-hot
    product gives 0, so the compare sees 128)."""
    trees, depth = tables.glb_ml_f_feat.shape
    feat = tables.glb_ml_f_feat.reshape(-1)                   # [T*D]
    n_feat = xc.shape[1]
    inside = (feat >= 0) & (feat < n_feat)
    x_sel = torch.where(
        inside[None, :],
        xc.to(torch.int32)[:, torch.clamp(feat, 0, n_feat - 1).long()],
        0) + 128
    bits = x_sel > tables.glb_ml_f_thresh.reshape(-1)[None, :]
    leaf = (bits.reshape(-1, trees, depth).to(torch.int64)
            << torch.arange(depth, device=xc.device)[None, None, :]
            ).sum(dim=2)                                      # [P, T]
    votes = tables.glb_ml_f_leaf[
        torch.arange(trees, device=xc.device)[None, :], leaf]
    return to_i32(votes.to(torch.int64).sum(dim=1))


def ml_score_plain(tables, pkts: PacketVector, established: torch.Tensor,
                   sess_age: torch.Tensor, kind: str = "mlp"
                   ) -> torch.Tensor:
    """Score one packet vector (int32 [P]) in plain PyTorch."""
    xc = _centered(ml_features(pkts, established, sess_age))
    partial = (_forest_partial if kind == "forest" else _mlp_partial)(
        tables, xc)
    return to_i32(partial.to(torch.int64) + tables.glb_ml_b2.to(
        torch.int64))


def ml_policy(tables, pkts: PacketVector, alive: torch.Tensor,
              scores: torch.Tensor, tid=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold scores into (flagged, drop_wanted) masks [P]: flagged alive
    packets score above ``glb_ml_thresh``; ``drop`` requests every
    flagged packet, ``ratelimit`` the flagged flows outside the
    1/2^rl_shift the flow-hash gate admits, mark / mirror nothing.
    ``tid`` ([P] int32 tenant ids) keys the per-tenant mode and
    threshold (module doc)."""
    thresh = tables.glb_ml_thresh
    drop_ok = True
    if tid is not None:
        t = tid.long()
        mode = tables.glb_ml_tnt_mode[t]
        t_thr = tables.glb_ml_tnt_thresh[t]
        thresh = torch.where(t_thr != ML_TNT_THRESH_INHERIT, t_thr, thresh)
        alive = alive & (mode != ML_TNT_OFF)
        drop_ok = (mode == ML_TNT_INHERIT) | (mode == ML_TNT_ENFORCE)
    flagged = alive & (scores > thresh)
    shift = tables.glb_ml_rl_shift.to(torch.int64) & 0xFFFFFFFF
    mask = torch.where(shift >= 32, 0xFFFFFFFF,
                       (torch.ones_like(shift)
                        << torch.clamp(shift, max=31)) - 1)
    rl_admit = (_flow_hash(pkts) & mask) == 0
    action = tables.glb_ml_action
    drop_wanted = flagged & drop_ok & (
        (action == ML_ACTION_DROP)
        | ((action == ML_ACTION_RATELIMIT) & ~rl_admit))
    return flagged, drop_wanted


def ml_stage_plain(tables, pkts: PacketVector, alive: torch.Tensor,
                   established: torch.Tensor, sess_age: torch.Tensor,
                   kind: str = "mlp", tid=None):
    """The plain version of ``ml_stage``: (scores, flagged,
    drop_wanted)."""
    scores = ml_score_plain(tables, pkts, established, sess_age, kind)
    flagged, drop_wanted = ml_policy(tables, pkts, alive, scores, tid=tid)
    return scores, flagged, drop_wanted


# the C entry's argument types (kernels.cuh), the stream last
ML_ARGTYPES = ([ctypes.c_void_p] * 24 + [ctypes.c_int32] * 6
               + [ctypes.c_void_p] * 4)

# the dynamic shared memory a block may take (H100: 227 KB)
ML_SMEM_MAX = 232448

_WEIGHTS = ("glb_ml_w1", "glb_ml_b1", "glb_ml_s1", "glb_ml_w2",
            "glb_ml_b2", "glb_ml_f_feat", "glb_ml_f_thresh",
            "glb_ml_f_leaf", "glb_ml_thresh", "glb_ml_action",
            "glb_ml_rl_shift")


def ml_smem_bytes(kind: str, hidden: int, trees: int, depth: int) -> int:
    """Shared memory of one block: the staged model as int32 words."""
    if kind == "forest":
        return 4 * (2 * trees * depth + trees * (1 << depth))
    return 4 * (ML_FEATURES * hidden + 2 * hidden)


def ml_launch_args(tables, pkts: PacketVector, alive, established,
                   sess_age, kind: str = "mlp", tid=None):
    """The checked arguments of csrc/ml_score.cu's C entry but the
    stream, and the outputs (scores, flagged, drop_wanted) they point
    at. ``tid`` and the per-tenant vectors go by pointer; without
    ``tid`` three nulls (the global policy)."""
    if kind not in ML_KINDS:
        raise ValueError(f"unknown ML kind {kind!r}")
    dev = pkts.src_ip.device
    p = pkts.src_ip.shape[0]
    hdr = (pkts.src_ip, pkts.dst_ip, pkts.proto, pkts.sport, pkts.dport,
           pkts.pkt_len, pkts.flags)
    for v in hdr + (sess_age,):
        _cuda.require(v, "ml_stage.column", ndim=1, device=dev)
    for v in (alive, established):
        _cuda.require(v, "ml_stage.mask", dtype=torch.bool, ndim=1,
                      device=dev)
    if any(v.shape[0] != p for v in hdr + (sess_age, alive, established)):
        raise ValueError("ml_stage: column length mismatch")
    w = {f: getattr(tables, f) for f in _WEIGHTS}
    for f, t in w.items():
        _cuda.require(t, f"ml_stage.{f}",
                      dtype=torch.int8 if f in ("glb_ml_w1", "glb_ml_w2")
                      else torch.int32, device=dev)
    n_feat, hidden = w["glb_ml_w1"].shape
    trees, depth = w["glb_ml_f_feat"].shape
    if n_feat != ML_FEATURES:
        raise ValueError(f"ml_stage: W1 has {n_feat} rows, the kernel "
                         f"computes {ML_FEATURES} features")
    if (tuple(w["glb_ml_b1"].shape) != (hidden,)
            or tuple(w["glb_ml_w2"].shape) != (hidden,)
            or tuple(w["glb_ml_f_thresh"].shape) != (trees, depth)
            or tuple(w["glb_ml_f_leaf"].shape) != (trees, 1 << depth)
            or any(w[f].dim() != 0 for f in (
                "glb_ml_s1", "glb_ml_b2", "glb_ml_thresh", "glb_ml_action",
                "glb_ml_rl_shift"))):
        raise ValueError("ml_stage: model plane shapes disagree")
    if tid is None:
        tnt_args = (None, None, None)
    else:
        modes, threshs = tables.glb_ml_tnt_mode, tables.glb_ml_tnt_thresh
        _cuda.require(tid, "ml_stage.tid", ndim=1, device=dev)
        for f, t in (("glb_ml_tnt_mode", modes),
                     ("glb_ml_tnt_thresh", threshs)):
            _cuda.require(t, f"ml_stage.{f}", ndim=1, device=dev)
        if tid.shape[0] != p or modes.shape != threshs.shape:
            raise ValueError("ml_stage: tenant vector shapes disagree")
        tnt_args = (_cuda.ptr(tid), _cuda.ptr(modes), _cuda.ptr(threshs))
    smem = ml_smem_bytes(kind, hidden, trees, depth)
    if smem > ML_SMEM_MAX:
        raise ValueError(f"ml_stage: the {kind} model needs {smem} bytes "
                         f"of shared memory, over {ML_SMEM_MAX}")
    scores = torch.empty(p, dtype=torch.int32, device=dev)
    flagged = torch.empty(p, dtype=torch.bool, device=dev)
    drop = torch.empty(p, dtype=torch.bool, device=dev)
    args = (*(_cuda.ptr(x) for x in hdr), _cuda.ptr(established),
            _cuda.ptr(sess_age), _cuda.ptr(alive),
            *(_cuda.ptr(w[f]) for f in _WEIGHTS), *tnt_args, p,
            ML_KIND_FOREST if kind == "forest" else ML_KIND_MLP,
            hidden, trees, depth, smem, _cuda.ptr(scores),
            _cuda.ptr(flagged), _cuda.ptr(drop))
    return args, (scores, flagged, drop)


def ml_stage(tables, pkts: PacketVector, alive: torch.Tensor,
             established: torch.Tensor, sess_age: torch.Tensor,
             kind: str = "mlp", tid=None):
    """The ML stage of one packet vector: the kernel of csrc/ml_score.cu
    on CUDA tensors (features, model and policy in one launch), the
    plain version on CPU tensors. ``pkts`` is the post-NAT-reverse
    header, ``established`` / ``sess_age`` the session hit and its
    pre-touch age, ``tables`` anything holding the ``glb_ml_*`` planes,
    ``tid`` None or the [P] tenant ids of the per-tenant policy.
    Returns (scores int32 [P], flagged bool [P], drop_wanted bool
    [P])."""
    if not _cuda.use_kernels(pkts.src_ip):
        return ml_stage_plain(tables, pkts, alive, established, sess_age,
                              kind, tid)
    args, out = ml_launch_args(tables, pkts, alive, established, sess_age,
                               kind, tid)
    fn = _cuda.library("ml_score").ml_score
    fn.argtypes = ML_ARGTYPES
    fn.restype = ctypes.c_int
    _cuda.check(fn(*args, _cuda.stream()), "ml_stage")
    ml_stage.launches += 1
    return out


ml_stage.launches = 0


def ml_score(tables, pkts: PacketVector, established: torch.Tensor,
             sess_age: torch.Tensor, kind: str = "mlp",
             shard=None) -> torch.Tensor:
    """Score one packet vector: int32 [P] (the reference's signature;
    on CUDA tensors through the ``ml_stage`` kernel)."""
    _refuse(shard=shard)
    alive = torch.ones_like(established)
    return ml_stage(tables, pkts, alive, established, sess_age, kind)[0]
