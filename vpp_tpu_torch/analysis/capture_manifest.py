"""The capture manifest: every place the port captures a CUDA graph, the
functions those graphs run that the AST cannot resolve, and the kernel
table.

``CAPTURE_SITES`` — ``(path, enclosing scope, what) -> reason``: each
``capture.Part(...)`` (``what``: its function argument as written) and
each ``torch.cuda.graph(...)`` / ``torch.cuda.CUDAGraph(...)`` call.
The capture pass (capturelint.py) fails on a site missing here and on
an entry that no longer matches a call. A new captured part is a
reviewed decision: what it runs is replayed without Python from then
on.

``CAPTURED_ROOTS`` — ``(path, def qualname)`` of functions a part runs
through an expression the AST cannot follow (``step.full(...)``, a
classifier rung chosen by ``_classifier_fns``, a cluster step's
method): where the host-sync and tensor-branch rules start their
closure besides the sites' own functions.

``KERNELS`` — one entry per ``csrc/*.cu``, the counterpart of the
reference's ``PALLAS_KERNELS`` (tools/analysis/jit_manifest.py): the
library and C symbol; the wrapper that counts its launches and its
plain PyTorch version; the dispatch root that calls the wrapper on the
main path; the config knob and the values that select it and the
``Dataplane`` attribute that reports the resolved rung (``rung``); the
``DataplaneTables`` fields its operands are built from; what a
rule-sharded mesh does with it (``mesh``: ``refused`` — the knob value
fails ``validate_partitioning``; ``runs`` — the mesh launches it on
each shard's block; ``sharded-plain`` — the knob is accepted and the
mesh runs its sharded plain version instead); the reference's Pallas
entry it ports (``pallas``, None for ``ml_score``, whose reference is
plain ``jnp``) and the TPU kernel's ``file:line`` (``replaces``).
``capture.WRAPPERS`` and ``chip_smoke.py``'s build step read it; the
``kernels`` registry pass (registries.py) holds it against the tree.

The reference's donation registry has no counterpart: torch has no
buffer donation, and the port writes its live tensors in place by
design (the captured graphs hold their addresses).
"""

from typing import Dict, FrozenSet, Tuple

CAPTURE = "vpp_tpu_torch/pipeline/capture.py"
CLUSTER = "vpp_tpu_torch/parallel/cluster.py"
GRAPH = "vpp_tpu_torch/pipeline/graph.py"

CAPTURE_SITES: Dict[Tuple[str, str, str], str] = {
    (CAPTURE, "Part._capture", "torch.cuda.CUDAGraph"):
        "THE graph of a part: one per (label, signature), kept with its "
        "static outputs; keep_graph only when the nodes are dumped",
    (CAPTURE, "Part._capture", "torch.cuda.graph"):
        "THE capture of a part, in thread_local mode with the cyclic "
        "collector off, right after the part's eager warm-up call",
    (CAPTURE, "Program.__init__", "prefix"):
        "the auto path's dispatch prefix (ends in the flag the host "
        "reads between the prefix and the chosen tier)",
    (CAPTURE, "Program.__init__", "fast"):
        "the auto path's fast tier over the prefix's outputs",
    (CAPTURE, "Program.__init__", "full"):
        "the forced full chain (plain, packed or K-chain form), or the "
        "auto path's full tier over the prefix's outputs",
    (CLUSTER, "ClusterProgram.__init__.part", "fn"):
        "every part of a cluster step: the whole step, its pass 1 / "
        "pass 2 halves around a cross-process swap, the prefixes and "
        "the per-node tiers of the auto path",
}

CAPTURED_ROOTS: FrozenSet[Tuple[str, str]] = frozenset({
    # what a make_pipeline_step step hands a program: step.full,
    # step.prefix, step.fast and step.slow (functools.partial objects)
    (GRAPH, "pipeline_step"),
    (GRAPH, "pipeline_step_fast"),
    (GRAPH, "auto_prefix"),
    (GRAPH, "auto_fast"),
    (GRAPH, "auto_full"),
    # the packed boundary and the result buffers a part ends in
    (GRAPH, "packed_vector"),
    (GRAPH, "tel_observe"),
    (GRAPH, "packed_fields"),
    (GRAPH, "result_fields"),
    (GRAPH, "result_of"),
    (CAPTURE, "Program._encode"),
    (CAPTURE, "encode_observed"),
    (CAPTURE, "_decoder"),
    (CAPTURE, "Packing.pack"),
    (CAPTURE, "Packing.unpack"),
    # the classifier and FIB rungs (_classifier_fns / _fib_fn hand them
    # to the step as acl_global_fn, acl_local_fn and fib_fn)
    ("vpp_tpu_torch/ops/acl.py", "acl_classify_global"),
    ("vpp_tpu_torch/ops/acl.py", "acl_classify_local"),
    ("vpp_tpu_torch/ops/acl.py", "acl_local_none"),
    ("vpp_tpu_torch/ops/acl_mxu.py", "acl_classify_global_mxu"),
    ("vpp_tpu_torch/ops/acl_bv.py", "acl_classify_global_bv"),
    ("vpp_tpu_torch/ops/acl_bv.py", "acl_classify_local_bv"),
    ("vpp_tpu_torch/ops/acl_bv.py", "acl_classify_global_pallas"),
    ("vpp_tpu_torch/ops/acl_bv.py", "acl_classify_local_pallas"),
    ("vpp_tpu_torch/ops/fib.py", "fib_lookup_dense"),
    ("vpp_tpu_torch/ops/lpm.py", "fib_lookup_lpm"),
    ("vpp_tpu_torch/ops/lpm.py", "fib_lookup_lpm_fused"),
    # the cluster step: its passes, its pack and unpack, the staged
    # pass results, and the rule-sharded global classify rungs
    (CLUSTER, "ClusterStep.run_pass"),
    (CLUSTER, "ClusterStep.prefixes"),
    (CLUSTER, "ClusterStep.tier"),
    (CLUSTER, "ClusterStep.pack"),
    (CLUSTER, "ClusterStep.unpack"),
    (CLUSTER, "_Staged.put"),
    (CLUSTER, "_Staged.get"),
    (CLUSTER, "sharded_global_classify"),
    (CLUSTER, "sharded_global_classify_mxu"),
    (CLUSTER, "sharded_global_classify_bv"),
})

_SESS_FIELDS = ("sess_valid", "sess_src", "sess_dst", "sess_ports",
                "sess_proto", "sess_time")
_BV_DIMS = ("bnd_src", "bnd_dst", "bnd_sport", "bnd_dport", "nbnd", "src",
            "dst", "sport", "dport", "proto")

KERNELS: Dict[str, dict] = {
    "sess_probe_ways": dict(
        source="vpp_tpu_torch/csrc/sess_probe.cu",
        library="sess_probe", symbol="sess_probe_ways",
        module="vpp_tpu_torch/ops/session.py",
        wrapper="sess_probe_ways", plain="sess_probe_reverse_plain",
        root=("vpp_tpu_torch/ops/session.py", "session_lookup_reverse_idx"),
        knob="session_impl", values=("pallas",), rung="session_impl",
        fields=_SESS_FIELDS + ("sess_max_age",),
        mesh="refused",
        pallas=("vpp_tpu/ops/session.py", "@sess_probe_ways"),
        replaces="vpp_tpu/ops/session.py:1032"),
    "bv_first_set": dict(
        source="vpp_tpu_torch/csrc/bv_first_set.cu",
        library="bv_first_set", symbol="bv_first_set",
        module="vpp_tpu_torch/ops/acl_bv.py",
        wrapper="bv_first_set", plain="bv_search_first_set_plain",
        root=("vpp_tpu_torch/ops/acl_bv.py", "acl_classify_global_pallas"),
        knob="classifier", values=("pallas",), rung="classifier_impl",
        fields=tuple(f"glb_bv_{d}" for d in _BV_DIMS)
        + tuple(f"acl_bv_{d}" for d in _BV_DIMS) + ("if_local_table",),
        mesh="refused",
        pallas=("vpp_tpu/ops/acl_bv.py", "@bv_first_set"),
        replaces="vpp_tpu/ops/acl_bv.py:449"),
    "lpm_fused_lookup": dict(
        source="vpp_tpu_torch/csrc/lpm_lookup.cu",
        library="lpm_lookup", symbol="lpm_fused_lookup",
        module="vpp_tpu_torch/ops/lpm.py",
        wrapper="lpm_fused_lookup", plain="lpm_fused_lookup_plain",
        root=("vpp_tpu_torch/ops/lpm.py", "fib_lookup_lpm_fused"),
        knob="fib_impl", values=("pallas",), rung="fib_impl",
        fields=("fib_lpm_lens", "fib_lpm_stk_cnt", "fib_lpm_stk_pfx",
                "fib_lpm_stk_slot"),
        mesh="refused",
        pallas=("vpp_tpu/ops/lpm.py", "@lpm_fused_lookup"),
        replaces="vpp_tpu/ops/lpm.py:372"),
    "mxu_first_match": dict(
        source="vpp_tpu_torch/csrc/mxu_first_match.cu",
        library="mxu_first_match", symbol="mxu_first_match",
        module="vpp_tpu_torch/ops/acl_mxu.py",
        wrapper="mxu_first_match", plain="mxu_first_match_plain",
        root=("vpp_tpu_torch/ops/acl_mxu.py", "mxu_classify_columns"),
        knob="classifier", values=("mxu",), rung="classifier_impl",
        fields=("glb_mxu_op",),
        mesh="runs",
        pallas=("vpp_tpu/ops/acl_mxu.py", "@mxu_first_match"),
        replaces="vpp_tpu/ops/acl_mxu.py:246"),
    "ml_score": dict(
        source="vpp_tpu_torch/csrc/ml_score.cu",
        library="ml_score", symbol="ml_score",
        module="vpp_tpu_torch/ops/mlscore.py",
        wrapper="ml_stage", plain="ml_stage_plain",
        root=(GRAPH, "_ml_eval"),
        knob="ml_stage", values=("score", "enforce"), rung="_ml_mode",
        fields=("glb_ml_w1", "glb_ml_b1", "glb_ml_s1", "glb_ml_w2",
                "glb_ml_b2", "glb_ml_f_feat", "glb_ml_f_thresh",
                "glb_ml_f_leaf", "glb_ml_thresh", "glb_ml_action",
                "glb_ml_rl_shift", "glb_ml_tnt_mode", "glb_ml_tnt_thresh"),
        mesh="sharded-plain",
        pallas=None,
        replaces="vpp_tpu/ops/mlscore.py:167"),
}


def module_name(path: str) -> str:
    """The import name of a repo-relative ``.py`` path."""
    return path[:-3].replace("/", ".")
