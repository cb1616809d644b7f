"""The port's static-analysis gate: project passes over
``vpp_tpu_torch/`` for the hazards the CPU tests cannot see, the
counterpart of the reference's ``tools/analysis/`` rewritten for torch
tensors, CUDA-graph capture and ctypes kernel wrappers. Standard-library
``ast`` code: it imports neither the reference nor its tools, and only
the registry passes import the port.

Run ``python -m vpp_tpu_torch.analysis [--capture] [--threads]
[--uploads] [--transfers] [--kernels] [--tables] [--all]``: the style
pass always runs; the command exits 1 when anything fires.

Rule catalog (pass, rule: the hazard it guards):

* style (imports.py, over ``vpp_tpu_torch/``, ``tests/test_torch_*.py``
  and ``chip_smoke.py``): the file parses; unused import; bare
  ``except:``; tab indentation; trailing whitespace; mutable default
  argument; ``== True / False / None``.
* ``--capture`` (capturelint.py, the manifest capture_manifest.py):
  ``capture-unregistered`` / ``capture-manifest-stale`` — every
  ``capture.Part`` and ``torch.cuda.graph`` / ``CUDAGraph`` site is a
  reviewed ``CAPTURE_SITES`` entry; ``host-sync`` — a device-to-host
  read in code a part captures (fails the capture on the card, or
  replays a stale value); ``tensor-branch`` — Python control flow on a
  tensor there (a replay never re-takes the branch);
  ``float-literal-dtype`` — float64 drift in the step;
  ``lru-cache-method`` and ``unhashable-arg`` — memoization hazards.
* ``--threads`` (threadlint.py): ``unlocked-access`` — lock-protected
  state touched without its lock; ``lock-order`` — two locks taken in
  both orders.
* ``--uploads`` (uploadlint.py, upload_manifest.py):
  ``upload-field-unplaced`` / ``-multi`` / ``upload-group-stale`` /
  ``upload-manifest-missing`` / ``-stale`` / ``-mismatch`` — every
  table field ships exactly one reviewed way; ``upload-mark-missing`` —
  a staged write that does not mark its group (a stale device plane);
  ``upload-dirty-field-foreign``, ``upload-extern-write``,
  ``upload-exempt-stale``.
* ``--transfers`` (transferlint.py, transfer_manifest.py):
  ``transfer-host-fetch`` — table state read back to the host outside
  an approved drain; ``transfer-site-stale``.
* ``--kernels`` (registries.py): the kernel table ``KERNELS`` against
  the tree — one entry per ``csrc/*.cu``, each wrapper, plain version,
  dispatch root, knob, rung and operand field real, its knob refused on
  a rule-sharded mesh unless the entry says the mesh runs it (or its
  sharded plain version), every ``_cuda.library(...)`` call a registered
  wrapper, ``capture.WRAPPERS`` the manifest's wrappers.
* ``--tables`` (registries.py): the builder's BV, LPM, ECMP, derived
  kernel operand and service plane invariants.

Suppression syntax: ``# capture-ok: <reason>``, ``# unlocked:
<reason>``, ``# upload-ok: <reason>`` or ``# transfer-ok: <reason>`` on
the flagged line, or as the last line of a comment block right above it;
``# noqa`` for the style pass. A suppression without a reason is itself
a finding (``bare-suppression``).
"""

from vpp_tpu_torch.analysis.capturelint import capture_lint
from vpp_tpu_torch.analysis.common import (
    Finding,
    SourceCache,
    iter_source_files,
    parse_suppressions,
)
from vpp_tpu_torch.analysis.imports import style_lint, style_problems
from vpp_tpu_torch.analysis.threadlint import threads_lint
from vpp_tpu_torch.analysis.transferlint import transfers_lint
from vpp_tpu_torch.analysis.uploadlint import uploads_lint

__all__ = [
    "Finding",
    "SourceCache",
    "capture_lint",
    "iter_source_files",
    "parse_suppressions",
    "style_lint",
    "style_problems",
    "threads_lint",
    "transfers_lint",
    "uploads_lint",
]
