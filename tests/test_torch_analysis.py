"""The port's static-analysis gate (``vpp_tpu_torch/analysis/``).

* Each pass is clean on the tree: style, capture, threads, uploads,
  transfers, kernels and tables (the parses shared through one
  module-scoped cache).
* Every rule that has a counterpart in the reference's gate
  (tests/test_analysis.py) fires on a torch fixture and is silenced by
  its suppression with a reason; a suppression without one is itself a
  finding.
* Four seeded mutations of copies of the real files fire: a ``.item()``
  in ``_finish_step``, a branch on a counter in ``pipeline_step``, the
  ``glb`` mark dropped from ``set_global_table``, and a ``with
  self._lock`` dropped from ``Dataplane``.
* ``KERNELS``' Pallas column equals the keys of the reference's
  ``PALLAS_KERNELS`` (tools/analysis/jit_manifest.py, loaded by path).
* ``python -m vpp_tpu_torch.analysis --all`` exits 0 on the tree and 1
  on a fixture.
* The thread triage's two repairs: ``encap_remote`` and
  ``time_classifier`` read the state ``set_vtep`` and ``add_uplink``
  write under ``Dataplane._lock`` under that lock.
"""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from vpp_tpu_torch.analysis import capture_manifest
from vpp_tpu_torch.analysis.__main__ import main as analysis_main
from vpp_tpu_torch.analysis.capturelint import capture_lint
from vpp_tpu_torch.analysis.common import SourceCache, parse_suppressions
from vpp_tpu_torch.analysis.imports import style_lint, style_problems
from vpp_tpu_torch.analysis.registries import kernels_lint, tables_lint
from vpp_tpu_torch.analysis.threadlint import threads_lint
from vpp_tpu_torch.analysis.transferlint import transfers_lint
from vpp_tpu_torch.analysis.uploadlint import uploads_lint

REPO = Path(__file__).resolve().parent.parent
MOD = "pkg/m.py"
# a capture site of the fixtures: a Part of `kernel` at module level
SITE = {(MOD, "<module>", "kernel"): "test fixture"}


@pytest.fixture(scope="module")
def cache():
    return SourceCache()


def rules_of(findings):
    return sorted({f.rule for f in findings})


def _write(tmp_path, src, name="m.py"):
    (tmp_path / "pkg").mkdir(exist_ok=True)
    (tmp_path / "pkg" / name).write_text(src)


def run_capture(tmp_path, src, sites=None, roots=None):
    _write(tmp_path, src)
    return capture_lint(tmp_path, roots=("pkg",),
                        sites=SITE if sites is None else sites,
                        captured_roots=roots if roots is not None else set())


def run_threads(tmp_path, src):
    _write(tmp_path, src)
    return threads_lint(tmp_path, roots=("pkg",))


# --- the tree is clean ---------------------------------------------------

def test_style_clean_tree(cache):
    assert style_lint(REPO, cache=cache) == []


def test_capture_clean_tree(cache):
    assert [str(f) for f in capture_lint(REPO, cache=cache)] == []


def test_threads_clean_tree(cache):
    assert [str(f) for f in threads_lint(REPO, cache=cache)] == []


def test_uploads_clean_tree(cache):
    assert [str(f) for f in uploads_lint(REPO, cache=cache)] == []


def test_transfers_clean_tree(cache):
    assert [str(f) for f in transfers_lint(REPO, cache=cache)] == []


def test_kernels_clean_tree(cache):
    assert kernels_lint(REPO, cache=cache) == []


def test_tables_clean_tree():
    assert tables_lint() == []


# --- suppressions --------------------------------------------------------

def test_bare_suppression_is_a_finding(tmp_path):
    src = "import threading\n# unlocked:\nX = 1\n"
    assert "bare-suppression" in rules_of(run_threads(tmp_path, src))
    assert "bare-suppression" in rules_of(
        run_capture(tmp_path, "# capture-ok\nX = 1\n", sites={}))


def test_comment_block_suppression_covers_next_code_line():
    sup = parse_suppressions(
        "x = 1\n# capture-ok: spans the block\n# more words\ny = 2\n")
    assert 2 in sup.capture and 4 in sup.capture and 1 not in sup.capture


def test_suppression_token_in_string_literal_ignored():
    sup = parse_suppressions('HELP = "annotate with # capture-ok: reason"\n'
                             'MSG = "see # unlocked"\n')
    assert sup.capture == {} and sup.unlocked == {} and sup.problems == []


# --- --capture: a firing and a suppressed fixture per rule ---------------

PART = "from capture import Part\np = Part('k', (), kernel, True)\n"


def _kernel(body, head="import torch\n"):
    return head + "def kernel(x):\n" + body + PART


def test_capture_host_sync_item(tmp_path):
    src = _kernel("    return x.item(){sup}\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["host-sync"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: test probe")) == []


def test_capture_host_sync_int_of_tensor(tmp_path):
    src = _kernel("    y = torch.sum(x)\n    return int(y){sup}\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["host-sync"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: diagnostics")) == []
    # int() of a host value is no finding
    good = _kernel("    n = int(x.shape[0])\n    return x[:n]\n")
    assert run_capture(tmp_path, good) == []


def test_capture_host_sync_np_asarray(tmp_path):
    head = "import numpy as np\nimport torch\n"
    src = _kernel("    z = torch.abs(x)\n    return np.asarray(z){sup}\n",
                  head)
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["host-sync"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: boundary copy")) == []
    # np.asarray of host constants is no finding
    good = _kernel("    w = np.asarray([1, 2, 3])\n    return x + 1\n", head)
    assert run_capture(tmp_path, good) == []


@pytest.mark.parametrize("expr", [
    "x.tolist()", "x.cpu()", "x.numpy()", 'x.to("cpu")', "torch.nonzero(x)",
    "x.nonzero()", "torch.unique(x)", "torch.masked_select(x, x > 0)",
    "torch.cuda.synchronize()", "x[x > 0]", "x[m & (x < 3)]",
])
def test_capture_host_sync_torch_sinks(tmp_path, expr):
    src = _kernel("    m = x != 0\n    return " + expr + "{sup}\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["host-sync"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: a fixture")) == []


def test_capture_tensor_branch(tmp_path):
    src = _kernel("    if x > 0:{sup}\n        return x\n    return -x\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["tensor-branch"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: an eager-only path")) == []
    # `is None` is static
    good = ("import torch\n"
            "def kernel(x, now=None):\n"
            "    if now is not None:\n"
            "        x = x + now\n"
            "    return x\n" + PART)
    assert run_capture(tmp_path, good) == []


def test_capture_tensor_while(tmp_path):
    src = _kernel("    while torch.any(x > 0):{sup}\n        x = x - 1\n"
                  "    return x\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["tensor-branch"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: bounded probe")) == []


@pytest.mark.parametrize("body", [
    "    return 1 if x.sum() else 0{sup}\n",
    "    return (x > 0) or x{sup}\n",
    "    assert x.all(){sup}\n    return x\n",
])
def test_capture_tensor_branch_forms(tmp_path, body):
    src = _kernel(body)
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["tensor-branch"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: a fixture")) == []


def test_capture_static_tests_are_no_findings(tmp_path):
    """Shapes, dtypes, scalar gates, a container's truth and the branch
    where ``torch.is_tensor`` ruled a tensor out are static."""
    good = ("import torch\n"
            "def kernel(x, v, mode: str = 'off', k=4,\n"
            "           parts: list = None):\n"
            "    if x.shape[0] > 2 and x.dtype == torch.int32:\n"
            "        x = x + 1\n"
            "    if mode != 'off' or k > 2:\n"
            "        x = x * 2\n"
            "    ys = [t + 1 for t in (x, x)]\n"
            "    if ys and parts:\n"
            "        x = x + ys[0]\n"
            "    if torch.is_tensor(v):\n"
            "        return x + v\n"
            "    return x + int(v)\n" + PART)
    assert run_capture(tmp_path, good) == []


def test_capture_except_handler_is_captured_code(tmp_path):
    src = _kernel("    try:\n        y = torch.sum(x)\n"
                  "    except ValueError:\n        return x.item()\n"
                  "    return y\n")
    assert rules_of(run_capture(tmp_path, src)) == ["host-sync"]


def test_capture_closure_reaches_helpers(tmp_path):
    """The closure follows a def, a factory hop (``part(name, fn)``)
    and ``self.m``: the sync two calls down is found."""
    src = ("import torch\n"
           "from capture import Part\n"
           "def helper(x):\n"
           "    return x.item()\n"
           "class Prog:\n"
           "    def __init__(self):\n"
           "        def part(name, fn):\n"
           "            return Part(name, (), fn, True)\n"
           "        def body(x):\n"
           "            return self.tail(x)\n"
           "        self.p = part('b', body)\n"
           "    def tail(self, x):\n"
           "        return helper(x)\n")
    site = {(MOD, "Prog.__init__.part", "fn"): "fixture"}
    f = run_capture(tmp_path, src, sites=site)
    assert rules_of(f) == ["host-sync"] and f[0].line == 4


def test_capture_unregistered(tmp_path):
    src = _kernel("    return x\n").replace("True)\n", "True){sup}\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""), sites={})) == \
        ["capture-unregistered"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: scratch experiment"), sites={}) == []
    graph = "import torch\ng = torch.cuda.CUDAGraph()\n"
    assert rules_of(run_capture(tmp_path, graph, sites={})) == \
        ["capture-unregistered"]


def test_capture_manifest_stale(tmp_path):
    src = "import torch\nX = 1\n"
    gone = {(MOD, "gone_factory", "fn"): "was removed"}
    assert rules_of(run_capture(tmp_path, src, sites=gone)) == \
        ["capture-manifest-stale"]
    assert rules_of(run_capture(tmp_path, src, sites={},
                                roots={(MOD, "gone_kernel")})) == \
        ["capture-manifest-stale"]
    # a stale entry anchors at line 1 of its module: suppressible
    assert run_capture(tmp_path, "# capture-ok: moving\nX = 1\n",
                       sites=gone) == []


def test_capture_float_literal_dtype(tmp_path):
    src = _kernel("    return x * torch.full((4,), 0.5){sup}\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""))) == \
        ["float-literal-dtype"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: f32-only")) == []
    good = _kernel("    return x * torch.full((4,), 0.5, "
                   "dtype=torch.float32)\n")
    assert run_capture(tmp_path, good) == []
    f64 = _kernel("    return x.to(torch.float64)\n")
    assert rules_of(run_capture(tmp_path, f64)) == ["float-literal-dtype"]


def test_capture_lru_cache_method(tmp_path):
    src = ("import functools\n"
           "class A:\n"
           "    @functools.lru_cache(maxsize=None)\n"
           "    def step(self, n):{sup}\n"
           "        return n\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""), sites={})) \
        == ["lru-cache-method"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: a singleton"), sites={}) == []


def test_capture_unhashable_arg(tmp_path):
    src = ("import functools\n"
           "@functools.lru_cache(maxsize=None)\n"
           "def make(key):\n"
           "    return key\n"
           "make([1, 2]){sup}\n")
    assert rules_of(run_capture(tmp_path, src.format(sup=""), sites={})) \
        == ["unhashable-arg"]
    assert run_capture(tmp_path, src.format(
        sup="  # capture-ok: raises in a test"), sites={}) == []
    good = src.replace("make([1, 2]){sup}\n", "make((1, 2))\n")
    assert run_capture(tmp_path, good, sites={}) == []


# --- --threads -------------------------------------------------------------

UNLOCKED = """\
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
    def inc(self):
        with self._lock:
            self.n += 1
    def peek(self):
        return self.n{sup}
"""


def test_threads_unlocked_access(tmp_path):
    bad = run_threads(tmp_path, UNLOCKED.format(sup=""))
    assert rules_of(bad) == ["unlocked-access"] and "C.n" in str(bad[0])
    assert run_threads(tmp_path, UNLOCKED.format(
        sup="  # unlocked: monotonic counter peek")) == []


def test_threads_subscripted_access_still_seen(tmp_path):
    src = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self._buf = [0]\n"
           "    def put(self):\n"
           "        with self._lock:\n"
           "            self._buf = [1]\n"
           "    def peek(self):\n"
           "        return self._buf[0].bit_length()\n")
    bad = run_threads(tmp_path, src)
    assert rules_of(bad) == ["unlocked-access"] and "C._buf" in str(bad[0])


def test_threads_unlocked_write(tmp_path):
    src = UNLOCKED.format(sup="") + ("    def reset(self):\n"
                                     "        self.n = 0\n")
    assert any("write in reset()" in str(f)
               for f in run_threads(tmp_path, src))


def test_threads_locked_suffix_and_init_exempt(tmp_path):
    good = ("import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.n = 0\n"
            "    def inc(self):\n"
            "        with self._lock:\n"
            "            self.n += 1\n"
            "    def _drain_locked(self):\n"
            "        return self.n\n")
    assert run_threads(tmp_path, good) == []


def test_threads_closure_resets_held_locks(tmp_path):
    src = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self.n = 0\n"
           "    def go(self):\n"
           "        with self._lock:\n"
           "            self.n += 1\n"
           "            def worker():\n"
           "                return self.n\n"
           "            return worker\n")
    assert rules_of(run_threads(tmp_path, src)) == ["unlocked-access"]


LOCK_ORDER = """\
import threading
class D:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
    def f(self):
        with self._a:
            with self._b:{sup}
                pass
    def g(self):
        with self._b:
            with self._a:
                pass
"""


def test_threads_lock_order(tmp_path):
    assert rules_of(run_threads(tmp_path, LOCK_ORDER.format(sup=""))) == \
        ["lock-order"]
    assert run_threads(tmp_path, LOCK_ORDER.format(
        sup="  # unlocked: g() is shutdown-only")) == []
    consistent = LOCK_ORDER.format(sup="").replace(
        "with self._b:\n            with self._a:",
        "with self._a:\n            with self._b:")
    assert run_threads(tmp_path, consistent) == []


def test_threads_lock_alias_is_the_lock(tmp_path):
    """``commit_lock = self._lock`` (the Dataplane idiom): holding the
    alias is holding the lock."""
    src = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.RLock()\n"
           "        self.commit_lock = self._lock\n"
           "        self.n = 0\n"
           "    def inc(self):\n"
           "        with self._lock:\n"
           "            self.n += 1\n"
           "    def inc2(self):\n"
           "        with self.commit_lock:\n"
           "            self.n += 1\n")
    assert run_threads(tmp_path, src) == []


# --- --uploads -------------------------------------------------------------

TBL = "pkg/tables.py"
MINI_HEAD = '''\
_ACL = ("acl_rules", "acl_count")
_UPLOAD_GROUPS = {
    "acl": _ACL,
    "fib": ("fib_next_hop",),
}
SESSION_FIELDS = {"sess_key0": "u32"}
DERIVED_GROUPS = {"fib_stack": "fib"}
TABLE_FIELDS = _ACL + ("fib_next_hop",) + tuple(SESSION_FIELDS) \\
    + tuple(DERIVED_GROUPS)


class TableBuilder:
    def __init__(self):
        self.acl = []
        self.fib_next_hop = {}
        self._dirty = set(_UPLOAD_GROUPS)
        self._fib_dirty = set()

    def add_rule(self, r):
        self.acl.append(r)
        self._mark("acl")

    def _mark(self, group):
        self._dirty.add(group)
'''
MINI_PLACEMENTS = {"acl_rules": "group:acl", "acl_count": "group:acl",
                   "fib_next_hop": "group:fib",
                   "sess_key0": "ledger:SESSION_FIELDS",
                   "fib_stack": "derived:fib"}
MINI_STAGED = {"acl": "acl", "fib_next_hop": "fib"}


def _upload_ns(placements=None, staged=None, exempt=None):
    return SimpleNamespace(
        FIELD_PLACEMENTS=dict(MINI_PLACEMENTS if placements is None
                              else placements),
        STAGED_ATTRS=dict(MINI_STAGED if staged is None else staged),
        EXEMPT_METHODS=dict(exempt or {}))


def _mini(body):
    return MINI_HEAD + "\n" + body


def run_uploads(tmp_path, tables_src, extra="", manifest=None):
    _write(tmp_path, tables_src, "tables.py")
    _write(tmp_path, extra, "other.py")
    return uploads_lint(tmp_path, tables_rel=TBL, roots=("pkg",),
                        manifest=manifest or _upload_ns())


def test_upload_mini_fixture_clean(tmp_path):
    body = ("    def set_route(self, i, nh):\n"
            "        self.fib_next_hop[i] = nh\n"
            "        self._mark(\"fib\")\n")
    assert run_uploads(tmp_path, _mini(body)) == []


def test_upload_mark_missing_fires(tmp_path):
    body = ("    def set_route(self, i, nh):\n"
            "        self.fib_next_hop[i] = nh\n")
    f = run_uploads(tmp_path, _mini(body))
    assert rules_of(f) == ["upload-mark-missing"] and "'fib'" in str(f[0])


def test_upload_mark_missing_suppressed(tmp_path):
    body = ("    def set_route(self, i, nh):\n"
            "        self.fib_next_hop[i] = nh  # upload-ok: fixture\n")
    assert run_uploads(tmp_path, _mini(body)) == []


def test_upload_mark_on_one_branch_only(tmp_path):
    body = ("    def set_route(self, i, nh, flag):\n"
            "        self.fib_next_hop[i] = nh\n"
            "        if flag:\n"
            "            self._mark(\"fib\")\n")
    assert rules_of(run_uploads(tmp_path, _mini(body))) == \
        ["upload-mark-missing"]


def test_upload_raise_path_not_counted(tmp_path):
    body = ("    def set_route(self, i, nh):\n"
            "        self.fib_next_hop[i] = nh\n"
            "        if i < 0:\n"
            "            raise ValueError(i)\n"
            "        self._mark(\"fib\")\n")
    assert run_uploads(tmp_path, _mini(body)) == []


def test_upload_mark_all_assignment(tmp_path):
    body = ("    def reset(self):\n"
            "        self.fib_next_hop = {}\n"
            "        self.acl = []\n"
            "        self._dirty = set(_UPLOAD_GROUPS)\n")
    assert run_uploads(tmp_path, _mini(body)) == []


def test_upload_dirty_field_foreign(tmp_path):
    body = ("    def poke(self):\n"
            "        self._fib_dirty.add(\"acl_rules\")\n")
    assert rules_of(run_uploads(tmp_path, _mini(body))) == \
        ["upload-dirty-field-foreign"]
    good = ("    def poke(self):\n"
            "        self._fib_dirty.add(\"fib_next_hop\")\n")
    assert run_uploads(tmp_path, _mini(good)) == []


def test_upload_field_unplaced(tmp_path):
    src = _mini("    pass\n").replace('+ tuple(DERIVED_GROUPS)',
                                     '+ tuple(DERIVED_GROUPS) + ("orphan",)')
    rules = rules_of(run_uploads(tmp_path, src))
    assert "upload-field-unplaced" in rules
    assert "upload-manifest-missing" in rules


def test_upload_field_multi(tmp_path):
    src = _mini("    pass\n").replace('"fib": ("fib_next_hop",),',
                                     '"fib": ("fib_next_hop", "acl_rules"),')
    assert rules_of(run_uploads(tmp_path, src)) == ["upload-field-multi"]


def test_upload_group_stale(tmp_path):
    src = _mini("    pass\n").replace('"fib": ("fib_next_hop",),',
                                     '"fib": ("fib_next_hop", "ghost"),')
    assert rules_of(run_uploads(tmp_path, src)) == ["upload-group-stale"]
    # a derived field must follow an upload group
    src = _mini("    pass\n").replace('{"fib_stack": "fib"}',
                                     '{"fib_stack": "nowhere"}')
    man = _upload_ns(placements={**MINI_PLACEMENTS,
                                 "fib_stack": "derived:nowhere"})
    assert rules_of(run_uploads(tmp_path, src, manifest=man)) == \
        ["upload-group-stale"]


def test_upload_manifest_stale_and_mismatch(tmp_path):
    man = _upload_ns(placements={**MINI_PLACEMENTS, "ghost": "group:acl",
                                 "fib_next_hop": "group:acl"})
    f = run_uploads(tmp_path, _mini("    pass\n"), manifest=man)
    assert rules_of(f) == ["upload-manifest-mismatch",
                           "upload-manifest-stale"]


def test_upload_exempt_stale(tmp_path):
    f = run_uploads(tmp_path, _mini("    pass\n"),
                    manifest=_upload_ns(exempt={"gone": "was removed"}))
    assert rules_of(f) == ["upload-exempt-stale"]


def test_upload_extern_write(tmp_path):
    extra = "def hack(dp):\n    dp.builder.acl[0] = 1\n"
    assert rules_of(run_uploads(tmp_path, _mini("    pass\n"),
                                extra=extra)) == ["upload-extern-write"]
    ok = ("def hack(dp):\n"
          "    dp.builder.acl[0] = 1  # upload-ok: fixture\n")
    assert run_uploads(tmp_path, _mini("    pass\n"), extra=ok) == []


def test_upload_reads_the_ports_field_set(cache):
    """The static evaluator reads TABLE_FIELDS as the module builds it:
    179 fields, the LPM planes from ops/lpm.py's f-string among them."""
    from vpp_tpu_torch.analysis.upload_manifest import FIELD_PLACEMENTS
    from vpp_tpu_torch.pipeline.tables import TABLE_FIELDS

    assert list(FIELD_PLACEMENTS) == list(TABLE_FIELDS)
    assert FIELD_PLACEMENTS["fib_lpm_p17"] == "group:fib"
    assert FIELD_PLACEMENTS["glb_mxu_op"] == "derived:glb"
    assert FIELD_PLACEMENTS["sess_sweep_cursor"] == "ledger:SESSION_FIELDS"


# --- --transfers -----------------------------------------------------------

PROBE = ("import numpy as np\n"
         "\n"
         "\n"
         "def probe(tables):\n"
         "    return tables.sess_valid.cpu()\n")


def run_transfers(tmp_path, src, sites=None):
    _write(tmp_path, src)
    return transfers_lint(tmp_path, roots=("pkg",), manifest=SimpleNamespace(
        TRANSFER_SITES=dict(sites or {})))


def test_transfer_host_fetch_fires(tmp_path):
    f = run_transfers(tmp_path, PROBE)
    assert rules_of(f) == ["transfer-host-fetch"] and "probe" in str(f[0])
    via_np = PROBE.replace("tables.sess_valid.cpu()",
                           "np.asarray(tables.sess_valid)")
    assert rules_of(run_transfers(tmp_path, via_np)) == \
        ["transfer-host-fetch"]


def test_transfer_host_fetch_suppressed(tmp_path):
    src = PROBE.replace("tables.sess_valid.cpu()",
                        "tables.sess_valid.cpu()  # transfer-ok: fixture")
    assert run_transfers(tmp_path, src) == []


def test_transfer_approved_site(tmp_path):
    assert run_transfers(tmp_path, PROBE,
                         sites={(MOD, "probe"): "fixture"}) == []
    assert run_transfers(tmp_path, PROBE,
                         sites={(MOD, "*"): "fixture"}) == []


def test_transfer_metadata_not_tainted(tmp_path):
    src = PROBE.replace("tables.sess_valid.cpu()",
                        "np.asarray(tables.sess_valid.shape)")
    assert run_transfers(tmp_path, src) == []


def test_transfer_scalar_sinks(tmp_path):
    src = ("def probe(tables):\n"
           "    a = tables.sess_time.sum()\n"
           "    return int(a), a.item(), a.tolist(), a.to(\"cpu\")\n")
    f = run_transfers(tmp_path, src)
    assert rules_of(f) == ["transfer-host-fetch"] and len(f) == 4


def test_transfer_site_stale(tmp_path):
    f = run_transfers(tmp_path, "def noop():\n    return 0\n",
                      sites={(MOD, "gone"): "x", ("pkg/no.py", "*"): "x"})
    assert rules_of(f) == ["transfer-site-stale"] and len(f) == 2


# --- seeded mutations of the real files ------------------------------------

def _copy(tmp_path, *rels):
    for rel in rels:
        src = REPO / rel
        dst = tmp_path / rel
        if src.is_dir():
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
                "__pycache__", "build"))
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)


def _mutate(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))


CAPTURE_TREE = ("vpp_tpu_torch/ops", "vpp_tpu_torch/pipeline",
                "vpp_tpu_torch/parallel", "vpp_tpu_torch/tenancy")


def test_mutation_item_in_finish_step(tmp_path):
    _copy(tmp_path, *CAPTURE_TREE)
    graph = tmp_path / "vpp_tpu_torch/pipeline/graph.py"
    _mutate(graph, 'shard=None) -> StepResult:\n    """Shared tail',
            'shard=None) -> StepResult:\n    alive.sum().item()\n'
            '    """Shared tail')
    line = graph.read_text().splitlines().index("    alive.sum().item()") + 1
    f = capture_lint(tmp_path)
    assert [(x.rule, x.path, x.line) for x in f] == [
        ("host-sync", "vpp_tpu_torch/pipeline/graph.py", line)]


def test_mutation_counter_branch_in_pipeline_step(tmp_path):
    _copy(tmp_path, *CAPTURE_TREE)
    graph = tmp_path / "vpp_tpu_torch/pipeline/graph.py"
    call = "_finish_step(\n        tables, pkts, now, alive, drop_ip4,"
    _mutate(graph, "    return " + call, "    res = " + call)
    _mutate(graph, "ovl_decapped=ing.ovl_decapped, shard=shard)\n\n\n"
            "# --- two-tier",
            "ovl_decapped=ing.ovl_decapped, shard=shard)\n"
            "    stats = res.stats\n"
            "    if stats.rx.sum() > 0:\n"
            "        pass\n"
            "    return res\n\n\n# --- two-tier")
    line = graph.read_text().splitlines().index(
        "    if stats.rx.sum() > 0:") + 1
    assert [(x.rule, x.line) for x in capture_lint(tmp_path)] == [
        ("tensor-branch", line)]


def test_mutation_dropped_glb_mark(tmp_path):
    _copy(tmp_path, "vpp_tpu_torch/pipeline/tables.py",
          "vpp_tpu_torch/ops/lpm.py")
    assert uploads_lint(tmp_path, roots=()) == []
    _mutate(tmp_path / "vpp_tpu_torch/pipeline/tables.py",
            '        self._glb_bad = bad\n        self._mark("glb")',
            '        self._glb_bad = bad')
    f = uploads_lint(tmp_path, roots=())
    assert rules_of(f) == ["upload-mark-missing"]
    assert "set_global_table" in str(f[0]) and "'glb'" in str(f[0])


def test_mutation_removed_dataplane_lock(tmp_path):
    rel = "vpp_tpu_torch/pipeline/dataplane.py"
    _copy(tmp_path, rel)
    assert threads_lint(tmp_path, roots=(rel,)) == []
    _mutate(tmp_path / rel,
            "        with self._lock:\n            if lazy and max_age",
            "        if True:\n            if lazy and max_age")
    f = threads_lint(tmp_path, roots=(rel,))
    assert rules_of(f) == ["unlocked-access"]
    assert all("expire_sessions()" in str(x) for x in f)


# --- the kernel manifest -----------------------------------------------------

def _reference_pallas_kernels():
    """The reference's PALLAS_KERNELS, its manifest loaded by path (a
    module of dicts: it imports nothing)."""
    path = REPO / "tools" / "analysis" / "jit_manifest.py"
    spec = importlib.util.spec_from_file_location("_reference_jit_manifest",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PALLAS_KERNELS


def test_kernels_pallas_column_is_the_references():
    ours = {e["pallas"] for e in capture_manifest.KERNELS.values()
            if e["pallas"] is not None}
    assert ours == set(_reference_pallas_kernels())
    # the one kernel without a Pallas counterpart is the ML stage's
    assert [n for n, e in capture_manifest.KERNELS.items()
            if e["pallas"] is None] == ["ml_score"]


def test_kernels_one_entry_per_cu_source():
    sources = sorted(p.relative_to(REPO).as_posix() for p in
                     (REPO / "vpp_tpu_torch" / "csrc").glob("*.cu"))
    assert sorted(e["source"] for e in capture_manifest.KERNELS.values()) \
        == sources
    assert [n for n, e in capture_manifest.KERNELS.items()
            if e["mesh"] == "runs"] == ["mxu_first_match"]


def test_capture_wrappers_read_the_manifest():
    from vpp_tpu_torch.pipeline import capture

    assert [w.__name__ for w in capture.WRAPPERS] == [
        e["wrapper"] for e in capture_manifest.KERNELS.values()]


def _broken(name, **change):
    kernels = {k: dict(v) for k, v in capture_manifest.KERNELS.items()}
    kernels[name].update(change)
    return SimpleNamespace(KERNELS=kernels,
                           module_name=capture_manifest.module_name)


@pytest.mark.parametrize("name,change,words", [
    ("sess_probe_ways", dict(fields=("sess_valid", "sess_ghost")),
     "no DataplaneTables field"),
    ("bv_first_set", dict(mesh="runs"), "refused on a rule-sharded mesh"),
    ("mxu_first_match", dict(mesh="refused"), "is not refused"),
    ("lpm_fused_lookup", dict(plain="lpm_gone"), "no callable"),
    ("ml_score", dict(root=("vpp_tpu_torch/pipeline/graph.py",
                            "_finish_step")), "never calls"),
    ("lpm_fused_lookup", dict(source="vpp_tpu_torch/csrc/gone.cu"),
     "is missing"),
])
def test_kernels_lint_catches_a_wrong_entry(cache, name, change, words):
    problems = kernels_lint(REPO, manifest=_broken(name, **change),
                            cache=cache)
    assert any(words in p for p in problems), problems


# --- the command line --------------------------------------------------------

def test_cli_all_exits_0_on_the_tree(cache, capsys):
    assert analysis_main(["--all"], cache=cache) == 0
    assert capsys.readouterr().out.strip().endswith("0 problems")


def test_cli_exits_1_on_a_fixture(tmp_path):
    pkg = tmp_path / "vpp_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text("import os\n")
    assert style_problems(pkg / "bad.py") != []
    out = subprocess.run(
        [sys.executable, "-m", "vpp_tpu_torch.analysis", "--threads",
         "--repo", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "unused import 'os'" in out.stdout


# --- the thread triage's repairs ---------------------------------------------

def _spy_dataplane(attr):
    """A CPU Dataplane whose ``attr`` records, at each read, whether the
    reading thread holds ``_lock``."""
    from vpp_tpu_torch.pipeline.dataplane import Dataplane
    from vpp_tpu_torch.pipeline.tables import DataplaneConfig

    held = []

    def get(self):
        held.append(self._lock._is_owned())
        return self.__dict__["_spied"]

    def put(self, v):
        self.__dict__["_spied"] = v

    spy = type("SpyDataplane", (Dataplane,), {attr: property(get, put)})
    dp = spy(DataplaneConfig(max_tables=2, max_rules=8, max_global_rules=8,
                             max_ifaces=8, fib_slots=16, sess_slots=64,
                             nat_mappings=2, nat_backends=4, fastpath=False),
             device="cpu")
    return dp, held


def test_encap_remote_reads_the_vtep_under_the_lock():
    """``set_vtep`` writes ``_vtep`` under ``_lock``; ``encap_remote``
    read it twice without it (the check and the encap could see two
    VTEPs). It reads it once, under the lock."""
    from vpp_tpu_torch.pipeline.vector import make_packet_vector

    dp, held = _spy_dataplane("_vtep")
    dp.add_uplink()
    dp.set_vtep(0x0A000001)
    dp.swap()
    res = dp.process(make_packet_vector(
        [{"src": "10.1.0.1", "dst": "10.2.0.2", "proto": 6, "sport": 1000,
          "dport": 80, "rx_if": 1}], n=8, device="cpu"))
    held.clear()
    dp.encap_remote(res)
    assert held == [True]


def test_time_classifier_reads_the_uplink_under_the_lock():
    """``add_uplink`` writes ``uplink_if`` under ``_lock``;
    ``time_classifier`` read it (twice) after leaving the lock."""
    dp, held = _spy_dataplane("uplink_if")
    dp.add_uplink()
    dp.swap()
    held.clear()
    dp.time_classifier(batch=8, iters=1)
    assert held and all(held)
