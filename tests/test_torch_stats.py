"""The agent's Prometheus surface: vpp_tpu_torch vs vpp_tpu.

The reference's own tests run as written on the port (``port_case`` of
``tests/test_torch_agent.py``: the test module's names and the imports
its functions make are bound to the port, the dataplane to the CPU):

* ``tests/test_stats.py``: the collector's pod labels and counters, drop
  attribution, deleted pods, the pump and IO-daemon families, the ML
  families, the KSR gauges and the HTTP exposition;
* ``tests/test_exposition.py``: text-format conformance over HTTP, the
  metrics and counter-parity lints (``tools/lint.py``, whose registry
  build then imports the port's collector and dataplane), and the
  tenant families. ``vpp_tpu_build_info`` carries ``torch`` and
  ``device`` labels where the reference's carries ``jax`` and
  ``backend`` (a difference on purpose): the conformance case reads the
  port's scrape with those two label names mapped to the reference's
  (``reference_label_names``), and ``test_build_info_names_torch_and_
  the_device`` holds the port's own labels.

Every quantity compared is an integer, a string or a text line: the
tolerance is exact equality.
"""

import re

import pytest
import torch

import test_exposition as jexpo_tests
import test_stats as jstats_tests
from test_torch_agent import CpuDataplane, case_names, run_reference_case
from vpp_tpu_torch import __version__
from vpp_tpu_torch.pipeline.tables import DataplaneConfig
from vpp_tpu_torch.stats.collector import STATS_PATH, StatsCollector

STATS_CASES = case_names(jstats_tests)
EXPO_CASES = case_names(jexpo_tests)


def test_case_lists():
    """Every case of both reference files runs here."""
    assert (len(STATS_CASES), len(EXPO_CASES)) == (14, 7)


@pytest.mark.parametrize("case", STATS_CASES)
def test_reference_stats_cases(case, tmp_path):
    run_reference_case(jstats_tests, case, tmp_path, {})


def reference_label_names(scrape):
    """The reference test's ``scrape`` helper, reading the port's
    build-info labels ``torch`` and ``device`` under the reference's
    names ``jax`` and ``backend``."""
    def scrape_as_reference(*a, **kw):
        body = scrape(*a, **kw)
        return re.sub(
            r"^(vpp_tpu_build_info\{.*)$",
            lambda m: m.group(1).replace('torch="', 'jax="')
            .replace('device="', 'backend="'), body, flags=re.M)
    return scrape_as_reference


@pytest.mark.parametrize("case", EXPO_CASES)
def test_reference_exposition_cases(case, tmp_path):
    run_reference_case(jexpo_tests, case, tmp_path, {},
                       wrap={"scrape": reference_label_names})


def test_build_info_names_torch_and_the_device():
    """The port's build-info anchor: one constant-1 series labelled with
    the package version, the torch version, the dataplane's device type
    and the live classifier; a classifier change replaces the series."""
    dp = CpuDataplane(DataplaneConfig(sess_slots=256))
    coll = StatsCollector(dp)
    coll.publish()
    lines = [ln for ln in coll.registry.render(STATS_PATH).splitlines()
             if ln.startswith("vpp_tpu_build_info{")]
    assert lines == [
        f'vpp_tpu_build_info{{classifier="dense",device="cpu",'
        f'torch="{torch.__version__}",version="{__version__}"}} 1']
