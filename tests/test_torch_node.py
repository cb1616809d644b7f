"""The node-side modules of the agent: vpp_tpu_torch vs vpp_tpu.

The reference's own tests run as written on the port (``port_case`` of
``tests/test_torch_agent.py``: the test module's names and the imports
its functions make are bound to the port, the dataplane to the CPU):

* ``tests/test_cni.py``: the CNI server over the port's Dataplane, its
  transport socket and the kubelet shim;
* ``tests/test_kvstore_ipam.py``: the KV store (watch, CAS, leases,
  the persisted file), its proxy and brokers, IPAM and node ids;
* ``tests/test_health.py``: the status checks, their HTTP probes and
  the STN daemon with its watchdog. Its real-kernel case (over the
  port's ``health/stn_netlink.py`` and ``net/linux.py``) runs in
  ``tests/test_torch_wiring.py``, beside the other cases that need
  network namespaces; the reference skips it too without
  CAP_NET_ADMIN.

Every quantity compared is an integer, a string or a text line: the
tolerance is exact equality.
"""

import pytest

import test_cni as jcni_tests
import test_health as jhealth_tests
import test_kvstore_ipam as jkv_tests
from test_torch_agent import case_names, run_reference_case

CNI_CASES = case_names(jcni_tests)
KV_CASES = case_names(jkv_tests)
# the real-kernel STN case runs in test_torch_wiring.py
HEALTH_RUN_ELSEWHERE = ("test_stn_real_kernel_steal_crash_autorevert",)
HEALTH_CASES = [c for c in case_names(jhealth_tests)
                if c not in HEALTH_RUN_ELSEWHERE]


def test_case_lists():
    """Every case of the three reference files runs here, but the one
    real-kernel STN case."""
    assert (len(CNI_CASES), len(KV_CASES), len(HEALTH_CASES)) == (12, 13, 9)
    assert set(HEALTH_RUN_ELSEWHERE) <= set(case_names(jhealth_tests))


@pytest.mark.parametrize("case", CNI_CASES)
def test_reference_cni_cases(case, tmp_path):
    run_reference_case(jcni_tests, case, tmp_path, {})


@pytest.mark.parametrize("case", KV_CASES)
def test_reference_kvstore_ipam_cases(case, tmp_path):
    run_reference_case(jkv_tests, case, tmp_path, {})


@pytest.mark.parametrize("case", HEALTH_CASES)
def test_reference_health_cases(case, tmp_path):
    run_reference_case(jhealth_tests, case, tmp_path, {})
