"""The fenced HA store pair: vpp_tpu_torch's QuorumWitness,
WitnessClient, PrimaryGuard and HaCoordinator vs vpp_tpu's.

The reference's own cases (``tests/test_kvstore_fencing.py``: the
witness's adopt / renew / claim arbitration and its persistence, the
fencing epoch on the wire, the partitions, the CAS sequence across a
failover, garbage and NaN on the witness's wire) run as written on the
port through ``test_torch_kvserver.run_port_case``. Every quantity they
compare is an epoch, a key, a value or a boolean: the tolerance is
exact equality.
"""

from __future__ import annotations

import pytest

import test_kvstore_fencing as jfence_tests
from test_torch_agent import case_names
from test_torch_kvserver import run_port_case

FENCE_CASES = case_names(jfence_tests)


def test_fencing_case_list():
    """Every case of tests/test_kvstore_fencing.py runs here."""
    assert len(FENCE_CASES) == 14


@pytest.mark.parametrize("case", FENCE_CASES)
def test_reference_fencing_cases(case, request):
    run_port_case(jfence_tests, case, request)


def _arbitration(wit_mod, cli_mod) -> list:
    """A fixed renew / claim sequence against a witness of ``wit_mod``
    from clients of ``cli_mod``: every reply and the final status."""
    import time

    w = wit_mod.QuorumWitness(host="127.0.0.1", port=0).start()
    try:
        c = cli_mod.WitnessClient(w.address)
        out = [c.renew("p:1", 0, ttl=5.0), c.renew("q:1", 0, ttl=5.0),
               c.claim("q:1", ttl=5.0), c.claim("p:1", ttl=0.3)]
        time.sleep(0.4)
        out += [c.claim("q:1", ttl=5.0), c.renew("p:1", 0, ttl=5.0),
                c.renew("q:1", 1, ttl=5.0)]
        st = c.status()
        out.append((st["epoch"], st["primary"]))
        # a reply's lease time left is a clock reading: its presence is
        # compared, not its value
        return [{k: (v if k != "remaining" else "<s>") for k, v in r.items()}
                if isinstance(r, dict) else r for r in out]
    finally:
        w.close()


@pytest.mark.parametrize("wit_pkg,cli_pkg", [("ref", "port"),
                                             ("port", "ref")])
def test_witness_speaks_to_the_other_package(wit_pkg, cli_pkg):
    """The witness protocol is the reference's: a port client against a
    reference witness, and a reference client against a port witness,
    get the replies of the reference pair (the oracle)."""
    from vpp_tpu.kvstore import witness as jw
    from vpp_tpu_torch.kvstore import witness as tw

    pkgs = {"ref": jw, "port": tw}
    assert _arbitration(pkgs[wit_pkg], pkgs[cli_pkg]) == \
        _arbitration(jw, jw)
