"""Two nodes in real processes on the port: tests/test_two_node_e2e.py.

The reference's suite runs as written on the port: the fenced store
trio (witness, primary, standby) as subprocesses, per node an agent
process (the port's, ``vpp_tpu_torch.cmd.agent --device cpu``) and an
IO-daemon process started from the agent's published plan, a veth pair
as the inter-node fabric, and network-namespace pods wired by CNI Adds.
Its two cases are one sequence (the second un-blocks the policy the
first cut), run in order in one module.

The reference's suite names host-global resources: network namespaces
(``vppt2-poda`` / ``vppt2-podb``, the ``vppt2selfck`` self-check), the
veth pair (``vppt2-faba`` / ``vppt2-fabb``), the run directory
(``/tmp/vppt2-run``), the shared-memory rings (``vppt2-node-a`` / ``-b``),
the container ids behind the pods' host-side veth names and the agents'
health and stats ports (21191, 21192, 21991, 21992). So that a run here
and the reference's own run in another test worker cannot collide, every
``vppt2`` name here is ``vptq2``, the container ids are others, the
ports are ones the kernel hands out (``PORTS``) and the run
directory is a pytest temporary directory made for each run (under
``TMPDIR``). The strings that
name the reference's modules name the port's, so every child process
runs the port. Where this host cannot create a network namespace the
cases skip, as the reference's do (the check runs in the fixture, with
the renamed self-check namespace); the reference marks its class slow
(its subprocess boots), and so does this one: the two cases are one
slow sequence in both packages.
"""

from __future__ import annotations

import socket
import subprocess
import types

import pytest

import test_two_node_e2e as jtwo
from test_torch_agent import port_globals, port_imports
from test_torch_kvserver import _port_text

# the reference's host-global names -> this runner's
RENAME = ("vppt2", "vptq2")
CIDS = {"a": "ac02" * 5, "b": "bd02" * 5}
FIXED_PORTS = (21191, 21192, 21991, 21992)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PORTS = {p: _free_port() for p in FIXED_PORTS}


def _text(s: str) -> str:
    return _port_text(s.replace(*RENAME))


def _value(v):
    if type(v) is int:
        return PORTS.get(v, v)
    if isinstance(v, str):
        return _text(v)
    if isinstance(v, tuple):
        return tuple(_value(x) for x in v)
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    return v


def _code(code: types.CodeType) -> types.CodeType:
    """``code`` with its host-global names, fixed ports and reference
    module names rewritten (nested code objects too)."""
    def sub(c):
        if isinstance(c, types.CodeType):
            return _code(c)
        return _value(c)
    return code.replace(co_consts=tuple(sub(c) for c in code.co_consts))


def _fn(f: types.FunctionType, g: dict) -> types.FunctionType:
    out = types.FunctionType(_code(f.__code__), g, f.__name__,
                             f.__defaults__, f.__closure__)
    out.__kwdefaults__ = f.__kwdefaults__
    return out


class _CpuAgentPopen:
    """``subprocess`` as the suite uses it, with the port's agent asked
    onto the CPU (``--device cpu``; the port's entry points default to
    the card, the reference's children to JAX's CPU through their
    environment)."""

    def __getattr__(self, name):
        return getattr(subprocess, name)

    @staticmethod
    def Popen(argv, *args, **kwargs):
        if "vpp_tpu_torch.cmd.agent" in argv:
            argv = list(argv) + ["--device", "cpu"]
        return subprocess.Popen(argv, *args, **kwargs)


def _globals() -> dict:
    g = port_globals(jtwo)
    for k in ("FAB", "PODS"):
        g[k] = _value(vars(jtwo)[k])
    g["RUN"] = None   # the run's own directory, set by ``port_cluster``
    g["CIDS"] = dict(CIDS)
    g["subprocess"] = _CpuAgentPopen()
    for k, v in vars(jtwo).items():
        # a fixture's function is rebuilt as a plain generator function
        v = getattr(v, "__wrapped__", v)
        if isinstance(v, types.FunctionType) and v.__module__ == jtwo.__name__:
            g[k] = _fn(v, g)
        elif isinstance(v, type) and v.__module__ == jtwo.__name__:
            g[k] = type(v.__name__, v.__bases__, {
                a: _fn(f, g) if isinstance(f, types.FunctionType) else f
                for a, f in vars(v).items()
                if a not in ("__dict__", "__weakref__")})
    return g


G = _globals()


def test_host_global_names_differ_from_the_references():
    """No name or port this runner uses is one the reference's suite
    uses; the reference's are what this runner rewrites. The run
    directory is made for each run (``port_cluster``)."""
    ref = (set(jtwo.PODS.values()) | set(jtwo.FAB) | {jtwo.RUN}
           | set(jtwo.CIDS.values()))
    ours = set(G["PODS"].values()) | set(G["FAB"]) | set(G["CIDS"].values())
    assert not ref & ours and all("vppt2" in n for n in ref - set(
        jtwo.CIDS.values()))
    assert not set(PORTS.values()) & set(FIXED_PORTS)
    consts = G["Node"].__init__.__code__.co_consts
    assert "vptq2-" in consts and "vppt2-" not in consts
    def ints(code):
        for c in code.co_consts:
            if isinstance(c, types.CodeType):
                yield from ints(c)
            elif isinstance(c, tuple):
                yield from (x for x in c if type(x) is int)
            elif type(c) is int:
                yield c
    assert set(FIXED_PORTS) <= set(ints(vars(jtwo)["cluster"].__wrapped__
                                        .__code__))
    assert not set(FIXED_PORTS) & set(ints(G["cluster"].__code__))


@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    # the reference's own condition, asked where the cases run (not at
    # import, in every worker)
    if not G["_can_netns"]():
        pytest.skip("needs CAP_NET_ADMIN (netns/veth)")
    G["RUN"] = str(tmp_path_factory.mktemp("vptq2-run"))
    gen = G["cluster"]()
    with port_imports():
        value = next(gen)
    yield value
    with port_imports():
        try:
            next(gen)
        except StopIteration:
            pass


@pytest.mark.slow
class TestTwoNodeTwoPods:
    """The reference's class, in its order, on the port."""

    def test_cross_node_udp_then_policy_cutoff(self, port_cluster):
        with port_imports():
            G["TestTwoNodeTwoPods"]().test_cross_node_udp_then_policy_cutoff(
                port_cluster)

    def test_store_failover_keeps_cluster_serving(
            self, port_cluster):
        with port_imports():
            G["TestTwoNodeTwoPods"]() \
                .test_store_failover_keeps_cluster_serving(
                    port_cluster)
