"""Build + launch helpers for the LD_PRELOAD session shim.

``shim_path()`` compiles native/vcl_preload.c into libvclshim.so with
the same on-demand machinery as the other native libraries
(``native/ring.py`` ``build_native``, into the port's own build
directory); ``vcl_env()`` returns the environment an unmodified app
needs so its connect()/accept() calls are admission-checked against the
node's session rules (the reference's ldpreload deployment shape: the
CRI shim injects exactly these env vars into pod containers,
cmd/contiv-cri + tests/ld_preload*).

The environment variables keep the reference's names
(``vpp_tpu/hoststack/preload.py``): they are the shim's wire contract,
so a manifest injected for either package runs under either shim.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from vpp_tpu_torch.native.ring import _BUILD_DIR, build_native

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "vcl_preload.c")
_LIB = os.path.join(_BUILD_DIR, "libvclshim.so")


def shim_path(force: bool = False) -> str:
    """Compile-if-stale; returns the absolute libvclshim.so path."""
    return build_native(_SRC, _LIB, force)


def vcl_env(
    admission_sock: str,
    appns_index: int = 0,
    fail_closed: bool = False,
    base: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """Environment for launching an app under the session shim.

    Appends to (a copy of) ``base`` or os.environ: LD_PRELOAD chains
    after any existing preloads.
    """
    env = dict(os.environ if base is None else base)
    lib = shim_path()
    prior = env.get("LD_PRELOAD", "")
    env["LD_PRELOAD"] = f"{prior}:{lib}" if prior else lib
    env["VPP_TPU_VCL_SOCK"] = admission_sock
    env["VPP_TPU_APPNS"] = str(int(appns_index))
    if fail_closed:
        env["VPP_TPU_VCL_FAILCLOSED"] = "1"
    else:
        env.pop("VPP_TPU_VCL_FAILCLOSED", None)
    return env
