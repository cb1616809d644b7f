"""Build, load and dispatch the package's hand-written CUDA kernels.

The counterpart of ``vpp_tpu/ops/_pallas.py``: the ONE place that
decides where a kernel serves and how it is built.

* ``use_kernels(t)``: the dispatch predicate — ``t`` lies on a CUDA
  device. A wrapper handed a CPU tensor takes its plain PyTorch version;
  handed a CUDA tensor it launches its kernel or raises. There is no
  fallback from a failed build or launch to the plain version.
* ``library(name)``: the ctypes handle of ``csrc/<name>.cu``, built at
  first use. Every ``csrc/*.cu`` compiles with its own ``nvcc`` process,
  all started together, into ``csrc/build/<hash>/`` where ``<hash>``
  covers every source and header, so an edited source rebuilds and an
  unchanged one is reused. Plain C entry points (no PyTorch headers)
  keep each compile to seconds.
* ``check(err, name)``: every C entry returns ``cudaGetLastError()``;
  a nonzero code (a refused launch) raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds the last build took (0.0 when every library was cached)
build_seconds = 0.0


def use_kernels(t: torch.Tensor) -> bool:
    """Whether a wrapper handed ``t`` launches its CUDA kernel."""
    return t.is_cuda


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "vpp_tpu_torch need the CUDA toolkit")
    return cand


def build_all() -> float:
    """Compile every ``csrc/*.cu`` that is not built yet (one nvcc per
    source, run in parallel) and return the wall seconds spent."""
    global build_seconds
    out = BUILD_ROOT / _digest()
    todo = [s for s in _sources()
            if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    build_seconds = time.perf_counter() - t0
    return build_seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc/<name>.cu`` (built on first
    use, together with every other source)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(BUILD_ROOT / _digest() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def stream() -> int:
    """The current CUDA stream as an integer handle for ctypes."""
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t: torch.Tensor, name: str, dtype=torch.int32, ndim=None,
            device=None) -> None:
    """The wrapper-side argument check: a contiguous CUDA tensor of
    ``dtype`` (and rank ``ndim``) on ``device``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")
