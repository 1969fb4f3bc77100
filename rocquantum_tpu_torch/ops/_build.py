"""Build native sources at first use and load them with ctypes.

Libraries go to ``build/rocquantum_tpu_torch/`` at the repository root (a
directory ``.gitignore`` lists), named by a hash of the source and the
compiler command, so a changed source rebuilds and an unchanged one loads
the library already there. Each build writes a temporary file and renames
it into place, so concurrent test workers never load a half-written one.

CUDA sources (``rocquantum_tpu_torch/csrc/*.cu``) are compiled by ``nvcc``
for ``sm_90a`` into shared libraries with a plain C interface; the host C++
planner (``native/fusion_planner.cpp``) by ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

from ..utils import profiling

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "rocquantum_tpu_torch")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

# compiler diagnostics of each library built in this process (nvcc's
# -Xptxas -v report: registers, shared memory and spills per kernel)
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels need the CUDA toolkit")


def _build(name: str, sources: List[str], command: List[str],
           timeout: float) -> str:
    flags = [os.path.basename(command[0])] + command[1:]
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(command + ["-o", tmp] + sources,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({command[0]}, rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    BUILD_LOGS[name] = proc.stderr
    os.replace(tmp, out)
    return out


def load_cuda(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` with nvcc (once per source hash) and load
    it."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with profiling.span("rq.build"):
        return ctypes.CDLL(_build(name, [src], [find_nvcc()] + NVCC_FLAGS,
                                  timeout=600))


def load_host_cpp(name: str, source: str) -> ctypes.CDLL:
    """Build a host C++ source with g++ (once per source hash) and load
    it. Raises FileNotFoundError when g++ is missing."""
    with profiling.span("rq.build"):
        return ctypes.CDLL(_build(name, [source], ["g++"] + GXX_FLAGS,
                                  timeout=120))
