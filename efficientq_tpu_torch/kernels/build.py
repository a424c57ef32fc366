"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into its own shared library with a
plain C interface, under ``efficientq_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source, the headers of ``csrc/`` and
the flags so an edited source or header rebuilds.  ``load_all`` starts
one nvcc per source at once.  There is no fallback: a missing nvcc or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a (Hopper); no fast math, and no FMA contraction, so the float
# epilogues round exactly as the reference does; ptxas reports each
# kernel's registers, shared memory and spills; csrc/'s headers found
# from a copy of a source built elsewhere (the timing scripts' variants)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v", "-I" + CSRC)
# the card the kernels are tiled for, NVIDIA H100 (SXM): SMs, and shared
# memory per SM and per block (opt-in), bytes
SMS, SMEM_SM, SMEM_BLOCK = 132, 233472, 232448

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's messages (ptxas's resource lines) of each source built by this
# process
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _paths(source: str):
    """(source path, library path): the library is named by a hash of the
    source, the headers and the flags."""
    path = os.path.join(CSRC, source)
    digest = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for name in [source] + sorted(f for f in os.listdir(CSRC)
                                  if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return path, os.path.join(BUILD_DIR,
                              f"{stem}-{digest.hexdigest()[:16]}.so")


def load_all(sources: Sequence[str]) -> List[ctypes.CDLL]:
    """Compile each ``csrc/<source>`` not built yet (once per process and
    per source hash), one nvcc process per source, all started together,
    and return the loaded libraries in order."""
    with _lock:
        todo = [s for s in dict.fromkeys(sources) if s not in _loaded]
        builds = []
        for source in todo:
            path, lib = _paths(source)
            if not os.path.exists(lib):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                builds.append((source, lib, tmp, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, path],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
        errors = []
        for source, lib, tmp, proc in builds:
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {source}:\n{err}")
            else:
                build_log[source] = out + err
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        for source in todo:
            _loaded[source] = ctypes.CDLL(_paths(source)[1])
        return [_loaded[s] for s in sources]


def load(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per process and per source hash)
    and return the loaded library."""
    return load_all([source])[0]
