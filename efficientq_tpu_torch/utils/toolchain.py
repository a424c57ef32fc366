"""Toolchain fingerprint for experiment records.

Counterpart of the JAX package's ``utils/toolchain.py``.  2-bit
quantization basins are sensitive below one ulp, so a compiler or library
update can move a result with no change to the code: each record states
the toolchain that produced it.  On this port those are torch, the CUDA
runtime torch was built for, nvcc, the driver and the device.
"""
from __future__ import annotations

import platform
import shutil
import subprocess
from typing import Dict, List, Optional


def _first_line(cmd: List[str], pick=None) -> Optional[str]:
    """The first output line of ``cmd`` (or the first that contains
    ``pick``); None when the tool is absent or fails."""
    if shutil.which(cmd[0]) is None:
        return None
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if pick is not None:
        lines = [ln for ln in lines if pick in ln]
    return lines[0] if lines else None


def _nvcc() -> Optional[str]:
    from ..kernels.build import nvcc_path

    try:
        return _first_line([nvcc_path(), "--version"], pick="release")
    except RuntimeError:  # no nvcc on this machine
        return None


def toolchain_fingerprint() -> Dict[str, str]:
    """Versions that can move quantization results: torch, the CUDA
    runtime it was built for, nvcc, the driver, the device's name and
    python.  A tool that is absent reads "absent"."""
    import torch

    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda or "absent",
        "nvcc": _nvcc() or "absent",
        "driver": _first_line(["nvidia-smi", "--query-gpu=driver_version",
                               "--format=csv,noheader"]) or "absent",
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu"),
        "python": platform.python_version(),
    }
