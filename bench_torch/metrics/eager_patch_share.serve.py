"""The share of the window's patches whose chunk forward ran eagerly,
outside the CUDA graph, in %: the patches of the port's ``volume.chunk``
spans of kind ``eager`` over all their patches (``eval/sliding.py``,
``CapturedForward``)."""
from bench_torch import program_trace


def read(out):
    return program_trace.eager_patch_share(out)
