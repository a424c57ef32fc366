"""The sliding window's tail in the batches' device time, in %: the device
ms of the port's ``volume.extract``, ``volume.stitch`` and
``volume.decide`` spans over its ``pipeline.serve`` spans', by their
device marks on the card's stream (``eval/sliding.py``,
``eval/validate.py``)."""
from bench_torch import program_trace


def read(out):
    return program_trace.tail_device_share(out)
