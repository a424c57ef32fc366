"""The host's staging copy of a batch into pinned memory, in ms: the
median over the window's batches of the port's ``feed.stage`` spans
(``data/prefetch.py::device_feed``)."""
from bench_torch import program_trace


def read(out):
    return program_trace.feed_stage_ms(out)
