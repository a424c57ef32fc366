"""The card's stalls between batches, in % of the device time from the
window's first batch to its last: from the end of each batch's
``pipeline.serve`` span to the start of the next one's, by their device
marks on the card's stream (``eval/validate.py::_pipeline``), where the
card waited for the host to enqueue the next batch or for its upload."""
from bench_torch import program_trace


def read(out):
    return program_trace.pipeline_stall_share(out)
