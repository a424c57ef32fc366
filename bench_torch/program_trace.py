"""The port's own record of the traced window (``efficientq_tpu_torch/
utils/tracing.py``: spans at its layer boundaries, host times on the
profiler's clock, device times from the spans' own device marks) for the
per-layer metrics that read it.  Where the port keeps no such record (a
tree before it) every reading is None, and the metric is left out of the
line."""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

TAIL = ("volume.extract", "volume.stitch", "volume.decide")


def record(out: Dict) -> Optional[Dict]:
    """The port's record of the window (read once per run and kept in
    ``out``); None without one, or with no span in it."""
    if "port_record" not in out:
        try:
            from efficientq_tpu_torch.utils import tracing
        except ImportError:
            rec = None
        else:
            rec = tracing.record()
            rec = rec if rec["spans"] else None
        out["port_record"] = rec
    return out["port_record"]


def spans(out: Dict, *names: str) -> List[Dict]:
    rec = record(out)
    return [] if rec is None else [s for s in rec["spans"]
                                   if s["name"] in names]


def timed(out: Dict, *names: str) -> List[Dict]:
    """The spans of ``names`` that took device marks."""
    return [s for s in spans(out, *names)
            if s["device_start_ms"] is not None]


def device_ms(s: Dict) -> float:
    return s["device_end_ms"] - s["device_start_ms"]


def eager_patch_share(out: Dict) -> Optional[float]:
    """% of the window's chunk patches that ran eagerly (outside a CUDA
    graph)."""
    chunks = spans(out, "volume.chunk")
    total = sum(s["attrs"]["patches"] for s in chunks)
    if not total:
        return None
    eager = sum(s["attrs"]["patches"] for s in chunks
                if s["attrs"]["kind"] == "eager")
    return 100.0 * eager / total


def tail_device_share(out: Dict) -> Optional[float]:
    """% of the batches' device time spent in the sliding window's tail:
    the patch extraction, the stitch and the decision."""
    served = sum(device_ms(s) for s in timed(out, "pipeline.serve"))
    if served <= 0:
        return None
    return 100.0 * sum(device_ms(s) for s in timed(out, *TAIL)) / served


def pipeline_stall_share(out: Dict) -> Optional[float]:
    """% of the device's time from the window's first batch to its last
    in which the card's stream waited between two batches: from each
    batch's last device mark to the next one's first, for the host to
    enqueue it or for its upload."""
    served = sorted(timed(out, "pipeline.serve"),
                    key=lambda s: s["device_start_ms"])
    if len(served) < 2:
        return None
    stalls = sum(max(0.0, b["device_start_ms"] - a["device_end_ms"])
                 for a, b in zip(served, served[1:]))
    return 100.0 * stalls / (served[-1]["device_end_ms"]
                             - served[0]["device_start_ms"])


def feed_stage_ms(out: Dict) -> Optional[float]:
    """The median over the window's batches of the host's ms staging each
    batch into pinned memory."""
    by_batch = {}
    for s in spans(out, "feed.stage"):
        by_batch[s["batch"]] = (by_batch.get(s["batch"], 0)
                                + s["end_ns"] - s["start_ns"])
    if not by_batch:
        return None
    return statistics.median(by_batch.values()) / 1e6
