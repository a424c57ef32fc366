"""The traced run's reading of a ``torch.profiler`` trace: device intervals
(kernels, copies and memsets, those of replayed CUDA graphs included),
their union, the harness's host spans, and the breakdown of the result
line.  Nothing is written to disk: the events are read in memory."""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List

import torch

SPAN_PREFIX = "bench."


def union(intervals):
    """The union of (start, end) intervals as a sorted list of [start,
    end] without overlaps."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged) -> float:
    return sum(b - a for a, b in merged)


class Trace:
    """What one traced window left: device events (name, start ns, end ns),
    the harness's host spans (name, start ns, end ns) and the window's
    host seconds."""

    def __init__(self, device, spans, window_s):
        self.device = device
        self.spans = spans
        self.window_s = window_s
        self._busy = None

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        if self._busy is None:
            self._busy = union([(a, b) for _, a, b in self.device])
        return covered(self._busy) / 1e9

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds
        ``fragment``."""
        return sum(b - a for n, a, b in self.device if fragment in n) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        by = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle gaps inside the window, summed by the
        innermost harness span that covered each gap's middle ("no span"
        outside them), the longest ``k``."""
        self.busy_s  # noqa: B018 (fills the union)
        gaps = [(a[1], b[0]) for a, b in zip(self._busy, self._busy[1:])]
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        by = {}
        for a, b in gaps:
            mid = (a + b) / 2
            name, best = "no span", None
            i = bisect.bisect_right(starts, mid)
            for n, s, e in spans[max(0, i - 64):i]:
                if s <= mid <= e and (best is None or s >= best):
                    name, best = n, s
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]


@contextlib.contextmanager
def traced(enabled: bool, out: Dict, device):
    """Trace the block with ``torch.profiler`` (host and device) when
    ``enabled``; ``out["trace"]`` then holds its ``Trace``.  The device is
    synchronized at both ends, so the window's device events are all in
    and no earlier one is."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    card = device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if card else [])) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        window = time.perf_counter() - t0
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        # device work is every device event but the harness's spans, which
        # the profiler mirrors on the device's timeline
        ours = name.startswith(SPAN_PREFIX)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not ours:
                dev.append((name, s, s + e.duration_ns()))
        elif ours:
            spans.append((name, s, s + e.duration_ns()))
    out["trace"] = Trace(dev, spans, window)


def span(name: str):
    """A host span of the harness, seen by the profiler in traced runs."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
