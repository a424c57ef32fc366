"""Spans and device marks of the port, recorded while a ``torch.profiler``
session runs.

``span(name, ...)`` marks a stretch of the host's work at a layer
boundary (the serving path's: ``data/prefetch.py``, ``eval/validate.py``,
``eval/sliding.py``).  With no session running it costs one flag read and
returns a shared null context.  While one runs, each span appends one
entry to an in-memory record: its name, its parent span, the loader batch
it serves (given, or its parent's), its host start and end on the
profiler's clock (``now_ns``), its attributes and, with ``device=``, a
pair of device marks on that device's current stream.  Device times are
resolved only when the record is read (``record()``): each mark's ms
after the window's first mark on its device, on the device's own clock,
so the device time between two spans reads as exactly as a span's own.
A new session starts a new record, so the record holds the last profiled
window.

The record is not made of profiler ranges: the profiler mirrors a
``record_function`` range that launches kernels onto the device's
timeline, where a reader of the trace would take it for device work, and
such a range costs microseconds even with no session running.  So no span
calls ``record_function`` and no span's name is an event of the profile.

``now_ns`` is the wall clock that the profiler maps its events onto, so
the spans and the profile's host events lie on one clock.  The profile's
device events are not on it to better than a few ms (torch 2.11 with
CUPTI put copies up to 4.3 ms before the runtime calls that issued
them), which is why device times come from the marks.

A new record starts inside torch's private profiler start hook; a torch
without it leaves every span off.

A device mark (``device_mark``) is a timing CUDA event on a card and the
host's monotonic clock on the CPU, where an op has finished when it
returns; ``device_seconds`` is the time between two marks.  Marks are
always on: the PTQ engine's per-part seconds read them too.  A span
records no mark while the stream is capturing a CUDA graph.

Spans come from one thread at a time per record; each thread keeps its
own stack of open spans.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()


def now_ns() -> int:
    """The host's time in ns on the profiler's clock (the wall clock)."""
    return time.time_ns()


def device_mark(device: torch.device):
    """A mark on ``device``'s work queue: a timing CUDA event recorded on
    its current stream on a card, the host's monotonic clock (ns)
    elsewhere."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter_ns()


def device_seconds(start, end) -> float:
    """Seconds between two ``device_mark``s of one device (waits for the
    later one on a card)."""
    if isinstance(start, int):
        return (end - start) / 1e9
    end.synchronize()
    return start.elapsed_time(end) / 1e3


class _Record:
    """One profiled window: its spans in the order they opened, and each
    device's marks in the order they were taken."""

    def __init__(self):
        self.spans: List[_Span] = []
        self.marks: Dict[torch.device, list] = {}
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def mark(self, device: torch.device) -> int:
        """Take a mark on ``device``; its index among the device's."""
        marks = self.marks.setdefault(device, [])
        marks.append(device_mark(device))
        return len(marks) - 1

    def device_times(self) -> Dict[torch.device, List[float]]:
        """Each device's marks as ms after its first: sums of the times
        between successive marks, each short, so exact to the timer."""
        out = {}
        for device, marks in self.marks.items():
            t, times = 0.0, [0.0]
            for a, b in zip(marks, marks[1:]):
                t += device_seconds(a, b) * 1e3
                times.append(t)
            out[device] = times
        return out


class _Span:
    __slots__ = ("record", "name", "index", "parent", "batch", "attrs",
                 "device", "start_ns", "end_ns", "marks")

    def __init__(self, record, name, batch, device, attrs):
        self.record, self.name, self.batch = record, name, batch
        self.device, self.attrs = device, attrs
        self.end_ns = self.marks = None

    def __enter__(self):
        stack = self.record.stack()
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.index
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.index = len(self.record.spans)
        self.record.spans.append(self)
        stack.append(self)
        self.start_ns = now_ns()
        if self.device is not None and not _capturing(self.device):
            self.marks = [self.record.mark(self.device)]
        return self

    def __exit__(self, *exc):
        if self.marks is not None:
            if _capturing(self.device):
                self.marks = None
            else:
                self.marks.append(self.record.mark(self.device))
        self.end_ns = now_ns()
        self.record.stack().pop()
        return False

    def device_span(self, times) -> tuple:
        """(start, end) in ms after the device's first mark; Nones
        without marks."""
        if self.marks is None or len(self.marks) != 2:
            return None, None
        t = times[self.device]
        return t[self.marks[0]], t[self.marks[1]]


def _capturing(device: torch.device) -> bool:
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


_record = _Record()  # empty until the first session


def span(name: str, *, batch: Optional[int] = None, device=None,
         **attrs):
    """A span of the host's work named ``name`` (a context manager).
    ``batch``: the loader batch it serves (its parent's if not given);
    ``device``: a ``torch.device`` whose current stream gets a mark at
    each end; ``attrs``: its attributes (numbers and short strings)."""
    if not (_hooked and _profiler._is_profiler_enabled):
        return _NULL
    return _Span(_record, name, batch, device, attrs)


def annotate(**attrs):
    """Set attributes of the innermost open span of this thread; nothing
    when no session runs."""
    if not (_hooked and _profiler._is_profiler_enabled):
        return
    stack = _record.stack()
    if stack:
        stack[-1].attrs.update(attrs)


def record() -> Dict:
    """The last profiled window: ``spans``, a list of dicts (``name``,
    ``index``, ``parent`` (an index or None), ``batch``, ``start_ns``,
    ``end_ns``, ``attrs``, and ``device_start_ms``/``device_end_ms``, its
    marks in ms after the window's first mark on its device (None without
    marks)) in the order they opened."""
    rec = _record
    times = rec.device_times()
    spans = []
    for s in rec.spans:
        start, end = s.device_span(times)
        spans.append({"name": s.name, "index": s.index, "parent": s.parent,
                      "batch": s.batch, "start_ns": s.start_ns,
                      "end_ns": s.end_ns, "attrs": dict(s.attrs),
                      "device_start_ms": start, "device_end_ms": end})
    return {"spans": spans}


def _install() -> bool:
    """Start a new record at each session's start, inside torch's own
    start hook (torch offers no callback of its own for it).  False, and
    nothing changed, where this torch lacks the hook or the session
    flag."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or not hasattr(_profiler, "_is_profiler_enabled"):
        return False
    start = getattr(start, "original", start)

    def on_start():
        global _record
        _record = _Record()
        start()

    on_start.original = start
    _profiler._run_on_profiler_start = on_start
    return True


_hooked = _install()
