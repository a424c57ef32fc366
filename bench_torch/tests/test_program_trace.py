"""The per-layer metrics that read the port's own record of the traced
window (``program_trace.py``): printed in traced runs of each cell, in
their ranges, and in no untraced one; the harness's older metrics read as
they did; on a tree whose port keeps no record they are left out.  On the
card (``cuda``): the full-size cells, and the port's spans on the clock
of the profile's host events."""
import bisect
import sys

import pytest
import torch

from bench_torch import program_trace
from bench_torch import run as harness

from . import tiny
from .test_harness import run_line

CELLS = ("lits_w4a4.serve_varied_depth", "lits_w4a4.serve_fixed_depth")
PORT = ("eager_patch_share.serve", "tail_device_share.serve",
        "pipeline_stall_share.serve", "feed_stage_ms.serve")
CARD = ("feed_stage_ms.serve",)  # the CPU's feed stages nothing
OLDER = ("k1_roofline", "serve_mfu", "device_idle_share.serve")
SEED = 2 ** 31 + 29


def _in_range(metrics, names=PORT):
    v = {n: metrics[n]["value"] for n in names}
    assert 0 <= v["eager_patch_share.serve"] <= 100
    assert 0 < v["tail_device_share.serve"] < 100
    assert 0 <= v["pipeline_stall_share.serve"] < 100
    if "feed_stage_ms.serve" in v:
        assert v["feed_stage_ms.serve"] > 0
    return v


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_port_metrics_print_in_traced_runs_only(tmp_path, cell, trace):
    root, bench = tiny.make(tmp_path)
    line = run_line(root, bench, cell, trace=trace, seed=SEED)
    if not trace:
        assert not set(PORT) & set(line["metrics"])
        return
    on_cpu = set(PORT) - set(CARD)
    assert on_cpu <= set(line["metrics"])
    assert not set(CARD) & set(line["metrics"])
    assert {line["metrics"][n]["unit"] for n in on_cpu} == {"%"}
    # the CPU serves every chunk eagerly
    assert _in_range(line["metrics"], on_cpu)[
        "eager_patch_share.serve"] == 100.0
    # the older metrics print as before: none on the CPU, which has no
    # device trace and no captured chunks
    assert not set(OLDER) & set(line["metrics"])


def _traced_out(root, bench, cell_name, seconds, device):
    cell = harness.Cell(cell_name, root, bench)
    harness._cache_dirs(bench)
    run = harness.Run(cell, SEED, seconds, True, torch.device(device))
    driver = harness.load_module(cell.driver_path, "driver_serve")
    return cell, driver.run(run)


def _read(cell, out, names):
    return {n: cell.reader(n).read(out) for n in names}


def test_older_metrics_read_as_before(tmp_path):
    root, bench = tiny.make(tmp_path)
    cell, out = _traced_out(root, bench, CELLS[0], 1.0, "cpu")
    before = _read(cell, out, OLDER)
    port = _read(cell, out, PORT)
    assert _read(cell, out, OLDER) == before
    assert [n for n, v in port.items() if v is None] == list(CARD)
    rec = program_trace.record(out)
    assert {s["batch"] for s in program_trace.spans(out, "pipeline.serve")} \
        == set(range(len(program_trace.spans(out, "pipeline.serve"))))
    # no port span is an event of the profile
    names = {s["name"] for s in rec["spans"]}
    tr = out["trace"]
    assert not names & ({n for n, _, _ in tr.device}
                        | {n for n, _, _ in tr.spans})


def test_a_port_without_a_record_leaves_the_metrics_out(tmp_path,
                                                        monkeypatch):
    root, bench = tiny.make(tmp_path)
    cell, out = _traced_out(root, bench, CELLS[1], 1.0, "cpu")
    before = _read(cell, out, OLDER)
    monkeypatch.setitem(sys.modules, "efficientq_tpu_torch.utils.tracing",
                        None)  # its import raises, as on a tree without it
    import efficientq_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    assert _read(cell, out, PORT) == dict.fromkeys(PORT)
    assert _read(cell, out, OLDER) == before


def _span(i, name, device=None, parent=None, batch=0):
    a, b = device or (None, None)
    return {"name": name, "index": i, "parent": parent, "batch": batch,
            "start_ns": 0, "end_ns": 1, "attrs": {},
            "device_start_ms": a, "device_end_ms": b}


def test_stalls_and_tail_are_read_from_the_device_marks():
    # three batches on the device's clock (ms): served 0-40, 41-80 and
    # 90-130, so the card waited 1 + 10 ms between them; the tail spans
    # take 2 + 3 + 1 ms of the first batch and 4 + 0 + 2 of the second
    rec = {"spans": [_span(0, "pipeline.serve", (0, 40)),
                     _span(1, "volume.extract", (0, 2), 0),
                     _span(2, "volume.chunk", None, 0),
                     _span(3, "volume.stitch", (35, 38), 0),
                     _span(4, "volume.decide", (38, 39), 0),
                     _span(5, "feed.stage", batch=2),
                     _span(6, "pipeline.serve", (41, 80), batch=1),
                     _span(7, "volume.extract", (41, 45), 6, 1),
                     _span(8, "volume.stitch", (70, 70), 6, 1),
                     _span(9, "volume.decide", (70, 72), 6, 1),
                     _span(10, "pipeline.serve", (90, 130), batch=2)]}
    out = {"port_record": rec}
    assert program_trace.pipeline_stall_share(out) == pytest.approx(
        100 * 11 / 130)
    assert program_trace.tail_device_share(out) == pytest.approx(
        100 * 12 / 119)
    # one batch has no stall to read; no record reads nothing
    assert program_trace.pipeline_stall_share(
        {"port_record": {"spans": rec["spans"][:6]}}) is None
    assert program_trace.tail_device_share({"port_record": None}) is None


def _within(spans, starts, ends):
    """Per span, how many of the (sorted) events lie inside it."""
    out = []
    for s in spans:
        k = bisect.bisect_left(starts, s["start_ns"])
        out.append(sum(1 for a, b in zip(starts[k:k + 64], ends[k:k + 64])
                       if b <= s["end_ns"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_traced_cells_on_the_profiles_clock(cell, monkeypatch):
    """The full-size cells on the card: the four metrics in range, every
    fixed-depth volume's ragged chunk eager (3 of 27 patches) and no
    capture in the window; each staging copy is followed, before the
    host's next port span, by the one runtime call that enqueues its
    upload, as the profile records it on the host (one clock); no port
    span on the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kept = []

    class Profile(torch.profiler.profile):
        def __exit__(self, *exc):
            done = super().__exit__(*exc)
            kept.append(self)
            return done

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    c, out = _traced_out(tiny.ROOT, tiny.BENCH, cell, 3.0, "cuda")
    v = _in_range({n: {"value": c.reader(n).read(out)} for n in PORT})
    assert all(c.reader(n).read(out) is not None for n in OLDER)
    kinds = {s["attrs"]["kind"]
             for s in program_trace.spans(out, "volume.chunk")}
    assert "capture" not in kinds and "replay" in kinds
    if cell.endswith("fixed_depth"):
        assert v["eager_patch_share.serve"] == pytest.approx(100 * 3 / 27)
    events = kept[-1].profiler.kineto_results.events()
    host = {}
    on_device = set()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            on_device.add(e.name())
        else:
            host.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    rec = program_trace.record(out)
    opened = sorted(s["start_ns"] for s in rec["spans"])
    after_stage = [
        {"start_ns": s["end_ns"],
         "end_ns": opened[bisect.bisect_right(opened, s["end_ns"])]}
        for s in program_trace.spans(out, "feed.stage")]
    calls = sorted(host["cudaMemcpyAsync"])
    inside = _within(after_stage, [a for a, _ in calls],
                     [b for _, b in calls])
    assert inside and set(inside) == {1}
    names = {s["name"] for s in rec["spans"]}
    assert not names & on_device
    # the harness's chunk list and the port's chunk spans are one count
    chunks = program_trace.spans(out, "volume.chunk")
    assert [s["attrs"]["patches"] for s in chunks] == out["chunks"]
