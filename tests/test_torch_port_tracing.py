"""The port's spans (``utils/tracing.py``) on the CPU: nothing is recorded
without a profiler session; under one, the serving pipeline
(``eval/validate.py::_pipeline`` over the eager volume inferencer)
records every span of the pipeline and the sliding window, nested and
indexed by loader batch, on the profiler's clock and never as a profiler
event, with device times in order; ``CapturedForward`` tells its eager
calls, captures and replays apart in the spans.  The card's side (CUDA
events, the feed's staging spans, the runtime calls that upload and read
back) is held by ``bench_torch/tests/test_program_trace.py``'s ``cuda``
case.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.data import prefetch
from efficientq_tpu_torch.eval import sliding, validate
from efficientq_tpu_torch.models import UResQConfig, build_uresq
from efficientq_tpu_torch.ptq import admm
from efficientq_tpu_torch.utils import tracing

CFG = dict(num_mod=1, num_classes=3, depth_config=[1, 1, 1],
           width_config=[4, 8, 4], dilation_config=[1, 1, 1],
           init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
           ds_depth_limit=3, fuse_bn=True, quantize=False)
PATCH, OVERLAP, BATCH = (16, 16, 16), (4, 4, 4), 3
VOLUMES = [(24, 20, 16), (16, 16, 16), (24, 20, 16)]  # 8, 1, 8 patches
# the CPU's spans: its feed stages nothing (feed.stage is the card's)
SERVING = {"pipeline.serve", "volume.extract", "volume.chunk",
           "volume.stitch", "volume.decide"}
DEVICE = {"pipeline.serve", "volume.extract", "volume.stitch",
          "volume.decide"}  # the spans with device marks


@pytest.fixture(scope="module")
def net():
    graph = build_uresq(UResQConfig(**CFG))
    return graph, nnir.init(graph, 0, device="cpu")


def _loader():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((1, 1) + v).astype(np.float32), None)
            for v in VOLUMES]


def _serve_all(net):
    graph, variables = net
    infer = sliding.make_volume_inferencer(graph, patch_batch=BATCH,
                                           hard_pred=True)

    def serve(x, _masks):
        return infer(variables, x, PATCH, OVERLAP)

    return [p for p, _ in validate._pipeline(_loader(), torch.device("cpu"),
                                             serve)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, tracing.record()


def test_no_session_records_nothing_and_enters_no_record_function(
        net, monkeypatch):
    entered = []
    enter = record_function.__enter__
    monkeypatch.setattr(record_function, "__enter__",
                        lambda self: entered.append(self) or enter(self))
    before = tracing.record()["spans"]
    assert tracing.span("volume.chunk", patches=3) is \
        tracing.span("feed.stage", batch=0)
    preds = _serve_all(net)
    assert len(preds) == len(VOLUMES)
    assert tracing.record()["spans"] == before
    assert entered == []
    # under a session the spans are recorded, still without a profiler range
    _, _, rec = _profiled(lambda: _serve_all(net))
    assert rec["spans"] and entered == []


def test_pipeline_records_every_span_nested_by_batch(net):
    preds, _, rec = _profiled(lambda: _serve_all(net))
    spans = rec["spans"]
    assert {s["name"] for s in spans} == SERVING
    by_index = {s["index"]: s for s in spans}
    assert all(s["end_ns"] >= s["start_ns"] for s in spans)
    for s in spans:
        parent = by_index.get(s["parent"])
        if s["name"].startswith("volume."):
            # a volume's spans nest in its batch's serve span, on the host
            # and on the device
            assert parent["name"] == "pipeline.serve"
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
        else:
            assert parent is None
        timed = s["device_start_ms"] is not None
        assert timed == (s["name"] in DEVICE), s["name"]
        if timed and parent is not None:
            assert parent["device_start_ms"] <= s["device_start_ms"] \
                <= s["device_end_ms"] <= parent["device_end_ms"]
    n = len(VOLUMES)
    assert [s["batch"] for s in spans if s["name"] == "pipeline.serve"] \
        == list(range(n))
    # the device's times follow the order its marks were taken in
    marks = [t for s in spans if s["device_start_ms"] is not None
             for t in (s["device_start_ms"], s["device_end_ms"])]
    assert marks[0] == 0.0
    served = [s for s in spans if s["name"] == "pipeline.serve"]
    assert all(a["device_end_ms"] <= b["device_start_ms"]
               for a, b in zip(served, served[1:]))
    for b, vol in enumerate(VOLUMES):
        mine = [s for s in spans if s["batch"] == b]
        names = [s["name"] for s in mine]
        assert names.count("volume.extract") == names.count(
            "volume.stitch") == names.count("volume.decide") == 1
        chunks = [s for s in mine if s["name"] == "volume.chunk"]
        grid = len(sliding.patch_grid(vol, PATCH, OVERLAP))
        assert sum(s["attrs"]["patches"] for s in chunks) == grid
        assert [s["attrs"]["patches"] for s in chunks] == \
            [min(BATCH, grid - k) for k in range(0, grid, BATCH)]
        assert {s["attrs"]["kind"] for s in chunks} == {"eager"}
    # the spans change nothing served
    assert all(np.array_equal(a, b) for a, b in zip(preds, _serve_all(net)))


class _Event:
    def __init__(self):
        self.synced = 0

    def synchronize(self):
        self.synced += 1


def test_staging_waits_only_for_the_upload_of_the_slot_it_reuses():
    ring = prefetch._Staging(2)
    ring.bufs = [torch.empty(64, dtype=torch.uint8) for _ in range(2)]
    events = [_Event() for _ in range(4)]
    ring.events = [None, events[0]]  # slot 1 was uploaded from before

    def take():
        for b in range(3):
            ring.take(16)
            ring.uploaded(events[b + 1])

    _, _, rec = _profiled(take)
    # the first take reuses slot 0, which no upload has read: no wait;
    # the ring records no span of its own
    assert [e.synced for e in events] == [1, 1, 0, 0]
    assert rec["spans"] == []


class _FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _fake_captured():
    cf = sliding.CapturedForward(lambda v, x: x * v)

    def capture(sig, inputs):
        static_in = [t.clone() for t in inputs]
        static_out = torch.empty_like(inputs[0])
        cf.captures += 1
        graph = _FakeGraph(lambda: static_out.copy_(
            static_in[0] * cf._held[0]))
        return sig, graph, static_in, static_out, [0, 0, 0, 0]

    cf._capture = capture
    cf.use(torch.tensor(2.0))
    return cf


def test_captured_forward_kinds():
    rows = [3, 3, 1, 3, 3, 1]  # two volumes: two full chunks, one ragged

    def calls(cf):
        for i, n in enumerate(rows):
            with tracing.span("volume.chunk", patches=n, kind="eager"):
                x = torch.full((n, 2), float(i))
                assert torch.equal(cf(x), x * 2)

    untraced = _fake_captured()
    calls(untraced)
    cf = _fake_captured()
    _, _, rec = _profiled(lambda: calls(cf))
    kinds = [s["attrs"]["kind"] for s in rec["spans"]]
    assert kinds == ["eager", "capture", "eager", "replay", "replay",
                     "eager"]
    assert untraced.captures == cf.captures == 1
    assert sum(s["attrs"]["patches"] for s in rec["spans"]
               if s["attrs"]["kind"] == "eager") == 5


def test_spans_are_on_the_profilers_clock_and_not_its_events(net):
    def work():
        with tracing.span("feed.stage", batch=0):
            with record_function("inner_range"):
                torch.ones(8).sum()
        return _serve_all(net)

    _, prof, rec = _profiled(work)
    events = list(prof.profiler.kineto_results.events())
    inner, = [e for e in events if e.name() == "inner_range"]
    outer = rec["spans"][0]
    assert outer["start_ns"] <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer["end_ns"]
    names = {s["name"] for s in rec["spans"]}
    assert names >= SERVING
    assert not names & {e.name() for e in events}


def test_a_new_session_starts_a_new_record(net):
    _, _, first = _profiled(lambda: _serve_all(net))
    _, _, second = _profiled(
        lambda: tracing.span("feed.stage", batch=7).__enter__().__exit__())
    assert len(first["spans"]) > 1
    assert [(s["name"], s["batch"]) for s in second["spans"]] == \
        [("feed.stage", 7)]


def test_device_marks_time_host_work_on_the_cpu():
    cpu = torch.device("cpu")
    a = tracing.device_mark(cpu)
    x = torch.ones(256, 256)
    for _ in range(4):
        x = x @ x / 256
    b = tracing.device_mark(cpu)
    assert tracing.device_seconds(a, b) > 0
    assert tracing.device_seconds(b, b) == 0
    # the ADMM's part seconds come from the same marks
    assert admm.device_mark is tracing.device_mark


def test_device_times_add_up_the_marks_in_order():
    def work():
        with tracing.span("volume.extract", device=torch.device("cpu")):
            torch.ones(64, 64).sum()
        with tracing.span("volume.stitch", device=torch.device("cpu")):
            torch.ones(64, 64).sum()

    _, _, rec = _profiled(work)
    a, b = rec["spans"]
    assert a["device_start_ms"] == 0.0
    assert a["device_start_ms"] <= a["device_end_ms"] \
        <= b["device_start_ms"] <= b["device_end_ms"]
    # device times are in ms, host times in ns, of the same stretches
    assert b["device_end_ms"] <= (b["end_ns"] - a["start_ns"]) / 1e6


def test_a_torch_without_the_profiler_hooks_leaves_spans_off(monkeypatch):
    import types

    bare = types.SimpleNamespace(_is_profiler_enabled=True)
    monkeypatch.setattr(tracing, "_profiler", bare)
    assert tracing._install() is False  # nothing to wrap: nothing changed
    assert vars(bare) == {"_is_profiler_enabled": True}
    monkeypatch.setattr(tracing, "_hooked", False)
    assert tracing.span("volume.chunk", patches=1) is tracing._NULL
    tracing.annotate(kind="eager")  # no open span, no error
