"""The harness finds everything a cell names by name, makes the same
traffic from the same seed, and prints the contract's last line."""
import contextlib
import io
import json
import os.path as P

import numpy as np
import pytest
import torch

from bench_torch import run as harness, session, traffic

from . import tiny

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "checks"}


def test_every_cell_resolves_its_files_by_name():
    root = tiny.ROOT
    b = harness.load_json(P.join(root, "BENCHMARK.json"))
    for w in b["workloads"]:
        cell = harness.Cell(w["name"], root, tiny.BENCH)
        assert P.exists(cell.driver_path)
        assert cell.cfg["name"] == w["config"]
        harness.load_module(cell.driver_path, "driver").run  # noqa: B018
        assert [m["name"] for m in cell.metrics("end_to_end")]
        layer = cell.metrics("per_layer")
        assert layer
        for m in layer:
            assert callable(cell.reader(m["name"]).read)
            moves = [e for e in cell.metrics("end_to_end")
                     if e["name"] == m["moves"]]
            assert moves, (w["name"], m["name"])
    files = {c["file"] for c in b["configs"]}
    assert files == {f"bench_torch/configs/{c['name']}.json"
                     for c in b["configs"]}
    for path in files:
        assert P.exists(P.join(tiny.ROOT, path))
    # every metric's cells exist, and report the metric it moves
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_new_cell_config_and_metric_are_found_from_added_files(tmp_path):
    root, bench = tiny.make(tmp_path)
    with open(P.join(bench, "configs", "lits_uresq_w4a4.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "lits_uresq_w4a4_copy"
    with open(P.join(bench, "configs", "lits_uresq_w4a4_copy.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(P.join(bench, "traffic", "stream_fixed.json"), "w") as f:
        json.dump({"driver": "serve", "volume": [32, 32, 16], "pool": 2,
                   "check_every": 2}, f)
    with open(P.join(bench, "metrics", "chunks_per_s.py"), "w") as f:
        f.write("def read(out):\n"
                "    return len(out['chunks']) / out['trace'].window_s\n")
    with open(P.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": "lits_w4a4.fixed", "chips": 1,
                           "config": "lits_uresq_w4a4_copy",
                           "traffic": "stream_fixed", "why": "test"})
    b["per_layer"].append({"name": "chunks_per_s", "unit": "1/s",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving loop", "moves": "volumes_per_s",
                           "workloads": ["lits_w4a4.fixed"]})
    for m in b["end_to_end"]:
        if m["name"] in ("volumes_per_s", "volume_p95_ms"):
            m["workloads"].append("lits_w4a4.fixed")
    with open(P.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = harness.Cell("lits_w4a4.fixed", root, bench)
    assert cell.cfg["name"] == "lits_uresq_w4a4_copy"
    assert [m["name"] for m in cell.metrics("per_layer")] == ["chunks_per_s"]
    line = run_line(root, bench, "lits_w4a4.fixed", trace=1)
    assert set(line["metrics"]) == {"chunks_per_s"}


def test_seeded_traffic_repeats_for_a_seed_and_differs_between_seeds():
    cell = harness.Cell("lits_w4a4.serve_varied_depth", tiny.ROOT)
    mix = dict(cell.mix, base=[40, 40], depths=[24, 16, 32, 20])
    dev = torch.device("cpu")
    a = traffic.make_pool(cell.cfg, mix, 2 ** 31 + 5, dev)
    b = traffic.make_pool(cell.cfg, mix, 2 ** 31 + 5, dev)
    c = traffic.make_pool(cell.cfg, mix, 2 ** 31 + 6, dev)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    # every seed serves the same sizes in the same order
    assert [x.shape for x in a] == [x.shape for x in c]
    assert [x.shape[1:] for x in a] == traffic.volume_shapes(mix)


def test_lits_depths_stay_in_64_to_256():
    mix = harness.load_json(P.join(tiny.BENCH, "traffic",
                                   "stream_varied_depth.json"))
    shapes = traffic.volume_shapes(mix)
    depths = [s[2] for s in shapes]
    assert len(shapes) == 16 and len(set(depths)) == 16
    assert min(depths) == 64 and max(depths) == 256
    assert all(s[:2] == (256, 256) for s in shapes)
    # evenly spread: every gap between sorted depths is 12 or 13
    gaps = np.diff(sorted(depths))
    assert set(gaps.tolist()) <= {12, 13}


def test_sample_spreads_over_the_whole_window():
    cell = harness.Cell("lits_w4a4.serve_varied_depth", tiny.ROOT)
    sizes = [d for _, _, d in traffic.volume_shapes(cell.mix)]
    batches = [([v], None) for v in range(len(sizes))]
    every = cell.mix["check_every"]
    offsets = set()
    for seed in range(2 ** 31, 2 ** 31 + 20):
        sample = session.Sample(cell.mix, seed, batches, sizes)
        pos = sample.positions(600)
        offsets.add(sample.offset)
        # the largest volume's first serving, then one in every ``every``
        assert sizes.index(max(sizes)) in pos
        rest = [p for p in pos if p % every == sample.offset]
        assert len(rest) == 6 and max(rest) >= 500
        assert set(pos) == set(rest) | {sample.largest}
    assert len(offsets) > 10


def run_line(root, bench, cell, trace=0, seed=2 ** 31 + 17, seconds=1.0):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          root=root, device="cpu", bench=bench)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_exactly_the_contracts_keys(tmp_path, trace):
    root, bench = tiny.make(tmp_path)
    line = run_line(root, bench, "lits_w4a4.serve_fixed_depth",
                    trace=trace)
    keys = LINE_KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks" and set(line) == keys
    assert set(line["device"]) == ({"platform", "kind", "count",
                                    "memory_peak_bytes"}
                                   | ({"busy_s", "window_s"} if trace
                                      else set()))
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"volumes_per_s", "volume_p95_ms",
                                        "setup_s"}
        assert all(set(m) == {"value", "unit"}
                   for m in line["metrics"].values())
    assert line["correct"] is True and line["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_no_card_means_exit_1_and_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "lits_w4a4.serve_fixed_depth", "--seed",
                       "1", "--seconds", "1"])
    assert rc == 1
    assert capsys.readouterr().out == ""
