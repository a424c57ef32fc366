"""A copy of the benchmark at CPU sizes for the harness's tests: the
repository's BENCHMARK.json, drivers and metric readers, and its
configurations and mixes with small patches and volumes."""
import json
import os
import os.path as P
import shutil

BENCH = P.dirname(P.dirname(P.abspath(__file__)))
ROOT = P.dirname(BENCH)

# per file: the keys the CPU copy changes (the networks keep their widths)
SMALL = {
    "configs/lits_uresq_w4a4.json": dict(patch=[32, 32, 16],
                                         overlap=[4, 4, 4]),
    "traffic/stream_varied_depth.json": dict(
        base=[40, 40], depths=[24, 16, 32, 20], check_every=2),
    "traffic/stream_fixed_depth.json": dict(volume=[40, 40, 24],
                                            check_every=2),
}


def make(tmp):
    """(root, bench) of a CPU-sized copy under ``tmp``."""
    root = str(tmp)
    bench = P.join(root, "bench_torch")
    for sub in ("drivers", "metrics"):
        shutil.copytree(P.join(BENCH, sub), P.join(bench, sub))
    for sub in ("configs", "traffic"):
        os.makedirs(P.join(bench, sub))
        for name in os.listdir(P.join(BENCH, sub)):
            rel = f"{sub}/{name}"
            with open(P.join(BENCH, rel)) as f:
                data = json.load(f)
            data.update(SMALL.get(rel, {}))
            with open(P.join(bench, rel), "w") as f:
                json.dump(data, f)
    shutil.copy(P.join(ROOT, "BENCHMARK.json"), root)
    return root, bench
