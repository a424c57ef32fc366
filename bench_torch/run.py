"""One run of one cell of ``BENCHMARK.json``:

    python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell names its configuration
(``configs/<config>.json``) and traffic mix (``traffic/<mix>.json``); the
mix names its driver (``drivers/<driver>.py``), which sets up, measures
for ``--seconds`` and checks what the window served; with ``--trace 1``
each per-layer metric is read by ``metrics/<metric>.py`` from the traced
window.  The last line of standard output is the result, as JSON.  No
card, or fewer than the cell asks for: exit 1 and no result.
"""
from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import os.path as P  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

BENCH = P.dirname(P.abspath(__file__))


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock, from the
    kernel's record of it; the import of this module where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    now = time.perf_counter()
    return now - age if 0 <= age < now - _T_IMPORT + 60 else _T_IMPORT


T_START = _process_start()


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the harness's data folders, by file path."""
    spec = importlib.util.spec_from_file_location(
        "bench_torch._" + name.replace(".", "_").replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell with everything it names, found by name under ``bench``."""

    def __init__(self, name: str, root: str, bench: str = BENCH):
        self.benchmark = load_json(P.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in cells:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.cell = cells[name]
        self.bench = bench
        self.cfg = load_json(P.join(bench, "configs",
                                    self.cell["config"] + ".json"))
        self.mix = load_json(P.join(bench, "traffic",
                                    self.cell["traffic"] + ".json"))
        self.driver_path = P.join(bench, "drivers", self.mix["driver"] + ".py")
        if not P.exists(self.driver_path):
            raise SystemExit(f"no driver {self.mix['driver']!r}")

    def metrics(self, kind: str):
        """The cell's metrics of ``kind`` (``end_to_end``, ``per_layer``)."""
        return [m for m in self.benchmark[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(P.join(self.bench, "metrics", metric + ".py"),
                           "metric_" + metric)


class Run:
    """What a driver gets: the cell, the seed, the window's length, the
    trace switch and the device; ``setup_done()`` marks the window's
    start."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device):
        self.cfg, self.mix = cell.cfg, cell.mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        # the limits of the check: the configuration's, and the mix's own
        self.limits = {**cell.cfg.get("limits", {}),
                       **cell.mix.get("limits", {})}
        self.t_start = T_START
        self.setup_s: Optional[float] = None

    def setup_done(self) -> float:
        self.setup_s = time.perf_counter() - self.t_start
        return self.setup_s


def _cache_dirs(bench: str = BENCH):
    """Every build and kernel cache inside the checkout, at fixed paths
    under ``<bench>/cache``: the port's autotuner, Triton, torch
    extensions, the CUDA JIT (the port's own kernels build into
    ``efficientq_tpu_torch/_build``)."""
    cache = P.join(bench, "cache")
    for var, sub in (("EFFQ_TUNE_CACHE", "tune.json"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = P.join(cache, sub)
    os.makedirs(cache, exist_ok=True)


def result_line(cell: Cell, run: Run, out: Dict, device_info: Dict) -> Dict:
    """The contract's last line from a driver's result ``out``."""
    metrics = {}
    if run.trace:
        tr = out["trace"]
        device_info = dict(device_info, busy_s=tr.busy_s,
                           window_s=tr.window_s)
        for m in cell.metrics("per_layer"):
            v = cell.reader(m["name"]).read(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=run.setup_s)
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if run.trace:
        tr = out["trace"]
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = out["checks"]
    return line


def main(argv=None, root: Optional[str] = None, device=None,
         bench: str = BENCH) -> int:
    """``device``: run there without looking for a card (the harness's own
    tests, on the CPU); the command line always asks for the card."""
    ap = argparse.ArgumentParser(prog="python3 -m bench_torch.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or P.dirname(bench)
    cell = Cell(args.workload, root, bench)
    _cache_dirs(bench)
    import torch

    chips = int(cell.cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"this cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
    else:
        device = torch.device(device)
        kind = str(device)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device)
    driver = load_module(cell.driver_path, "driver_" + cell.mix["driver"])
    out = driver.run(run)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": kind, "count": chips,
            "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(cell, run, out, info)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
