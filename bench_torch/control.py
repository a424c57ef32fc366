"""The readings that a cell's limits are set from, in one process:

    python3 -m bench_torch.control --workload <cell> --seeds 1,2,...
        [--control-seeds 101,102,103] [--seconds 3] [--served 500]

For each of ``--seeds`` a run of the cell's driver with a short window at
the cell's own load, and the check's numbers of what it served (the
program's readings: the lower end of each limit).  For each of
``--control-seeds`` the control on the volumes that a window serving
``--served`` volumes compares (the upper end): the plain reference with
TF32 allowed, put in the program's place, the step below the
configuration's float32 with TF32 off.  One JSON line per seed, then the
largest program reading and the smallest control reading of each number.
Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os.path as P
import sys

import torch

from bench_torch import check, model, run as harness, session, traffic


def program_readings(cell, seed, seconds, device):
    r = harness.Run(cell, seed, seconds, False, device)
    driver = harness.load_module(cell.driver_path,
                                 "driver_" + cell.mix["driver"])
    out = driver.run(r)
    return {k: v["value"] for k, v in out["checks"].items()}, out


def control_readings(cfg, mix, seed, device, served=500):
    """The control's worst numbers on ``seed``'s sample of volumes."""
    sd = model.make_weights(cfg, seed, device)
    pool = traffic.make_pool(cfg, mix, seed, device)
    sizes = [img.numel() for img in pool]
    batches = traffic.batches(pool, int(mix.get("batch",
                                                cfg["test_batch_size"])))
    del pool
    sample = session.Sample(mix, seed, batches, sizes)
    vols = [session.volume_at(batches, p) for p in sample.positions(served)]
    return check.worst(session.reference_readings(
        cfg, sd, batches, [(v, None) for v in vols], device, tf32=True))


def main(argv=None, root=None, device=None):
    ap = argparse.ArgumentParser(prog="python3 -m bench_torch.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--served", type=int, default=500)
    args = ap.parse_args(argv)
    root = root or P.dirname(harness.BENCH)
    cell = harness.Cell(args.workload, root)
    harness._cache_dirs()
    if device is None:
        if not torch.cuda.is_available():
            print("the control needs a CUDA device", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
    prog, ctrl = [], []
    for s in [int(x) for x in args.seeds.split(",") if x]:
        worst, out = program_readings(cell, s, args.seconds, device)
        prog.append(worst)
        print(json.dumps({"seed": s, "program": worst,
                          "volumes_per_s": out["e2e"]}), flush=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        worst = control_readings(cell.cfg, cell.mix, s, device, args.served)
        ctrl.append(worst)
        print(json.dumps({"seed": s, "control": worst}), flush=True)
    summary = {"program_max": check.worst(prog)}
    if ctrl:
        summary["tf32_min"] = {k: min(c[k] for c in ctrl) for k in ctrl[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
