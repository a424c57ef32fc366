"""Closed-loop whole-volume serving of a BraTS network other than UResQ:
``serve``'s loop (``drivers/serve.py``) over the port's network that the
configuration's ``model`` names, whose set-up and check come from the
harness module ``<model>_program`` (``swinunetr_program`` for SwinUNETR,
``segresnet_program`` for SegResNet).  One stream of loader batches
through the port's label-free pipeline (``eval/validate.py``'s
``_pipeline`` with ``_build_infer``: pinned upload, captured inferencer,
the multi-label decision, readback), the next batch handed over as soon
as the pipeline asks.

Set-up: weights from the seed, the deployed net, the mix's pool made on
the card and handed over as the loader's NumPy batches; the warm-up serves
the mix's first batches (the same shapes for every seed), so the
inferencer is built and captured before the window.

Window and metrics as ``serve``'s: ``volumes_per_s`` over the volumes
whose prediction reached host memory in the window, ``volume_p95_ms`` from
each batch's hand-over to its prediction in host memory.

Check: the volumes of the seeded sample (``session.Sample``) against the
plain reference of the program module (``swinunetr_model.Reference``).
The result has the keys of ``serve``'s, so the same span readers read
it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import statistics
import time

import torch

from bench_torch import check, program, session
from bench_torch.trace import span, traced


def program_module(cfg):
    """The harness module of the configuration's model."""
    return importlib.import_module(
        f"bench_torch.{cfg['model'].lower()}_program")


def run(run):
    cfg, mix, dev = run.cfg, run.mix, run.device
    prog = program_module(cfg)
    dgraph, dvars, sd, batches, sizes = prog.setup(run)
    serve = program.make_serve(dgraph, dvars, cfg, dev, all_heads=False)
    warm = ((batches[b][1], None) for b in session.warm_order(batches, mix))
    for _ in program.pipeline(warm, dev, serve):
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize()
    session.mark(run, "warmed up")
    run.setup_done()

    n_vol = len(batches[0][0])
    keep = session.Sample(mix, run.seed, batches, sizes)
    kept, handed, done, chunks, traced_out = {}, [], [], [], {}
    window = {}

    def loader():
        k = 0
        t_end = window["t0"] + run.seconds
        while time.perf_counter() < t_end:
            with span("loader"):
                b = k % len(batches)
                handed.append(time.perf_counter())
            yield batches[b][1], (k, b)
            k += 1

    with traced(run.trace, traced_out, dev), \
            (program.instrumented(chunks) if run.trace
             else contextlib.nullcontext()):
        window["t0"] = t0 = time.perf_counter()
        for pred, (k, b) in program.pipeline(loader(), dev, serve):
            done.append(time.perf_counter())
            for j in range(n_vol):
                if k * n_vol + j in keep:
                    kept[k * n_vol + j] = (batches[b][0][j],
                                           pred[0, j].copy())
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    t_end = t0 + run.seconds
    in_window = [t for t in done if t <= t_end]
    lat = sorted((d - h) * 1e3 for h, d in zip(handed, done)
                 for _ in range(n_vol))
    e2e = {"volumes_per_s": (n_vol * len(in_window) / (in_window[-1] - t0)
                             if in_window else 0.0),
           "volume_p95_ms": (statistics.quantiles(lat, n=20)[18]
                             if len(lat) > 1 else lat[0])}

    flags = prog.k1_flags(dgraph)
    del serve, dvars, dgraph
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = prog.reference_readings(
        cfg, sd, batches, [kept[p] for p in sorted(kept)], dev)
    correct, checks = check.judge(check.worst(readings), run.limits)
    return {"correct": correct and len(readings) > 0,
            "attempted": n_vol * len(handed),
            "failed": n_vol * (len(handed) - len(done)), "checks": checks,
            "readings": readings, "e2e": e2e,
            "memory_peak_bytes": memory_peak,
            "trace": traced_out.get("trace"), "cfg": cfg, "chunks": chunks,
            "k1_flags": flags}
