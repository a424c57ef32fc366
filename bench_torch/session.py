"""What the drivers share: the set-up of a served net and its traffic,
the warm-up's order, the check's sample, and the reference's readings of
what the window served."""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from bench_torch import check, model, program, traffic


def mark(run, what: str):
    """A line on standard error: seconds since the process started, and
    the set-up step just done."""
    print(f"setup {time.perf_counter() - run.t_start:8.3f} s  {what}",
          file=sys.stderr, flush=True)


def setup(run):
    """(deployed graph, variables, weights, batches, per-volume sizes):
    everything the window needs, made from the seed."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    mark(run, "imports")
    sd = model.make_weights(cfg, run.seed, dev)
    mark(run, "weights made")
    dgraph, dvars = program.build(cfg, sd, dev)
    mark(run, "net built and deployed")
    pool = traffic.make_pool(cfg, mix, run.seed, dev)
    sizes = [img.numel() for img in pool]
    batches = traffic.batches(pool, int(mix.get("batch",
                                                cfg["test_batch_size"])))
    del pool
    mark(run, "volumes made and handed to the host")
    return dgraph, dvars, sd, batches, sizes


def warm_order(batches, mix):
    """The warm-up's batches: the first ``warmup_batches`` (0: all)."""
    n = int(mix.get("warmup_batches", 0)) or len(batches)
    return list(range(min(n, len(batches))))


class Sample:
    """The volumes the check compares, by sequence number in the window:
    every ``check_every``-th from an offset drawn from the seed, so the
    sample spreads over the whole window however many it serves, and the
    first serving of the pool's largest volume."""

    def __init__(self, mix, seed, batches, sizes):
        gen = torch.Generator().manual_seed(model._seed(seed, 3))
        self.every = int(mix["check_every"])
        self.offset = int(torch.randint(self.every, (1,), generator=gen))
        largest = max(range(len(sizes)), key=lambda v: sizes[v])
        n_vol = len(batches[0][0])
        self.largest = next(k * n_vol + j for k in range(len(batches))
                            for j, v in enumerate(batches[k][0])
                            if v == largest)

    def __contains__(self, position: int) -> bool:
        return (position % self.every == self.offset
                or position == self.largest)

    def positions(self, served: int):
        """The sampled sequence numbers among the first ``served``."""
        return [p for p in range(served) if p in self]


def volume_at(batches, position):
    """The pool volume served at sequence number ``position``."""
    n_vol = len(batches[0][0])
    return batches[(position // n_vol) % len(batches)][0][position % n_vol]


def image_of(batches, v):
    """Pool volume ``v``'s image, (C, D, H, W) NumPy."""
    for idx, imgs in batches:
        if v in idx:
            return imgs[idx.index(v)]
    raise KeyError(v)


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 allowed (or not) for float32 convs and matmuls inside."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def reference_readings(cfg, sd, batches, served, dev, tf32=False):
    """The check's numbers of each (pool volume, served final-head
    prediction) of ``served``, against the reference in float32.  With
    ``tf32`` the control: the reference in TF32 (``model.Reference``),
    put in the program's place (``served`` holds pool volumes alone)."""
    multilabel = cfg.get("multi_label") is not None
    net = model.Reference(cfg, sd)
    low = model.Reference(cfg, sd, tf32=True)
    out, ref_of = [], None
    for v, pred in sorted(served, key=lambda s: s[0]):
        vol = torch.from_numpy(image_of(batches, v)).to(dev)
        if ref_of != v:  # one reference run per pool volume
            ref = None
            with precision(False):
                ref = model.volume_logits(net, vol)[-1]
            ref_of = v
        if tf32:
            with precision(True):
                pred = check.hard(model.volume_logits(low, vol)[-1],
                                  multilabel)
        else:
            pred = torch.from_numpy(pred).to(dev)
        out.append(check.numbers(pred, ref, multilabel))
        del vol, pred
    return out
