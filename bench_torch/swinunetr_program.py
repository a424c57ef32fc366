"""The system under test of the SwinUNETR cell: the port's SwinUNETR,
built and deployed as ``infer --deploy int8`` builds it from a PTQ export,
and the set-up and readings that differ from UResQ's (``session``).  With
``program`` (whose serving calls the drivers share), the only module of
the cell that imports the port; a port without SwinUNETR fails here, at
once."""
from __future__ import annotations

from typing import Dict

import torch

from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.models import (SwinUNETRConfig, build_swin_unetr,
                                         torch_io)
from efficientq_tpu_torch.ptq import to_int8_inference
from efficientq_tpu_torch.ptq.deploy import serving_graph

from . import check, program, session, swinunetr_model, traffic

# the configuration's keys of SwinUNETRConfig's fields
_ARCH = ("num_mod", "num_classes", "feature_size", "depths", "num_heads",
         "window_size", "patch_size", "mlp_ratio", "norm_eps")


def config(cfg: Dict) -> SwinUNETRConfig:
    """The port's SwinUNETRConfig of the configuration file."""
    return SwinUNETRConfig(
        **{k: cfg[k] for k in _ARCH}, quantize=True, qlvl_w=cfg["qlvl_w"],
        qlvl_act=cfg["qlvl_act"], q_first=tuple(cfg["q_first"]),
        q_last=tuple(cfg["q_last"]))


def build(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    """(deployed graph, its variables on ``device``): the port's graph, the
    export ``sd`` loaded (its keys must be exactly the graph's), then the
    int8 deployment rewrite."""
    if cfg["deploy"] != "int8":
        raise ValueError(f"deploy {cfg['deploy']!r}: the harness serves "
                         f"the int8 deployment")
    graph = build_swin_unetr(config(cfg))
    v = nnir.init(graph, 0, device="cpu")
    for c in swinunetr_model.layers(cfg):
        if c.act_k:
            v["params"][c.name]["act_k"] = torch.tensor(c.act_k,
                                                        dtype=torch.int32)
    want = set(torch_io.to_torch_state_dict(graph, v))
    if set(sd) != want:
        raise ValueError(f"export keys differ from the port's graph: "
                         f"{sorted(set(sd) ^ want)[:8]}")
    v = torch_io.load_torch_state_dict(
        graph, v, {k: t.cpu().numpy() for k, t in sd.items()}, strict=True)
    dgraph, dvars = to_int8_inference(graph, v)
    return dgraph, nnir.to_device(dvars, device)


def k1_flags(dgraph):
    """Each K1 node's epilogue flags as the served graph has them
    (``program.k1_flags`` after ``serving_graph``: the offset-grid convs
    join K1 there, and K6 hands conv2 its int8 codes)."""
    return program.k1_flags(serving_graph(dgraph))


def setup(run):
    """(deployed graph, variables, weights, batches, per-volume sizes):
    ``session.setup`` with SwinUNETR's weights and build."""
    cfg, mix, dev = run.cfg, run.mix, run.device
    session.mark(run, "imports")
    sd = swinunetr_model.make_weights(cfg, run.seed, dev)
    session.mark(run, "weights made")
    dgraph, dvars = build(cfg, sd, dev)
    session.mark(run, "net built and deployed")
    pool = traffic.make_pool(cfg, mix, run.seed, dev)
    sizes = [img.numel() for img in pool]
    batches = traffic.batches(pool, int(mix.get("batch",
                                                cfg["test_batch_size"])))
    del pool
    session.mark(run, "volumes made and handed to the host")
    return dgraph, dvars, sd, batches, sizes


def reference_readings(cfg, sd, batches, served, dev, tf32=False):
    """``session.reference_readings`` against SwinUNETR's reference: the
    check's numbers of each (pool volume, served prediction) of
    ``served``; with ``tf32`` the control, the reference in TF32 in the
    program's place."""
    multilabel = cfg.get("multi_label") is not None
    net = swinunetr_model.Reference(cfg, sd)
    low = swinunetr_model.Reference(cfg, sd, tf32=True)
    out, ref_of = [], None
    for v, pred in sorted(served, key=lambda s: s[0]):
        vol = torch.from_numpy(session.image_of(batches, v)).to(dev)
        if ref_of != v:  # one reference run per pool volume
            ref = None
            ref = swinunetr_model.volume_logits(net, vol)[-1]
            ref_of = v
        if tf32:
            pred = check.hard(swinunetr_model.volume_logits(low, vol)[-1],
                              multilabel)
        else:
            pred = torch.from_numpy(pred).to(dev)
        out.append(check.numbers(pred, ref, multilabel))
        del vol, pred
    return out


def control_readings(cfg, mix, seed, device, served=500):
    """The control's worst numbers on ``seed``'s sample of volumes (the
    volumes a window serving ``served`` volumes compares)."""
    sd = swinunetr_model.make_weights(cfg, seed, device)
    pool = traffic.make_pool(cfg, mix, seed, device)
    sizes = [img.numel() for img in pool]
    batches = traffic.batches(pool, int(mix.get("batch",
                                                cfg["test_batch_size"])))
    del pool
    sample = session.Sample(mix, seed, batches, sizes)
    vols = [session.volume_at(batches, p) for p in sample.positions(served)]
    return check.worst(reference_readings(
        cfg, sd, batches, [(v, None) for v in vols], device, tf32=True))
