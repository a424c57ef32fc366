"""Quantization-aware fine-tuning (QAT) after PTQ calibration.

Counterpart of the JAX package's ``ptq/qat.py``: a short fine-tune of the
calibrated net under the deployed quantization function.
``nnir.apply(train=True, mode="fq")`` fake-quantizes weights and
activations on the fly from the per-layer alphas, and ``quant.discretize``
rounds with a straight-through gradient, so kernels and alphas both train;
the FP ``Trainer`` runs the loop (``apply_mode="fq"``, float32, exact).

After training the latent weights sit off their grids: ``snap_to_grid``
projects every calibrated kernel back, so the export is exactly
deployable.  Each epoch is scored by val dice and the best epoch's
parameters are kept, epoch 0 (the pure-PTQ state) included.
"""
from __future__ import annotations

import dataclasses
import os.path as P
from typing import Any, Dict, Optional, Tuple

import torch

from ..quant import fake_quant_weight


def snap_to_grid(fgraph, variables) -> None:
    """Project latent QAT weights back onto their grids, in place: kernel
    <- fake_quant_weight(kernel, alpha_w, qlvl_w) for every
    weight-quantized conv, alphas clamped to at least 1e-8 (the fake-quant
    algebra needs alpha > 0)."""
    params = variables["params"]
    with torch.no_grad():
        for node in fgraph.qconv_nodes():
            qcfg = node.attrs["qcfg"]
            p = params[node.name]
            if qcfg.q_act and "alpha_act" in p:
                p["alpha_act"] = torch.clamp_min(p["alpha_act"], 1e-8)
            if qcfg.q_weight and "alpha_w" in p:
                p["alpha_w"] = torch.clamp_min(p["alpha_w"], 1e-8)
                p["kernel"] = fake_quant_weight(p["kernel"], p["alpha_w"],
                                                qcfg.qlvl_w)


def run_qat(fgraph, qvars, hub, *, num_mo: int, n_class: int,
            loss_name: str, epochs: int, lr: float, snapshot_root: str,
            multilabel_fusetype=None, display_interval: int = 10,
            weight_decay: float = 0.0, device="cuda"
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fine-tune a calibrated (BN-folded) quantized net for ``epochs``
    epochs over ``hub.trainloader`` on ``device``; returns (variables,
    log) and writes ``qat_loss.txt`` under ``snapshot_root``.

    ``qvars`` is ``run_ptq``'s output and is not changed.  The returned
    variables (on the CPU) are the best-val-dice epoch's, epoch 0
    included, snapped to the grid."""
    from ..eval.validate import validate_seg
    from ..train.trainer import Trainer

    # offset-grid shifts (act_k) are integers, which Adam cannot carry:
    # baked into static node attributes for the fq forward (nnir reads the
    # attribute before the parameter) and re-attached to the result
    act_ks = {}
    qvars = {"params": {k: dict(v) for k, v in qvars["params"].items()},
             "state": dict(qvars.get("state", {}))}
    for name, p in qvars["params"].items():
        if "act_k" in p:
            act_ks[name] = int(p.pop("act_k"))
    if act_ks:
        fgraph = dataclasses.replace(fgraph, nodes=[
            (dataclasses.replace(n, attrs={**n.attrs, "act_k": act_ks[n.name]})
             if n.name in act_ks else n) for n in fgraph.nodes], _index=None)

    trainer = Trainer(
        fgraph, qvars, hub, loss_name=loss_name, num_mo=num_mo,
        n_class=n_class, base_lr=lr, max_epoch=max(int(epochs), 1),
        snapshot_root=snapshot_root, weight_decay=weight_decay,
        warmup_epochs=0, test_interval=10 ** 9,
        display_interval=display_interval,
        multilabel_fusetype=multilabel_fusetype,
        apply_mode="fq", device=device)

    def val_dice() -> Optional[float]:
        # the val split only: epoch selection never sees test data
        if hub.valloader is None:
            return None
        sm = validate_seg(
            fgraph, trainer.variables, hub.valloader, hub.val_sn, num_mo,
            n_class, patch_size=hub.slide_patch_size,
            overlap=hub.slide_overlap, merge_label_func=hub.merge_label_func,
            multilabel_fusetype=multilabel_fusetype, mode="fq",
            device=trainer.device)
        return float(sm[-1].get_metric()["dsc"])

    def host_params():
        return {n: {k: t.detach().cpu().clone() for k, t in e.items()}
                for n, e in trainer.variables["params"].items()}

    history = []
    dice0 = val_dice()
    best = {"epoch": 0, "dice": dice0, "params": host_params()}
    if dice0 is not None:
        print(f"qat: epoch 0 (pure PTQ) val dice {dice0:.4f}")
    for epoch in range(1, int(epochs) + 1):
        trainer.epoch = epoch
        stats = trainer.train_epoch()
        dice = val_dice()
        history.append({"epoch": epoch, "loss": stats["loss"], "dice": dice})
        line = f"qat: epoch {epoch}/{epochs} loss {stats['loss']:.6f}"
        if dice is not None:
            line += f" val dice {dice:.4f}"
            if best["dice"] is None or dice > best["dice"]:
                best = {"epoch": epoch, "dice": dice,
                        "params": host_params()}
                line += "  <- best"
        else:  # no val split: the final epoch is kept
            best = {"epoch": epoch, "dice": None, "params": host_params()}
        print(line)

    out = {"params": best["params"],
           "state": {n: {k: torch.as_tensor(v).cpu() for k, v in e.items()}
                     for n, e in qvars.get("state", {}).items()}}
    for name, k in act_ks.items():
        out["params"][name]["act_k"] = torch.tensor(k, dtype=torch.int32)
    snap_to_grid(fgraph, out)
    log = {"kept_epoch": best["epoch"], "kept_dice": best["dice"],
           "history": history, "seconds": dict(trainer.seconds)}
    with open(P.join(snapshot_root, "qat_loss.txt"), "w") as f:
        if dice0 is not None:
            mark = "  <- kept" if best["epoch"] == 0 else ""
            f.write(f"epoch 0 (pure PTQ): val_dice {dice0:.6f}{mark}\n")
        for h in history:
            mark = "  <- kept" if h["epoch"] == best["epoch"] else ""
            dtxt = "" if h["dice"] is None else f" val_dice {h['dice']:.6f}"
            f.write(f"epoch {h['epoch']}: loss {h['loss']:.8g}{dtxt}{mark}\n")
    return out, log
