"""FP training engine (PyTorch).

Counterpart of the JAX package's ``train/trainer.py`` (the reference's
``src/utils/trainer.py``): the epoch loop with display and test
intervals, the train step (forward in ``nnir.apply(train=True)``, the
deep-supervision loss, backward, value-clipped Adam at the poly/warmup
learning rate), online validation with best-metric (``seg_max``) tracking
after epoch 10, latest and periodic snapshots, the ``description.txt`` /
``loss.txt`` / ``seg_metric.txt`` sinks, resume, and the final compressed
export.

The step runs on ``device`` (the card unless told ``"cpu"``).  Batches go
up through ``data.prefetch.device_feed``; the loss scalars stay on the
device and are read back once per epoch, so the host loop never waits on
a step.  With ``apply_mode="fq"`` the same loop is the quantization-aware
fine-tune (``ptq/qat.py``): weights and activations fake-quantized on the
fly, straight-through rounding, float32 in exact precision.

Snapshots are pickles with the JAX package's keys: ``epoch``,
``state_dict`` (NumPy arrays under ``torch_io.to_torch_state_dict``'s
names), ``opt_state`` (this package's Adam moments, NumPy arrays keyed
``<node>.<param>``), ``step_idx`` and ``max_metric``; either package's
``ptq --pretrain`` reads either package's snapshot.
"""
from __future__ import annotations

import collections
import os
import os.path as P
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import nnir, ops
from ..data.prefetch import device_feed
from ..eval.validate import validate_seg
from ..models import torch_io
from .losses import get_loss, head_loss_weights, multi_output_loss
from .schedule import make_optimizer


class Trainer:
    """``tf32``: whether the float32 convs of the step may use TF32; None
    (the default) allows it in ``fp`` mode and keeps ``fq`` exact.
    ``seconds`` accumulates the host's time by part: ``data`` (waiting for
    the next batch), ``steps`` (issuing steps and the epoch-end readback),
    ``validation`` and ``snapshots``."""

    def __init__(self, graph, variables, data_cube, *, loss_name: str,
                 num_mo: int, n_class: int, base_lr: float, max_epoch: int,
                 snapshot_root: str, weight_decay: float = 0.0,
                 warmup_epochs: int = 1, test_interval: int = 50,
                 display_interval: int = 10, multilabel_fusetype=None,
                 tb_writer=None, remat: int = 0, amp: bool = False,
                 apply_mode: str = "fp", tf32: Optional[bool] = None, device="cuda"):
        assert apply_mode in ("fp", "fq")
        self.graph = graph
        self.device = torch.device(device)
        self.data = data_cube
        self.num_mo = num_mo
        self.n_class = n_class
        self.max_epoch = max_epoch
        self.root = snapshot_root
        self.test_interval = test_interval
        self.display_interval = display_interval
        self.multilabel_fusetype = multilabel_fusetype
        self.tb_writer = tb_writer
        self.remat = int(remat)
        self.amp = bool(amp)
        self.apply_mode = apply_mode
        # --amp: per-node bfloat16 casts in the FP forward; QAT stays
        # float32 (a half-width round flips 2-bit codes)
        self.compute_dtype = (torch.bfloat16 if amp and apply_mode == "fp"
                              else None)
        self.tf32 = apply_mode == "fp" if tf32 is None else bool(tf32)
        os.makedirs(snapshot_root, exist_ok=True)

        iters_per_epoch = max(len(data_cube.trainloader), 1)
        self._lr_args = (base_lr, iters_per_epoch * max_epoch,
                         warmup_epochs * iters_per_epoch, weight_decay)
        self._adopt(variables)
        self.loss_fn = get_loss(loss_name)
        self.head_w = head_loss_weights(num_mo).to(self.device)
        self.step_idx = 0
        self.epoch = 0
        self.start_epoch = 1
        self.max_seg_metric_val = 0.0
        self.seconds = collections.Counter()
        with open(P.join(snapshot_root, "description.txt"), "w") as f:
            f.write(f"loss={loss_name} lr={base_lr} epochs={max_epoch} "
                    f"warmup_epochs={warmup_epochs} wd={weight_decay}\n")
            for node in graph.nodes:
                f.write(f"{node.name}: {node.op} {node.attrs}\n")

    def _adopt(self, variables):
        """Own ``variables`` as device tensors (float parameters as leaves
        that take gradients) and start a fresh optimizer over them."""
        def own(v, grad):
            t = torch.as_tensor(v).detach().to(self.device).clone()
            return t.requires_grad_(grad and t.is_floating_point())

        self.variables = {
            "params": {n: {k: own(v, True) for k, v in e.items()}
                       for n, e in variables["params"].items()},
            "state": {n: {k: own(v, False) for k, v in e.items()}
                      for n, e in variables.get("state", {}).items()}}
        self._leaves = {f"{n}.{k}": t
                        for n, e in self.variables["params"].items()
                        for k, t in e.items() if t.requires_grad}
        self.optimizer, self.schedule = make_optimizer(
            list(self._leaves.values()), *self._lr_args)

    # ------------------------------------------------------------------
    def train_step(self, x, y):
        """One optimizer step on an NCDHW batch ``x`` and its targets
        ``y`` (tensors on the device).  Returns (loss, per-head losses) as
        device tensors."""
        with ops.conv_precision(self.tf32):
            total, arr, new_state = self.forward(x, y)
            total.backward()
        self.update(new_state)
        return total.detach(), arr.detach()

    def forward(self, x, y):
        """The step's forward and loss, gradients cleared: (loss, per-head
        losses, new BN state).  The caller runs the backward under
        ``ops.conv_precision(self.tf32)``, then ``update``."""
        for p in self._leaves.values():
            p.grad = None
        x = ops.ncdhw_to_ndhwc(x).contiguous()
        out, new_state = nnir.apply(
            self.graph, self.variables, x, train=True,
            seed=self.step_idx, remat=self.remat,  # the step seeds dropout
            compute_dtype=self.compute_dtype, mode=self.apply_mode,
            tf32=self.tf32)
        total, arr = multi_output_loss(self.loss_fn, self.head_w,
                                       out.movedim(-1, 2), y)
        return total, arr, new_state

    def update(self, new_state):
        """Clip the gradients, take the Adam step at this step's learning
        rate, and adopt the new BN running stats."""
        torch.nn.utils.clip_grad_value_(list(self._leaves.values()), 1.0)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step_idx)
        self.optimizer.step()
        self.variables["state"].update(new_state)
        self.step_idx += 1

    def train_epoch(self) -> Dict[str, float]:
        """One epoch over the train loader; the losses are read back once,
        at its end, and a non-finite one prints ``NaN``."""
        loss_buf, arr_buf = [], []
        feed = iter(device_feed(self.data.trainloader, device=self.device))
        while True:
            t0 = time.perf_counter()
            batch = next(feed, None)
            t1 = time.perf_counter()
            self.seconds["data"] += t1 - t0
            if batch is None:
                break
            loss, arr = self.train_step(*batch)
            loss_buf.append(loss)
            arr_buf.append(arr)
            self.seconds["steps"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        losses = torch.stack(loss_buf).cpu().numpy()
        arr_mean = torch.stack(arr_buf).mean(dim=0).cpu().numpy()
        self.seconds["steps"] += time.perf_counter() - t0
        if not np.all(np.isfinite(losses)):
            print("NaN")
        loss_dict = {"loss": float(np.mean(losses))}
        for i in range(-len(arr_mean), 0):
            loss_dict[f"loss/{i}"] = float(arr_mean[i])
        return loss_dict

    def current_lr(self) -> float:
        return float(self.schedule(self.step_idx))

    # ------------------------------------------------------------------
    def validate_online(self, epoch: int, seg_metricF=None
                        ) -> Dict[str, float]:
        t0 = time.perf_counter()
        metric_dict: Dict[str, float] = {}
        for split, loader, sns in (("val", self.data.valloader,
                                    self.data.val_sn),
                                   ("test", self.data.testloader,
                                    self.data.test_sn)):
            if loader is None:
                continue
            # QAT: the latent weights are off the grid mid-training, so
            # the evaluation quantizes them on the fly (mode 'fq')
            sm = validate_seg(
                self.graph, self.variables, loader, sns, self.num_mo,
                self.n_class, patch_size=self.data.slide_patch_size,
                overlap=self.data.slide_overlap,
                merge_label_func=self.data.merge_label_func,
                multilabel_fusetype=self.multilabel_fusetype,
                mode=self.apply_mode, device=self.device)
            for k, v in sm[-1].get_metric().items():
                metric_dict[f"{split}/seg_{k}"] = v
            if split == "val" and seg_metricF is not None:
                sm[-1].write_csv(epoch, seg_metricF)
                seg_metricF.flush()
        self.seconds["validation"] += time.perf_counter() - t0
        return metric_dict

    def _run_epoch(self, profile_dir):
        if not profile_dir:
            return self.train_epoch()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            loss_dict = self.train_epoch()
        prof.export_chrome_trace(P.join(profile_dir, "train_epoch.json"))
        return loss_dict

    def train(self):
        loss_all = []
        lossF = open(P.join(self.root, "loss.txt"), "a")
        seg_metricF = open(P.join(self.root, "seg_metric.txt"), "a")
        start = time.time()
        profile_dir = os.environ.get("EFFQ_PROFILE_DIR")
        try:
            for epoch in range(self.start_epoch, self.max_epoch + 1):
                # EFFQ_PROFILE_DIR: a torch.profiler trace of the second
                # epoch (the first one pays the warm-up)
                loss_dict = self._run_epoch(
                    profile_dir if epoch == self.start_epoch + 1 else None)
                loss_all.append(loss_dict["loss"])
                self.epoch = epoch
                if (epoch % self.display_interval == 0
                        or epoch == self.start_epoch):
                    avg = float(np.mean(loss_all[-self.display_interval:]))
                    el = time.time() - start
                    print(f"Epoch {epoch}: loss = {avg:.5f}, "
                          f"lr = {self.current_lr():.5e}, elapsed {el:.0f}s")
                    lossF.write("%d,%.7f\n" % (epoch, avg))
                    lossF.flush()
                if self.tb_writer:
                    self.tb_writer.add_scalar("Learning Rate",
                                              self.current_lr(), epoch)
                    for k, v in loss_dict.items():
                        self.tb_writer.add_scalar(k, float(v), epoch)
                if (epoch % self.test_interval == 0
                        or epoch == self.start_epoch):
                    metric_dict = self.validate_online(epoch, seg_metricF)
                    val_dsc = metric_dict.get("val/seg_dsc", 0.0)
                    self.snapshot(epoch, "latest")
                    if self.max_seg_metric_val < val_dsc and epoch > 10:
                        self.max_seg_metric_val = val_dsc
                        self.snapshot(epoch, "seg_max")
                    if self.tb_writer:
                        for k, v in metric_dict.items():
                            self.tb_writer.add_scalar(k, float(v), epoch)
        except KeyboardInterrupt:
            self.snapshot(self.epoch, "KeyboardInterrupt")
            raise
        finally:
            lossF.close()
            seg_metricF.close()
        self.snapshot(self.max_epoch)
        self.final_snap("FP")
        # transient snapshot cleanup (trainer.py:152-155)
        for stem in ("state_0001", "state_current", "state_latest",
                     "state_KeyboardInterrupt"):
            path = P.join(self.root, stem + ".pkl")
            if P.isfile(path):
                os.remove(path)

    # ------------------------------------------------------------------
    # checkpointing (trainer.py:427-481)
    def _opt_state_np(self):
        out = {}
        for name, p in self._leaves.items():
            st = self.optimizer.state.get(p)
            if st:
                out[name] = {k: (torch_io._to_np(v) if torch.is_tensor(v)
                                 else v) for k, v in st.items()}
        return out

    def snapshot(self, epoch: int, name: Optional[str] = None):
        t0 = time.perf_counter()
        payload = {
            "epoch": epoch,
            "state_dict": torch_io.to_torch_state_dict(self.graph,
                                                       self.variables),
            "opt_state": self._opt_state_np(),
            "step_idx": self.step_idx,
            "max_metric": self.max_seg_metric_val,
        }
        stem = ("state_%04d" % epoch) if name is None else ("state_%s" % name)
        fname = P.join(self.root, stem + ".pkl")
        with open(fname, "wb") as f:
            pickle.dump(payload, f)
        self.seconds["snapshots"] += time.perf_counter() - t0
        return fname

    def resume(self, path: str):
        """Weights, step, best metric and epoch from a snapshot; the Adam
        moments too where the snapshot is this package's (a JAX snapshot's
        optax state is not read: the moments start at zero)."""
        with open(path, "rb") as f:
            payload = torch_io.PermissiveUnpickler(f).load()
        self._adopt(torch_io.load_torch_state_dict(
            self.graph, self.variables, payload["state_dict"]))
        opt_state = payload.get("opt_state")
        if isinstance(opt_state, dict) and all(
                isinstance(v, dict) and "exp_avg" in v
                for v in opt_state.values()):
            for name, st in opt_state.items():
                p = self._leaves[name]
                self.optimizer.state[p] = {
                    k: (torch.as_tensor(v).to(self.device)
                        if k != "step" else torch.as_tensor(v))
                    for k, v in st.items()}
        elif opt_state is not None:
            print(f"resume: {path} holds another optimizer's state; the "
                  f"Adam moments start at zero")
        self.step_idx = payload.get("step_idx", 0)
        self.max_seg_metric_val = payload.get("max_metric", 0.0)
        self.start_epoch = payload["epoch"] + 1

    def load_pretrain(self, path: str):
        self._adopt(torch_io.load_torch_checkpoint(self.graph,
                                                   self.variables, path))

    def final_snap(self, name: str):
        """Compressed npz export; near-ternary conv weights cast to int8
        (trainer.py:470-481)."""
        sd = torch_io.to_torch_state_dict(self.graph, self.variables)
        sdx = {}
        for k, v in sd.items():
            if "conv.weight" in k and len(np.unique(v)) <= 3 and v.max() != 0:
                v = (v / np.abs(v).max()).astype(np.int8)
            sdx[k] = v
        np.savez_compressed(P.join(self.root, f"state_{name}"),
                            state_dict=sdx)
