"""The ``ptq`` and ``infer`` missions.

Counterpart of the JAX package's ``cli/missions.py`` (the reference's
``src/ptq_seg.py`` and ``src/ptqer.py:282-387``).  The artifact files are
the JAX mission's, name for name and format for format, so the exports
interchange: ``cmd.txt``, ``time_cost.txt``, ``layer_loss.txt``,
``layer_loss_curve.npz``, ``class_voxel_nums.txt``, ``Qseg*.nii.gz``,
``FPseg*.nii.gz``, ``state_in_fp.pkl``, ``state_in_int8.pkl``,
``state_in_int8_compress.npz`` (with ``__qlvl_overrides__``; pickles of
NumPy arrays, no torch tensors), and ``{ptq,fp,infer}/{val,test}_seg.txt``
with ``true_test/``; with the PTQ extensions ``calib_select.txt``
(``--lwq_select``), ``mixed_upgraded.txt`` (``--mixed_frac``),
``tail_alpha_sweep.txt`` (``--tail_alpha_sweep``) and
``tune_act_loss.txt`` / ``tune_act_score.txt`` (``--tune_act``).  The port
also writes ``toolchain.json`` (``utils/toolchain.py``) into each ptq
snapshot.

The ``train_fp`` mission (the reference's ``src/train_seg.py:27-203``)
writes the JAX mission's files too: ``description.txt``, ``loss.txt``,
``seg_metric.txt``, ``state_<epoch>.pkl`` snapshots, ``state_FP.npz`` and
``seg_<epoch>/{val,test}_seg.txt``; ``ptq --qat_epochs N`` fine-tunes the
calibrated net under ``<snap>/qat/`` (``qat_loss.txt``) before the export.
A fresh ``train_fp`` starts from ``nnir.init``'s NumPy-seeded weights, not
from the JAX package's ``PRNGKey(0)`` ones.

The serving options are the JAX mission's: ``--serve_grid column``
(full-depth columns), ``--tune_serving {auto,force,off}`` (the patch-batch
autotuner, ``eval/autotune.py``), ``--export_artifact`` (with
``--export_column_depth``; ``serving_artifact.zip`` and, with
``--serve_stem s2d``, ``serving_artifact_s2d.zip``, ``export.py``) and
``infer --artifact``.  The multi-device flags raise
``NotImplementedError`` naming their ROADMAP queue 1 item: ``--dp_devices``,
``--mesh_shape``, ``--distributed`` and ``--fsdp`` (item 9).
``--ckpt_backend orbax`` raises a ``ValueError``: Orbax is the JAX
package's checkpoint format, and the port writes pickles.
"""
from __future__ import annotations

import json
import os
import os.path as P
import pickle
import time

import numpy as np
import torch

from .. import nnir
from ..data.transforms import center_crop
from ..eval.validate import validate_seg
from ..models import (build_model, min_input_divisor, torch_io,
                      validate_spatial_shape)
from ..ptq import run_ptq, run_ptq_mixed, tail_sensitive_convs
from ..ptq.select import select_calibration, to_ndhwc
from ..quant import pack_int_weight
from ..train import Trainer
from ..utils.toolchain import toolchain_fingerprint
from . import definer

def select_device(args) -> torch.device:
    """``cuda:<--device>``; the CPU only under ``EFFQ_PLATFORM=cpu``.
    Without a card and without that setting this raises: the CLI never
    carries on on the CPU by itself."""
    if os.environ.get("EFFQ_PLATFORM", "").lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set EFFQ_PLATFORM=cpu to run the "
                           "missions on the CPU")
    device = torch.device("cuda", int(args.device or 0))
    torch.cuda.set_device(device)
    return device


def _refuse(args, flags):
    for flag, active, item in flags:
        if active(args):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP "
                                      f"queue 1 item {item}")


def _refuse_swinunetr(args, mission: str, flags=()):
    """SwinUNETR runs ``ptq`` and ``infer`` on the int8 serving path
    alone: training, QAT, the s2d stem and the exported artifacts refuse
    it."""
    if args.model != "SwinUNETR":
        return
    if mission == "train_fp":
        raise NotImplementedError("train_fp does not train SwinUNETR: its "
                                  "port serves a PTQ export (ptq, infer)")
    for flag, active in flags:
        if active(args):
            raise NotImplementedError(f"{flag} does not take SwinUNETR: its "
                                      f"port serves the direct int8 path")


_SERVING = [
    ("--dp_devices", lambda a: a.dp_devices, 9),
    ("--mesh_shape", lambda a: a.mesh_shape, 9),
    ("--distributed", lambda a: a.distributed, 9),
]
# the options that SwinUNETR's missions refuse
_SWIN_REFUSED = (
    ("--qat_epochs", lambda a: a.qat_epochs),
    ("--serve_stem s2d", lambda a: a.serve_stem == "s2d"),
    ("--export_artifact", lambda a: a.export_artifact),
    ("--serve_grid column", lambda a: a.serve_grid == "column"),
)
_TRAINING = [
    ("--dp_devices", lambda a: a.dp_devices, 9),
    ("--mesh_shape", lambda a: a.mesh_shape, 9),
    ("--distributed", lambda a: a.distributed, 9),
    ("--fsdp", lambda a: a.fsdp, 9),
]


def _final_test(graph, variables, hub, num_mo, n_class, save_dir, args,
                device, mode="fp", artifact=None, stride_div=None):
    """Per-split metric files, then the label-free true-test export
    (the reference's trainer.py:253-307).  With ``artifact`` the forward
    runs from the serving artifact's program (``export.py``) and
    graph / variables may be None.  ``stride_div``: the net's D-stride
    multiple (``min_input_divisor``), which --serve_grid column needs."""
    from ..eval.validate import true_test_inference

    os.makedirs(save_dir, exist_ok=True)
    if args.serve_grid == "column" and stride_div is None:
        raise ValueError("--serve_grid column is not available for this "
                         "mission path (no model config to derive the "
                         "stride multiple from)")
    kw = dict(mode=mode, patch_batch=args.patch_batch or "auto",
              compute_dtype=(torch.bfloat16 if args.serve_dtype == "bf16"
                             else None),
              serve_stem=args.serve_stem, device=device, artifact=artifact,
              serve_grid=args.serve_grid, stride_div=stride_div,
              tune_serving=args.tune_serving)
    for split, loader, sns in (("val", hub.valloader, hub.val_sn),
                               ("test", hub.testloader, hub.test_sn)):
        if loader is None:
            continue
        nii_dir = P.join(save_dir, split) if args.save_nii else None
        sm = validate_seg(graph, variables, loader, sns, num_mo, n_class,
                          patch_size=hub.slide_patch_size,
                          overlap=hub.slide_overlap, save_dir=nii_dir,
                          is_cc=args.is_cc, sn_fn_dict=hub.sn_to_fn_map,
                          restore_shape_func=hub.restore_shape_func,
                          restore_infokw=hub.restore_infokw,
                          merge_label_func=hub.merge_label_func,
                          multilabel_fusetype=hub.multilabel_fusetype, **kw)
        with open(P.join(save_dir, f"{split}_seg.txt"), "w") as f:
            for i in range(-1, -num_mo - 1, -1):
                sm[i].write_metric(f, "Output %d:" % i, is_indiv=True)
        sm[-1].print_metric("  " + split)
    if args.true_test:
        true_test_inference(graph, variables, hub,
                            P.join(save_dir, "true_test"),
                            multilabel_fusetype=hub.multilabel_fusetype, **kw)


def _tb_writer(args, snap_root):
    """The optional TensorBoard sink (train_seg.py:163-169)."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=P.join(
            os.getcwd(), "results", args.task, "tboard",
            "round" + str(args.round), P.basename(snap_root)))
    except Exception:
        return None


def train_fp(args):
    """FP training mission (train_seg.py:27-203) on ``select_device(args)``:
    snapshots under exp_fp/ (or the resumed run's directory), warmup over
    5 epochs with --pretrain and 1 without, online validation every
    ``test_interval`` epochs, then the final test of ``state_seg_max`` and
    of ``state_<max_epoch>``.  Returns the snapshot directory and the
    mission's seconds by part: data (building the hub), train_data
    (waiting for batches), steps, validation, snapshots and final_test."""
    _refuse(args, _TRAINING)
    _refuse_swinunetr(args, "train_fp")
    if args.ckpt_backend != "pickle":
        raise ValueError(f"--ckpt_backend {args.ckpt_backend}: the port "
                         f"writes pickle snapshots only (Orbax is the JAX "
                         f"package's format)")
    device = select_device(args)
    t0 = time.perf_counter()
    hub, data_info, nMod, nClass, patch_size = definer.get_data_cube(args)
    cfg, model_info, n_mo = definer.get_model_config(args)
    validate_spatial_shape(patch_size, cfg, "--patch_size")
    graph = build_model(cfg)
    variables = nnir.init(graph, 0, device="cpu")
    seconds = {"data": time.perf_counter() - t0}

    if args.resume:
        # resume into the original experiment directory (train_seg.py:68-69)
        snap_root = P.dirname(P.abspath(args.resume))
    else:
        snap_root = definer.make_snapshot_dir(args, "exp_fp", model_info,
                                              "FP")
    warmup_epochs = 5 if args.pretrain else 1
    test_interval = (args.test_interval
                     if args.test_interval > args.max_epoch / 20
                     else max(args.max_epoch // 20, 1))
    trainer = Trainer(
        graph, variables, hub, loss_name=args.loss, num_mo=n_mo,
        n_class=nClass, base_lr=args.lr, max_epoch=args.max_epoch,
        snapshot_root=snap_root, weight_decay=float(args.weight_decay),
        warmup_epochs=warmup_epochs, test_interval=test_interval,
        display_interval=args.disp_interval,
        multilabel_fusetype=args.merge_type,
        tb_writer=_tb_writer(args, snap_root), remat=args.remat,
        amp=args.amp, device=device)
    if args.resume:
        trainer.resume(args.resume)
    elif args.pretrain:
        trainer.load_pretrain(args.pretrain)
    trainer.train()
    print("Training complete.")
    seconds.update(train_data=trainer.seconds["data"],
                   steps=trainer.seconds["steps"],
                   validation=trainer.seconds["validation"],
                   snapshots=trainer.seconds["snapshots"])

    t0 = time.perf_counter()
    if not args.no_test:
        for stem, folder in (("state_seg_max", "seg_max"),
                             ("state_%04d" % args.max_epoch,
                              "seg_%04d" % args.max_epoch)):
            path = P.join(snap_root, stem + ".pkl")
            if P.isfile(path):
                trainer.load_pretrain(path)
                _final_test(graph, trainer.variables, hub, n_mo, nClass,
                            P.join(snap_root, folder), args, device,
                            stride_div=min_input_divisor(cfg)[0])
    seconds["final_test"] = time.perf_counter() - t0
    print("train_fp seconds: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in seconds.items()))
    return snap_root, seconds


def _calib_crop_shape(args, img):
    """The shared calibration crop rule (ptqer.py:96-105): explicit
    --lwq_patchsz, else each spatial dim capped at 192 and rounded down to
    a multiple of 64.  An axis under 64 voxels would get an empty crop
    (the JAX mission calibrates on it and writes NaN losses): it raises,
    naming the axis."""
    if args.lwq_patchsz:
        return [int(x) for x in args.lwq_patchsz.split(",")]
    shape = [min(x, 192) // 64 * 64 for x in img.shape[-3:]]
    for axis, (crop, extent) in enumerate(zip(shape, img.shape[-3:])):
        if crop == 0:
            raise ValueError(
                f"calibration crop: spatial axis {axis} of the volume has "
                f"{extent} voxels, under 64, so the crop rule "
                f"min(x, 192) // 64 * 64 gives it 0; pass --lwq_patchsz")
    return shape


def _calib_sequence(args, hub, count, per_volume=False):
    """``count`` sequential center-cropped (img, label) pairs after the
    --lwq_dataid skip (ptqer.py:83-111), with a descriptive error when the
    train split is too short.  An item is one trainseqloader batch (the
    reference's unit for --lwq_dataid and --lwq_batchsz), or with
    ``per_volume`` one volume (--lwq_select scores volumes one by one,
    whatever --test_batch_size is)."""
    hub.trainseqloader.dataset.use_fix_transform()
    it = iter(hub.trainseqloader)
    pairs = []
    try:
        for _ in range(args.lwq_dataid):
            next(it)
        while len(pairs) < count:
            img, label = next(it)
            shape = _calib_crop_shape(args, img)
            img, label = center_crop(img, shape), center_crop(label, shape)
            if per_volume:
                for j in range(img.shape[0]):
                    if len(pairs) < count:
                        pairs.append((img[j:j + 1], label[j:j + 1]))
            else:
                pairs.append((img, label))
    except StopIteration:
        unit = "volumes" if per_volume else "batches"
        raise ValueError(
            f"calibration needs --lwq_dataid ({args.lwq_dataid}) + {count} "
            f"sequential {unit}, but the train split has fewer") from None
    return pairs


def get_calibration_data(args, hub):
    """One (or lwq_batchsz-stacked) center-cropped calibration volume(s)
    from the sequential train loader (ptqer.py:83-111)."""
    pairs = _calib_sequence(args, hub, args.lwq_batchsz)
    img = np.concatenate([p[0] for p in pairs], axis=0)
    label = np.concatenate([p[1] for p in pairs], axis=0)
    return img, label


def get_calibration_candidates(args, hub):
    """K sequential candidate (img, label) volume pairs for --lwq_select,
    each center-cropped by the same rule as the single-volume path."""
    pairs = _calib_sequence(args, hub, args.lwq_select, per_volume=True)
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _tune_scorer(graph, tune_pairs, hub, num_mo, n_class, device):
    """Quantized-dice scorer on the labeled calibration/train volumes (the
    validation split is never touched), shared by --tail_alpha_sweep and
    --tune_act; one eager inferencer for every call, also on a card: a
    variable set scores one or two volumes, too few replays to repay a
    CUDA graph's capture (PERF.md, ``chip_smoke.py`` phase 11 (f)).  The
    score geometry is clamped to the calibration crop, which can be
    smaller than the task's sliding patch."""
    from ..eval.sliding import make_volume_inferencer
    from ..ops import triple

    t_sn = [f"calib{i}" for i in range(len(tune_pairs))]
    vol_shape = np.asarray(tune_pairs[0][0]).shape[2:5]
    score_ps = tuple(min(p, v) for p, v in zip(
        triple(hub.slide_patch_size), vol_shape))
    score_ov = tuple(o if o < p else p // 2 for o, p in zip(
        triple(hub.slide_overlap), score_ps))
    score_infer = make_volume_inferencer(
        graph, patch_batch=2, mode="quantized", hard_pred=True,
        multilabel=np.asarray(tune_pairs[0][1]).ndim == 5, capture=False)

    def tune_score(v):
        sm = validate_seg(graph, v, tune_pairs, t_sn, num_mo, n_class,
                          patch_size=score_ps, overlap=score_ov,
                          mode="quantized", patch_batch=2,
                          multilabel_fusetype=hub.multilabel_fusetype,
                          infer=score_infer, device=device)
        return float(sm[-1].get_metric()["dsc"])

    return tune_score


def ptq(args):
    """PTQ mission (ptq_seg.py:7-32 + ptqer.do_ptq:282-387) on
    ``select_device(args)``, with the extensions of the JAX mission:
    calibration-volume selection (--lwq_select), mixed precision
    (--mixed_frac), offset activation grids (--act_offset), block
    granularity, the tail clip sweep (--tail_alpha_sweep) and
    activation-range tuning (--tune_act).  Returns the snapshot directory
    and the mission's seconds by part: data, fp_forward and calibration
    (of the kept calibration), final_test, exports, and where they ran
    ranking (the mixed ranking pass), candidate<i>_calibration and
    candidate<i>_scoring, tail_alpha_sweep, tune_act, and qat (the
    fine-tune of --qat_epochs) with qat_steps (its train loop; the rest is
    its val scoring)."""
    _refuse(args, _SERVING)
    _refuse_swinunetr(args, "ptq", _SWIN_REFUSED)
    device = select_device(args)
    seconds = {}
    t0 = time.perf_counter()
    hub, data_info, nMod, nClass, patch_size = definer.get_data_cube(args)
    cfg, model_info, n_mo = definer.get_model_config(args)
    graph = build_model(cfg)
    variables = nnir.init(graph, 0, device="cpu")

    validate_spatial_shape(patch_size, cfg, "--patch_size")
    if args.lwq_patchsz:
        # an explicit calibration crop must also flow through the net (the
        # auto rule rounds to multiples of 64, always compatible)
        validate_spatial_shape(
            [int(x) for x in args.lwq_patchsz.split(",")], cfg,
            "--lwq_patchsz")

    qinfo = definer.qinfo_string(args)
    snap_dir = definer.make_snapshot_dir(args, "exp_ptq", model_info, qinfo)

    # pretrained FP weights: a torch checkpoint or a plain pickle, with or
    # without {'state_dict': ...} (ptq_seg.py:19-21)
    if not args.pretrain:
        raise ValueError("PTQ requires --pretrain")
    print("pretrain is :", args.pretrain)
    variables = torch_io.load_torch_checkpoint(graph, variables,
                                               args.pretrain)
    if args.lwq_select:
        if args.lwq_batchsz != 1:
            raise ValueError("--lwq_select is incompatible with "
                             "--lwq_batchsz > 1 (candidates are single "
                             "volumes)")
        if args.lwq_select < 2:
            raise ValueError("--lwq_select needs at least 2 candidates")
        cand_imgs, cand_labels = get_calibration_candidates(args, hub)
        tune_pairs = list(zip(cand_imgs, cand_labels))
    else:
        img, _label = get_calibration_data(args, hub)
        tune_pairs = [(img, _label)]
        if args.lwq_verbose:
            print("Calibration data shape:", img.shape)
    seconds["data"] = time.perf_counter() - t0

    # optional FP evaluation before quantization (ptqer.py:309-310)
    if args.test_fp:
        from ..ptq import fold_bn

        fg, fv = fold_bn(graph, variables)
        _final_test(fg, fv, hub, n_mo, nClass, P.join(snap_dir, "fp"), args,
                    device, stride_div=min_input_divisor(cfg)[0])

    ptq_kw = dict(task=args.task,
                  init_stride=definer.parse_triple(args.init_stride),
                  hp=definer.get_lwq_hyperparams(args),
                  verbose=args.lwq_verbose,
                  granularity=args.lwq_granularity)
    if args.act_offset:
        # offset activation grids searched per layer at calibration;
        # scope 'tail' limits the search to the last ResBlock's convs
        ptq_kw["act_offset"] = args.act_offset
        if args.act_offset_scope == "tail":
            ptq_kw["act_offset_convs"] = set(tail_sensitive_convs(graph))
            print(f"act_offset: searching k in 0..{args.act_offset} on "
                  f"{sorted(ptq_kw['act_offset_convs'])}")
        else:
            print(f"act_offset: searching k in 0..{args.act_offset} on "
                  f"every q_act conv")
    mixed = dict(mixed_frac=args.mixed_frac, mixed_qlvl=args.mixed_qlvl,
                 mixed_tail=args.mixed_tail == "on")
    t0 = time.perf_counter()
    if args.lwq_select:
        # calibration-volume selection: calibrate on each of K candidates,
        # keep the best by train-volume dice
        fgraph, qvars, report, selection = select_calibration(
            graph, variables, cand_imgs, cand_labels, num_mo=n_mo,
            n_class=nClass, patch_size=hub.slide_patch_size,
            overlap=hub.slide_overlap,
            multilabel_fusetype=hub.multilabel_fusetype, device=device,
            **mixed, **ptq_kw)
        calib_x = to_ndhwc(cand_imgs[selection["picked"]])
        with open(P.join(snap_dir, "calib_select.txt"), "w") as f:
            for i, sc in enumerate(selection["scores"]):
                mark = "  <- picked" if i == selection["picked"] else ""
                f.write(f"candidate {args.lwq_dataid + i}: "
                        f"train-volume dice {sc:.6f}{mark}\n")
        print(f"calib_select: picked candidate "
              f"{args.lwq_dataid + selection['picked']} (train-volume dice "
              f"{selection['scores'][selection['picked']]:.4f} over "
              f"{args.lwq_select} candidates)")
        if "ranking" in selection["seconds"]:
            seconds["ranking"] = selection["seconds"]["ranking"]
        for i, (cal, sco) in enumerate(selection["seconds"]["candidates"]):
            seconds[f"candidate{i}_calibration"] = cal
            seconds[f"candidate{i}_scoring"] = sco
    else:
        calib_x = to_ndhwc(img)
        if args.mixed_frac:
            # sensitivity-driven mixed precision: two passes, the worst
            # layers lifted to --mixed_qlvl
            fgraph, qvars, report = run_ptq_mixed(
                graph, variables, calib_x, device=device, **mixed, **ptq_kw)
        else:
            fgraph, qvars, report = run_ptq(graph, variables, calib_x,
                                            device=device, **ptq_kw)
    seconds["fp_forward"] = report.fp_forward_seconds
    seconds["calibration"] = report.calibration_seconds
    if args.mixed_frac and not args.lwq_select:
        # the first pass: its FP forward and the ranking calibration
        seconds["ranking"] = (time.perf_counter() - t0
                              - report.fp_forward_seconds
                              - report.calibration_seconds)
    if report.mixed_upgraded:
        print(f"mixed precision: {len(report.mixed_upgraded)} layers at "
              f"qlvl {args.mixed_qlvl}: {', '.join(report.mixed_upgraded)}")
        with open(P.join(snap_dir, "mixed_upgraded.txt"), "w") as f:
            f.write("\n".join(report.mixed_upgraded) + "\n")

    if args.tail_alpha_sweep or args.tune_act:
        tune_score = _tune_scorer(fgraph, tune_pairs, hub, n_mo, nClass,
                                  device)

    if args.tail_alpha_sweep:
        # validated clip-range sweep on the tail convs; factor 1.0 is a
        # candidate, so the sweep cannot lose by its own score
        from ..ptq.tune import sweep_tail_alpha

        t0 = time.perf_counter()
        facs = tuple(float(x) for x in args.tail_alpha_factors.split(","))
        qvars, ainfo = sweep_tail_alpha(fgraph, qvars, tune_score,
                                        factors=facs)
        if ainfo["scores"]:
            print(f"tail_alpha_sweep: kept x{ainfo['best_factor']} "
                  f"(calib-volume dice {ainfo['best_score']:.4f}) over "
                  f"{[f for f, _ in ainfo['scores']]} on {ainfo['convs']}")
            with open(P.join(snap_dir, "tail_alpha_sweep.txt"), "w") as f:
                for fac, sc in ainfo["scores"]:
                    mark = ("  <- kept" if fac == ainfo["best_factor"]
                            else "")
                    f.write(f"x{fac}: dice {sc:.6f}{mark}\n")
        seconds["tail_alpha_sweep"] = time.perf_counter() - t0

    if args.tune_act:
        # joint alpha_act refinement on the calibration volume, validated
        # by quantized dice on the labeled calibration volume(s): the
        # best-scoring iterate is kept, iteration 0 included
        from ..ptq.tune import tune_activation_range

        t0 = time.perf_counter()
        qvars, tune_losses, tinfo = tune_activation_range(
            fgraph, qvars, calib_x, report.output_fp,
            max_iter=args.tune_act, score_fn=tune_score)
        print(f"tune_act: recon MSE {tune_losses[0]:.6g} -> "
              f"{tune_losses[-1]:.6g} over {len(tune_losses)} iters; "
              f"kept iter {tinfo['best_iter']} "
              f"(calib-volume dice {tinfo['best_score']:.4f})")
        with open(P.join(snap_dir, "tune_act_loss.txt"), "w") as f:
            f.write("\n".join(f"{v:.8g}" for v in tune_losses))
        with open(P.join(snap_dir, "tune_act_score.txt"), "w") as f:
            for it, sc in tinfo["scores"]:
                mark = "  <- kept" if it == tinfo["best_iter"] else ""
                f.write(f"iter {it}: dice {sc:.6f}{mark}\n")
        seconds["tune_act"] = time.perf_counter() - t0

    if args.qat_epochs:
        # the quantization-aware fine-tune of the calibrated net: STE
        # training under the deployed fake-quant forward, the best val
        # dice epoch kept (epoch 0, the pure PTQ, included)
        from ..ptq.qat import run_qat

        t0 = time.perf_counter()
        qat_dir = P.join(snap_dir, "qat")
        os.makedirs(qat_dir, exist_ok=True)
        qvars, qat_log = run_qat(
            fgraph, qvars, hub, num_mo=n_mo, n_class=nClass,
            loss_name=args.loss, epochs=args.qat_epochs, lr=args.qat_lr,
            snapshot_root=qat_dir,
            multilabel_fusetype=hub.multilabel_fusetype,
            display_interval=args.disp_interval,
            weight_decay=float(args.weight_decay), device=device)
        kd = qat_log["kept_dice"]
        print(f"qat: kept epoch {qat_log['kept_epoch']}"
              + (f" (val dice {kd:.4f})" if kd is not None else ""))
        seconds["qat"] = time.perf_counter() - t0
        seconds["qat_steps"] = (qat_log["seconds"].get("data", 0.0)
                                + qat_log["seconds"].get("steps", 0.0))

    t0 = time.perf_counter()
    with open(P.join(snap_dir, "toolchain.json"), "w") as f:
        json.dump(toolchain_fingerprint(), f, indent=1)
    print(f"FP forward costs {report.fp_forward_seconds:.3f}s, PTQ costs "
          f"{report.calibration_seconds:.3f}s.")
    with open(P.join(snap_dir, "time_cost.txt"), "w") as f:
        f.write(report.time_cost_line())
    with open(P.join(snap_dir, "layer_loss.txt"), "w") as f:
        f.write("\n".join(report.layer_loss_lines()))
    # per-layer ADMM trajectories (loss/residuals/rho per iteration) as one
    # npz (EfficientQConv.py:122-127, ptqer.py:275-279)
    np.savez_compressed(
        P.join(snap_dir, "layer_loss_curve.npz"),
        **{f"{name}/{k}": torch_io._to_np(v)
           for name, hist in report.layer_histories.items()
           for k, v in hist.items()})
    if args.lwq_verbose:
        _plot_loss_curves(report, snap_dir)
    with open(P.join(snap_dir, "class_voxel_nums.txt"), "w") as f:
        for n in report.class_voxel_nums:
            f.write(f"{n}\n")
    _dump_seg_niis(report, args.task, snap_dir)
    exports = time.perf_counter() - t0

    t0 = time.perf_counter()
    if not args.no_test:
        _final_test(fgraph, qvars, hub, n_mo, nClass, P.join(snap_dir, "ptq"),
                    args, device, mode="quantized",
                    stride_div=min_input_divisor(cfg)[0])
    seconds["final_test"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _save_quantized(fgraph, qvars, snap_dir)
    seconds["exports"] = exports + time.perf_counter() - t0
    if args.export_artifact:
        t0 = time.perf_counter()
        _save_artifact(fgraph, qvars, hub, nMod, nClass, snap_dir, args,
                       device)
        seconds["export_artifact"] = time.perf_counter() - t0
    print("ptq seconds: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in seconds.items()))
    return snap_dir, seconds


def infer(args):
    """Serving mission: load a PTQ export (state_in_int8.pkl /
    state_in_int8_compress.npz / state_in_fp.pkl, from either package) and
    run whole-volume inference without recalibrating; ``--deploy
    int8|mixed`` serves through the int8 deployment rewrite (K1 for the
    interior 3^3 convs), ``--serve_stem s2d`` through the space-to-depth
    stem (K2) at bfloat16.  Model and quantization flags must match the
    ptq run that produced the export.

    ``--artifact serving_artifact.zip`` serves from a serving artifact
    (``export.py``) instead: no --pretrain and no model or quantization
    flags, the artifact is the computation.  ``--export_artifact`` writes
    such an artifact of this run's serving graph (with any --deploy
    rewrite; its K1-K5 as the registered operators).  Returns the snapshot
    directory and the seconds of the final test (and of the export)."""
    from ..ptq import apply_qlvl_overrides, fold_bn

    _refuse(args, _SERVING)
    _refuse_swinunetr(args, "infer", _SWIN_REFUSED)
    device = select_device(args)
    hub, data_info, nMod, nClass, patch_size = definer.get_data_cube(args)

    if args.artifact:
        return _serve_artifact(args, hub, nMod, nClass, device)

    cfg, model_info, n_mo = definer.get_model_config(args)
    validate_spatial_shape(patch_size, cfg, "--patch_size")
    graph = build_model(cfg)
    variables = nnir.init(graph, 0, device="cpu")
    if not args.pretrain:
        raise ValueError("infer requires --pretrain (a PTQ export) or "
                         "--artifact (a serving artifact)")

    qinfo = definer.qinfo_string(args)
    snap_dir = definer.make_snapshot_dir(args, "exp_infer", model_info,
                                         qinfo)

    # exports are of the folded graph: fold first (the random-init BN
    # stats fold into conv params that the export then overwrites)
    fgraph, fvars = fold_bn(graph, variables)
    # mixed-precision exports carry per-layer grids (__qlvl_overrides__)
    overrides = torch_io.read_export_qlvl_overrides(args.pretrain)
    if overrides:
        fgraph = apply_qlvl_overrides(fgraph, overrides)
    fvars = torch_io.load_int8_checkpoint(fgraph, fvars, args.pretrain)

    if args.deploy != "none":
        from ..ptq.deploy import to_int8_inference

        only = {(3, 3, 3)} if args.deploy == "mixed" else None
        fgraph, fvars = to_int8_inference(fgraph, fvars,
                                          only_kernel_sizes=only)
        n_int8 = sum(1 for node in fgraph.nodes if node.attrs.get("int8"))
        print(f"deploy={args.deploy}: {n_int8} convs on the int8 path")

    seconds = {}
    if args.export_artifact:
        t0 = time.perf_counter()
        _save_artifact(fgraph, fvars, hub, nMod, nClass, snap_dir, args,
                       device)
        seconds["export_artifact"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _final_test(fgraph, fvars, hub, n_mo, nClass, P.join(snap_dir, "infer"),
                args, device, mode="quantized",
                stride_div=min_input_divisor(cfg)[0])
    seconds["final_test"] = time.perf_counter() - t0
    return snap_dir, seconds


def _serve_artifact(args, hub, n_mod, n_class, device):
    """``infer --artifact``: the artifact's platform, patch and manifest
    gates, then the final test from its program."""
    from ..export import load_serving_artifact
    from ..ops import triple

    art = load_serving_artifact(args.artifact)
    art.check_platform(device)
    # the spatial dims are static in the exported program (only the batch
    # may be symbolic): the serving patch must be the export's.  A column
    # artifact pins its own D (the export-time column depth); only H and W
    # must match the task patch
    column = art.manifest.get("serve_grid") == "column"
    want = art.patch_size[1:] if column else art.patch_size
    got = tuple(triple(hub.slide_patch_size))
    if (got[1:] if column else got) != tuple(want):
        raise ValueError(f"--patch_size {got} does not match the "
                         f"artifact's {art.patch_size}")
    # the manifest knows what it serves: a task, modality or class mismatch
    # would otherwise surface as a shape error deep in the program (or
    # score against the wrong task's labels)
    for key, got in (("task", args.task), ("n_mod", int(n_mod)),
                     ("n_class", int(n_class))):
        want = art.manifest.get(key)
        if want is not None and want != got:
            raise ValueError(f"artifact was exported for {key}={want!r}; "
                             f"this run is {key}={got!r} — serve it with "
                             f"the matching task flags")
    snap_dir = definer.make_snapshot_dir(args, "exp_infer", "artifact",
                                         "ARTIFACT")
    print(f"serving from artifact {args.artifact} (batch={art.batch}, "
          f"platforms={art.platforms})")
    t0 = time.perf_counter()
    _final_test(None, None, hub, 1, n_class, P.join(snap_dir, "infer"), args,
                device, mode="quantized", artifact=art)
    return snap_dir, {"final_test": time.perf_counter() - t0}


def _save_artifact(graph, variables, hub, n_mod, n_class, snap_dir, args,
                   device):
    """Serialize the final-head serving forward next to the weight exports
    (``export.py``): the manifest and the exported program in one zip,
    exported on ``device``; with ``--serve_stem s2d`` also the s2d
    artifact beside it."""
    from .. import export as export_mod
    from ..eval.sliding import column_grid_plan
    from ..ops import triple

    pb = args.patch_batch or 0
    patch_size = tuple(triple(hub.slide_patch_size))
    overlap = tuple(triple(hub.slide_overlap))
    column_depth = None
    if args.serve_grid == "column":
        # the column's D is the whole (stride-padded) volume depth, which
        # the data decides, so a column artifact pins it at export
        # (--export_column_depth, e.g. 155 for BraTS volumes): shallower
        # volumes pad up at serve time, deeper ones need a new artifact
        depth = args.export_column_depth or 0
        if depth <= 0:
            raise ValueError("--export_artifact with --serve_grid column "
                             "needs --export_column_depth (the deepest "
                             "volume this artifact will serve)")
        cfg, _, _ = definer.get_model_config(args)
        column_depth, patch_size, overlap = column_grid_plan(
            (depth,) + patch_size[1:], patch_size, overlap,
            min_input_divisor(cfg)[0])
    exported, batch = export_mod.export_patch_model(
        graph, variables, patch_size, n_mod, mode="quantized",
        patch_batch=pb if pb > 0 else 4,
        compute_dtype=torch.bfloat16 if args.serve_dtype == "bf16" else None,
        device=device)
    path = P.join(snap_dir, "serving_artifact.zip")
    export_mod.save_serving_artifact(path, exported, {
        "task": args.task,
        "patch_size": list(patch_size),
        "overlap": list(overlap),
        "serve_grid": args.serve_grid,
        **({"column_depth": int(column_depth)}
           if column_depth is not None else {}),
        "n_mod": int(n_mod),
        "n_class": int(n_class),
        "batch": batch,
        "deploy": args.deploy,
        "serve_dtype": args.serve_dtype,
        "multilabel_fusetype": hub.multilabel_fusetype,
    })
    print(f"serving artifact -> {path} (batch={batch}, "
          f"platforms={[torch.device(device).type]})")

    if args.serve_stem == "s2d" and args.serve_grid == "patch":
        # the s2d serving mode as an artifact too: the exported program is
        # the s2d-stem forward with the channels-first tail; the transform
        # is package code on the serving side, driven by the manifest.  The
        # direct artifact above stays beside it for odd geometries
        g_dep, v_dep = graph, variables
        if not any(n.attrs.get("int8") for n in graph.nodes):
            # the ptq mission hands over the undeployed graph; the s2d stem
            # rewrite needs the int8 K1 consumers, so apply the mixed
            # deployment (int8 with --deploy int8)
            from ..ptq.deploy import to_int8_inference

            only = None if args.deploy == "int8" else {(3, 3, 3)}
            g_dep, v_dep = to_int8_inference(graph, variables,
                                             only_kernel_sizes=only)
        res = export_mod.export_s2d_model(
            g_dep, v_dep, patch_size, n_mod,
            # 8 = the BraTS whole-grid forward; ragged grids zero-pad up
            patch_batch=pb if pb > 0 else 8, device=device)
        if res is None:
            print("serve_stem=s2d artifact skipped: no eligible stem "
                  "(need --deploy int8|mixed)")
        else:
            exported_s, batch_s, stem_attrs = res
            path_s = P.join(snap_dir, "serving_artifact_s2d.zip")
            export_mod.save_serving_artifact(path_s, exported_s, {
                "task": args.task,
                "patch_size": list(patch_size),
                "overlap": list(overlap),
                "serve_stem": "s2d",
                "channels_first": True,
                "stem_geometry": stem_attrs,
                "n_mod": int(n_mod),
                "n_class": int(n_class),
                "batch": batch_s,
                "deploy": args.deploy,
                "serve_dtype": "bf16",
                "multilabel_fusetype": hub.multilabel_fusetype,
            })
            print(f"s2d serving artifact -> {path_s} (batch={batch_s}, "
                  f"platforms={[torch.device(device).type]})")
    return path


def _plot_loss_curves(report, snap_dir):
    """Loss-curve PNG of every layer (the reference's plot_save,
    src/ptqer.py:275-279); best effort when matplotlib is present."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 5))
        for name, hist in report.layer_histories.items():
            plt.plot(torch_io._to_np(hist["loss"]), label=name, linewidth=0.8)
        plt.yscale("log")
        plt.xlabel("ADMM iteration")
        plt.ylabel("reconstruction loss")
        plt.legend(fontsize=4, ncol=2)
        fig.savefig(P.join(snap_dir, "layer_loss_curve.png"), dpi=120)
        plt.close(fig)
    except Exception as e:
        print(f"loss-curve plot skipped: {e}")


def _dump_seg_niis(report, task, snap_dir):
    """Side-by-side Q vs FP hard segmentations (ptqer.py:372-377; brats uses
    the conservative-merge prediction, utils/metrics.py:216-219)."""
    from ..ptq.attention import hard_pred, pred_brats_con_merge
    from ..utils.nifti import save_nifti

    for tag, out in (("Qseg", report.output_q), ("FPseg", report.output_fp)):
        if task == "brats":
            pred = pred_brats_con_merge(out[-1])
        else:
            pred = hard_pred(out[-1], task)
        pred = pred.cpu().numpy().astype(np.uint8)
        for i in range(pred.shape[0]):
            save_nifti(P.join(snap_dir, f"{tag}{i}.nii.gz"), pred[i])


def _save_quantized(graph, variables, snap_dir):
    """FP-valued, int8-packed and npz-compressed exports
    (ptqer.py:383-387, PTQConv.store_int_weight): NumPy arrays only, so
    either package loads them."""
    sd = torch_io.to_torch_state_dict(graph, variables)
    # the effective per-layer grids, which the infer mission reads back
    sd["__qlvl_overrides__"] = {
        node.name: (node.attrs["qcfg"].qlvl_w, node.attrs["qcfg"].qlvl_act)
        for node in graph.qconv_nodes()}
    with open(P.join(snap_dir, "state_in_fp.pkl"), "wb") as f:
        pickle.dump({"state_dict": sd}, f)

    sd_int = dict(sd)
    for node in graph.qconv_nodes():
        qcfg = node.attrs["qcfg"]
        if not qcfg.q_weight:
            continue
        w = sd[f"{node.name}.weight"]
        alpha = np.asarray(sd[f"{node.name}.alpha_w"])
        sd_int[f"{node.name}.weight"] = pack_int_weight(w, alpha, qcfg.qlvl_w)
    with open(P.join(snap_dir, "state_in_int8.pkl"), "wb") as f:
        pickle.dump({"state_dict": sd_int}, f)
    np.savez_compressed(P.join(snap_dir, "state_in_int8_compress.npz"),
                        state_dict=sd_int)
