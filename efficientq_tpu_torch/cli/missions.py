"""The ``ptq`` and ``infer`` missions.

Counterpart of the JAX package's ``cli/missions.py`` (the reference's
``src/ptq_seg.py`` and ``src/ptqer.py:282-387``).  The artifact files are
the JAX mission's, name for name and format for format, so the exports
interchange: ``cmd.txt``, ``time_cost.txt``, ``layer_loss.txt``,
``layer_loss_curve.npz``, ``class_voxel_nums.txt``, ``Qseg*.nii.gz``,
``FPseg*.nii.gz``, ``state_in_fp.pkl``, ``state_in_int8.pkl``,
``state_in_int8_compress.npz`` (with ``__qlvl_overrides__``; pickles of
NumPy arrays, no torch tensors), and ``{ptq,fp,infer}/{val,test}_seg.txt``
with ``true_test/``.

Flags of branches that are not ported raise ``NotImplementedError`` naming
their ROADMAP queue 1 item: ``train_fp`` (item 6); ``--lwq_select``,
``--mixed_frac``, ``--tail_alpha_sweep``, ``--tune_act``, ``--qat_epochs``,
``--act_offset`` and ``--lwq_granularity block`` (item 7, ``ptq`` only: the
JAX ``infer`` ignores them too); ``--artifact``, ``--export_artifact``,
``--serve_grid column`` and ``--tune_serving force`` (item 8);
``--dp_devices``, ``--mesh_shape`` and ``--distributed`` (item 9).
"""
from __future__ import annotations

import os
import os.path as P
import pickle
import time

import numpy as np
import torch

from .. import nnir
from ..data.transforms import center_crop
from ..eval.validate import validate_seg
from ..models import build_uresq, torch_io, validate_spatial_shape
from ..ptq import run_ptq
from ..quant import pack_int_weight
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


_SERVING = [
    ("--artifact", lambda a: a.artifact, 8),
    ("--export_artifact", lambda a: a.export_artifact, 8),
    ("--serve_grid column", lambda a: a.serve_grid == "column", 8),
    ("--tune_serving force", lambda a: a.tune_serving == "force", 8),
    ("--dp_devices", lambda a: a.dp_devices, 9),
    ("--mesh_shape", lambda a: a.mesh_shape, 9),
    ("--distributed", lambda a: a.distributed, 9),
]
_PTQ_EXTENSIONS = [
    ("--lwq_select", lambda a: a.lwq_select, 7),
    ("--mixed_frac", lambda a: a.mixed_frac, 7),
    ("--tail_alpha_sweep", lambda a: a.tail_alpha_sweep, 7),
    ("--tune_act", lambda a: a.tune_act, 7),
    ("--qat_epochs", lambda a: a.qat_epochs, 7),
    ("--act_offset", lambda a: a.act_offset, 7),
    ("--lwq_granularity block", lambda a: a.lwq_granularity == "block", 7),
]


def _final_test(graph, variables, hub, num_mo, n_class, save_dir, args,
                device, mode="fp"):
    """Per-split metric files, then the label-free true-test export
    (the reference's trainer.py:253-307)."""
    from ..eval.validate import true_test_inference

    os.makedirs(save_dir, exist_ok=True)
    kw = dict(mode=mode, patch_batch=args.patch_batch or "auto",
              compute_dtype=(torch.bfloat16 if args.serve_dtype == "bf16"
                             else None),
              serve_stem=args.serve_stem, device=device)
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


def train_fp(args):
    raise NotImplementedError("train_fp is not ported yet: ROADMAP queue 1 "
                              "item 6")


def _calib_crop_shape(args, img):
    """The shared calibration crop rule (ptqer.py:96-105): explicit
    --lwq_patchsz, else each spatial dim capped at 192 and rounded down to
    a multiple of 64."""
    if args.lwq_patchsz:
        return [int(x) for x in args.lwq_patchsz.split(",")]
    return [min(x, 192) // 64 * 64 for x in img.shape[-3:]]


def _calib_sequence(args, hub, count):
    """``count`` sequential center-cropped (img, label) trainseqloader
    batches after the --lwq_dataid skip (ptqer.py:83-111), with a
    descriptive error when the train split is too short."""
    hub.trainseqloader.dataset.use_fix_transform()
    it = iter(hub.trainseqloader)
    pairs = []
    try:
        for _ in range(args.lwq_dataid):
            next(it)
        while len(pairs) < count:
            img, label = next(it)
            shape = _calib_crop_shape(args, img)
            pairs.append((center_crop(img, shape), center_crop(label, shape)))
    except StopIteration:
        raise ValueError(
            f"calibration needs --lwq_dataid ({args.lwq_dataid}) + {count} "
            f"sequential batches, but the train split has fewer") from None
    return pairs


def get_calibration_data(args, hub):
    """One (or lwq_batchsz-stacked) center-cropped calibration volume(s)
    from the sequential train loader (ptqer.py:83-111)."""
    pairs = _calib_sequence(args, hub, args.lwq_batchsz)
    img = np.concatenate([p[0] for p in pairs], axis=0)
    label = np.concatenate([p[1] for p in pairs], axis=0)
    return img, label


def ptq(args):
    """PTQ mission (ptq_seg.py:7-32 + ptqer.do_ptq:282-387) on
    ``select_device(args)``.  Returns the snapshot directory and the
    mission's seconds by part (data, fp_forward, calibration, final_test,
    exports)."""
    _refuse(args, _PTQ_EXTENSIONS + _SERVING)
    device = select_device(args)
    seconds = {}
    t0 = time.perf_counter()
    hub, data_info, nMod, nClass, patch_size = definer.get_data_cube(args)
    cfg, model_info, n_mo = definer.get_model_config(args)
    graph = build_uresq(cfg)
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
    img, _label = get_calibration_data(args, hub)
    calib_x = np.ascontiguousarray(np.moveaxis(img, 1, -1))  # NDHWC
    if args.lwq_verbose:
        print("Calibration data shape:", img.shape)
    seconds["data"] = time.perf_counter() - t0

    # optional FP evaluation before quantization (ptqer.py:309-310)
    if args.test_fp:
        from ..ptq import fold_bn

        fg, fv = fold_bn(graph, variables)
        _final_test(fg, fv, hub, n_mo, nClass, P.join(snap_dir, "fp"), args,
                    device)

    hp = definer.get_lwq_hyperparams(args)
    fgraph, qvars, report = run_ptq(
        graph, variables, calib_x, task=args.task,
        init_stride=definer.parse_triple(args.init_stride), hp=hp,
        verbose=args.lwq_verbose, granularity=args.lwq_granularity,
        device=device)
    seconds["fp_forward"] = report.fp_forward_seconds
    seconds["calibration"] = report.calibration_seconds

    t0 = time.perf_counter()
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
                    args, device, mode="quantized")
    seconds["final_test"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _save_quantized(fgraph, qvars, snap_dir)
    seconds["exports"] = exports + time.perf_counter() - t0
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
    ptq run that produced the export.  Returns the snapshot directory and
    the seconds of the final test."""
    from ..ptq import apply_qlvl_overrides, fold_bn

    _refuse(args, _SERVING)
    device = select_device(args)
    hub, data_info, nMod, nClass, patch_size = definer.get_data_cube(args)
    cfg, model_info, n_mo = definer.get_model_config(args)
    validate_spatial_shape(patch_size, cfg, "--patch_size")
    graph = build_uresq(cfg)
    variables = nnir.init(graph, 0, device="cpu")
    if not args.pretrain:
        raise ValueError("infer requires --pretrain (a PTQ export)")

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

    t0 = time.perf_counter()
    _final_test(fgraph, fvars, hub, n_mo, nClass, P.join(snap_dir, "infer"),
                args, device, mode="quantized")
    return snap_dir, {"final_test": time.perf_counter() - t0}


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
