"""Wiring layer: args -> data hub, model graph, snapshot directories.

A copy of the JAX package's ``cli/definer.py`` (the reference's
``src/definer.py``): task presets (BraTS: 4 modalities, 4 classes, 128^3
patches, overlap 16; LiTS: 1 modality, 3 classes, 128x128x64), label
split/merge lambdas, the model configuration with its quantization
parameters, and the snapshot layout
``exp_*/<task>/snap/round<k>/<exp_id>`` with cmd.txt and a config copy.
"""
from __future__ import annotations

import os
import os.path as P
import pickle
import shutil
import sys
import time

import numpy as np

from ..data import labels as LB
from ..data.datahub import DataHub
from ..models import (SegResNetConfig, SwinUNETRConfig, UResQConfig,
                      num_mo as model_num_mo)


def parse_triple(s, default=None):
    if s is None:
        return default
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    s = str(s)
    if "," in s:
        return tuple(int(x) for x in s.split(","))
    return (int(s),) * 3


def timestr_mdhm():
    return time.strftime("%m%d%H%M")


def get_data_cube(args):
    """Returns (data_cube, data_info, nMod, nClass, patch_size)
    (definer.py:13-127)."""
    data_info = ""
    round_str = "round" + str(args.round)

    tfm_lambda = None
    merge_label_func = None
    if args.bin_label:
        tfm_lambda = lambda img, label: (img, (label > 0).astype(np.int64))
        data_info += "_BinLabel"
    if args.multi_label:
        if args.multi_label.lower() == "brats":
            tfm_lambda = lambda img, label: (img, LB.split_label_brats(label))
            merge_label_func = LB.merge_label_brats
            data_info += "MulLabelBRATS"
        elif args.multi_label.lower() == "lits":
            tfm_lambda = lambda img, label: (img, LB.split_label_lits(label))
            merge_label_func = LB.merge_label_lits
            data_info += "MulLabelLiTS"
    if args.merge_type:
        data_info += "_Merge_" + args.merge_type

    task = args.task.lower()
    if task == "brats":
        modalities = ("seg", "flair", "t1", "t1ce", "t2")
        data_dir = args.data_dir or "../data/seg/BRATS2020/train_std_crop"
        split_dir = args.split_dir or "../data/seg/BRATS2020/split"
        nMod = args.nMod or 4
        nClass = args.nClass or 4
        patch_size = (128, 128, 128)
        overlap = (16, 16, 16)
        balance_mask_func = lambda label: label == 3
    elif task == "lits":
        modalities = ("seg", "ct")
        data_dir = args.data_dir or "../data/seg/LiTS/train_crop_npy_256"
        split_dir = args.split_dir or "../data/seg/LiTS/split"
        nMod = args.nMod or 1
        nClass = args.nClass or 3
        patch_size = (128, 128, 64)
        overlap = (16, 16, 16)
        if merge_label_func:
            balance_mask_func = lambda label: label[1] > 0
        else:
            balance_mask_func = lambda label: label == 2
    else:
        raise ValueError(f"Unknown task: {args.task}")

    if args.bin_label:
        nClass = 2
    if args.multi_label:
        nClass -= 1
    if args.patch_size:
        patch_size = parse_triple(args.patch_size)
    if getattr(args, "overlap", None):
        overlap = parse_triple(args.overlap)
        if any(o >= p for o, p in zip(overlap, patch_size)):
            raise ValueError(f"sliding-window --overlap {overlap} must be "
                             f"smaller than the patch size {patch_size} "
                             "per axis")
    elif any(o >= p for o, p in zip(overlap, patch_size)):
        # the preset overlap (16, hardcoded per task in the reference,
        # definer.py:33,44) cannot stride a smaller --patch_size: clamp so
        # the eval grid covers the whole volume instead of degenerating to
        # the terminal patch per axis
        # clamp ONLY the violating axes — a valid axis keeps its preset
        # stitch geometry (and its dice) untouched
        overlap = tuple(o if o < p else p // 2
                        for o, p in zip(overlap, patch_size))
        print(f"note: sliding-window overlap clamped to {overlap} for "
              f"patch {patch_size} (pass --overlap to control)")

    scale_bound = None
    if args.da_scaling:
        scale_bound = tuple(float(x) for x in args.da_scaling.split(","))

    hub = DataHub(
        data_dir, modalities,
        train_split=P.join(split_dir, round_str, "train.txt"),
        val_split=P.join(split_dir, round_str, "val.txt"),
        test_split=P.join(split_dir, round_str, "test.txt"),
        true_test_split=P.join(split_dir, round_str, "true_test.txt"),
        train_batchsize=args.batch_size, test_batchsize=args.test_batch_size,
        access_type=args.access_type,
        crop_type=args.crop_type, balance_rate=args.balance_rate,
        balance_mask_func=balance_mask_func, crop_size_img=patch_size,
        on_disk=args.data_on_disk, random_noise_prob=args.random_noise_p,
        scale_bound=scale_bound, scale_order=args.scal_order,
        sn_fn_file="sn_fn.txt", slide_patch_size=patch_size,
        slide_overlap=overlap, tfm_lambda=tfm_lambda,
        num_workers=args.num_workers)

    # BraTS whole-volume shape restoration for NIfTI export (definer.py:113-123)
    if task == "brats":
        pkl = P.join(data_dir, "restore_shape_infokw.pickle")
        if P.isfile(pkl):
            from ..eval.validate import restore_crop
            with open(pkl, "rb") as f:
                hub.restore_infokw = pickle.load(f)
            hub.restore_shape_func = restore_crop
    hub.merge_label_func = merge_label_func
    hub.multilabel_fusetype = args.merge_type

    return hub, data_info, nMod, nClass, patch_size


def _quant_config(args):
    """The model config's quantization fields from the quantization
    flags."""
    quantize = args.qconv.lower() != "conv"
    q_first = q_last = None
    qlvl_w = qlvl_act = 8
    if quantize:
        qlvl_w = args.qlvl_w
        qlvl_act = args.qlvl_a if (args.qlvl_a and args.qlvl_a > 0) else 256
        if args.q_first:
            q_first = tuple(int(x) for x in str(args.q_first).split(","))
        if args.q_last:
            q_last = tuple(int(x) for x in str(args.q_last).split(","))
    return dict(quantize=quantize, qlvl_w=qlvl_w, qlvl_act=qlvl_act,
                q_weight=(args.qlvl_w or 0) > 0 if quantize else False,
                q_act=(args.qlvl_a or 0) > 0 if quantize else False,
                q_first=q_first, q_last=q_last)


def _segresnet_config(args, nMod, nClass) -> SegResNetConfig:
    """SegResNet (MONAI) from the model flags: ``--width`` the initial
    filters (one number), ``--depth`` the ResBlocks of each encoder level
    then of each decoder level (2L - 1 numbers: MONAI's blocks_down, then
    blocks_up), ``--norm gn`` with ``--group_num`` groups (8 unless
    given), ReLU.  No dropout: MONAI's inference network has none."""
    if args.norm.lower() != "gn":
        raise NotImplementedError("SegResNet runs with GroupNorm: pass "
                                  "--norm gn (and --group_num, 8 if unset)")
    if args.nla.lower() != "relu":
        raise RuntimeError(f"SegResNet uses ReLU, got --nla {args.nla}")
    if args.ds:
        raise ValueError("SegResNet has no deep-supervision heads (--ds)")
    widths = ([int(x) for x in str(args.width).split(",")] if args.width
              else [32])
    if len(widths) != 1:
        raise ValueError(f"SegResNet takes one --width, its initial "
                         f"filters, got {args.width}")
    depths = ([int(x) for x in str(args.depth).split(",")] if args.depth
              else [1, 2, 2, 4, 1, 1, 1])
    if len(depths) % 2 != 1:
        raise ValueError(f"SegResNet's --depth lists the encoder's levels "
                         f"then the decoder's, 2L - 1 numbers, got "
                         f"{args.depth}")
    n_down = len(depths) // 2 + 1
    return SegResNetConfig(
        num_mod=nMod, num_classes=nClass, init_filters=widths[0],
        blocks_down=depths[:n_down], blocks_up=depths[n_down:],
        num_groups=args.group_num or 8, **_quant_config(args))


def _swinunetr_config(args, nMod, nClass) -> SwinUNETRConfig:
    """SwinUNETR (MONAI) from the model flags: ``--width`` its
    feature_size (one number, 48 unless given), ``--depth`` the Swin
    blocks of its four stages (2,2,2,2 unless given), ``--norm in``
    (InstanceNorm, MONAI's default), ``--nla lrelu`` (LeakyReLU 0.01);
    MONAI's heads (3, 6, 12, 24), window 7, patch 2 and MLP ratio 4.  No
    dropout: its inference network has none."""
    if args.norm.lower() not in ("in", "instance"):
        raise NotImplementedError("SwinUNETR runs with InstanceNorm: pass "
                                  "--norm in")
    if args.nla.lower() not in ("lrelu", "leakyrelu"):
        raise RuntimeError(f"SwinUNETR uses LeakyReLU (--nla lrelu), got "
                           f"--nla {args.nla}")
    if args.ds:
        raise ValueError("SwinUNETR has no deep-supervision heads (--ds)")
    # (a YAML config gives the one number as an int)
    widths = ([int(x) for x in str(args.width).split(",")] if args.width
              else [48])
    if len(widths) != 1:
        raise ValueError(f"SwinUNETR takes one --width, its feature_size, "
                         f"got {args.width}")
    depths = ([int(x) for x in str(args.depth).split(",")] if args.depth
              else [2, 2, 2, 2])
    if len(depths) != 4:
        raise ValueError(f"SwinUNETR's --depth lists the Swin blocks of its "
                         f"four stages, got {args.depth}")
    return SwinUNETRConfig(num_mod=nMod, num_classes=nClass,
                           feature_size=widths[0], depths=depths,
                           **_quant_config(args))


def get_model_config(args):
    """Returns (model config, model_info, num_mo) (definer.py:130-248):
    a ``UResQConfig``, or for ``--model SegResNet`` a ``SegResNetConfig``
    and for ``--model SwinUNETR`` a ``SwinUNETRConfig`` (one head)."""
    task = args.task.lower()
    nMod = args.nMod or (4 if task == "brats" else 1)
    nClass = args.nClass or (4 if task == "brats" else 3)
    if args.bin_label:
        nClass = 2
    if args.multi_label:
        nClass -= 1

    if args.model not in ("UResQ", "SegResNet", "SwinUNETR"):
        raise ValueError(f"Unknown model name: {args.model}")
    if args.model in ("SegResNet", "SwinUNETR"):
        model_info = args.model + "_" + args.norm.upper()
        make = (_segresnet_config if args.model == "SegResNet"
                else _swinunetr_config)
        return make(args, nMod, nClass), model_info, 1

    # --nla selects in-place vs non-in-place ReLU (definer.py:179-184);
    # for the 'mid' ordering this changes the residual math (the in-place
    # relu mutates the skip source), so it must reach the model config.
    nla = args.nla.lower()
    if nla == "relu":
        inplace_nla = True
    elif nla == "reluf":
        inplace_nla = False
    else:
        raise RuntimeError(f"Unknown NLA name: {args.nla}")

    # only BN is supported; hard-error on anything else rather than
    # silently running BN (definer.py:187-191)
    if args.norm.lower() != "bn":
        raise NotImplementedError("Norm type should be in BN")

    init_stride = parse_triple(args.init_stride)
    widths = ([int(x) for x in args.width.split(",")] if args.width
              else [32, 64, 128, 256, 128, 64, 32])
    depths = ([int(x) for x in args.depth.split(",")] if args.depth
              else [1] * len(widths))
    dils = ([int(x) for x in args.dilation.split(",")] if args.dilation
            else [1] * len(widths))

    ds_depth_limit = 3 if 2 in init_stride else 4
    aniso_pool_depth = 99999
    if args.hetero_dim:
        aniso_pool_depth = 99999 if 2 in init_stride else 4

    cfg = UResQConfig(
        num_mod=nMod, num_classes=nClass, depth_config=depths,
        width_config=widths, dilation_config=dils, init_stride=init_stride,
        stride=2, drop_rate=args.drop_rate, blk_type=args.blk,
        ds=args.ds or None, init_kernel=args.init_kernel, fuse_bn=True,
        drop_cut_thres=128, ds_depth_limit=ds_depth_limit,
        aniso_pool_depth=aniso_pool_depth, aniso_pool_stride=(2, 2, 1),
        inplace_nla=inplace_nla, **_quant_config(args))

    model_info = args.model + "_" + args.norm.upper()
    n_mo = model_num_mo(cfg) if args.ds else 1
    return cfg, model_info, n_mo


def qinfo_string(args) -> str:
    """Experiment-id quantization tag (definer.py:286-319)."""
    if args.qconv.lower() == "conv":
        return "FP"
    q_weight = (args.qlvl_w or 0) > 0
    q_act = (args.qlvl_a or 0) > 0
    qlvl_act = args.qlvl_a if q_act else 256
    if q_act and q_weight:
        info = f"bothQw{args.qlvl_w}a{qlvl_act}"
    elif q_act:
        info = f"actQa{qlvl_act}"
    else:
        info = f"weightQw{args.qlvl_w}"
    return args.qconv + "_" + info


def get_lwq_hyperparams(args):
    from ..ptq import PTQHyperParams

    return PTQHyperParams(
        admm_iter=getattr(args, "lwq_iter", 200) or 200,
        rho=getattr(args, "lwq_rho", 10.0) or 10.0,
        rho_max=getattr(args, "lwq_rho_max", 1000.0) or 1000.0,
        eta=getattr(args, "lwq_eta", 1.0) or 1.0,
        channel_wise=bool(getattr(args, "channel_wise", False)),
        bias_corr=bool(getattr(args, "bias_corr", False)))


def make_snapshot_dir(args, exp_kind: str, model_info: str, qinfo: str) -> str:
    """exp_{fp,ptq}/<task>/snap/round<k>/<exp_id> with cmd.txt + config copy
    (definer.py:251-283, train_seg.py:69-78)."""
    round_str = "round" + str(args.round)
    exp_id = f"{model_info}_{timestr_mdhm()}_{qinfo}" + (args.suffix or "")
    root = P.join(os.getcwd(), exp_kind, args.task, "snap", round_str, exp_id)
    os.makedirs(root, exist_ok=True)
    with open(P.join(root, "cmd.txt"), "w") as f:
        f.write(str(sys.argv) + "\n" + " ".join(sys.argv) + "\n")
    if args.config and P.isfile(args.config):
        shutil.copy2(args.config, P.join(root, P.basename(args.config)))
    print(f"Snapshot to {root}")
    return root
