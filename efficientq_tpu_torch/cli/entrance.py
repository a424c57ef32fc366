"""CLI entrance: argparse flags and the YAML-wins config merge.

A copy of the JAX package's ``cli/entrance.py`` flag surface (every flag
the JAX CLI accepts parses here, with the same defaults); a YAML config
overrides command-line values for every non-None entry ("config file
first").  ``python -m efficientq_tpu_torch {ptq,infer} ...`` runs on
``cuda:<--device>``; ``EFFQ_PLATFORM=cpu`` runs it on the CPU, and without
a card and without that setting ``main`` raises.  Flags of branches that
are not ported raise ``NotImplementedError`` naming their ROADMAP item
(``cli/missions.py``).
"""
from __future__ import annotations

import argparse
import re

import torch

# PyYAML's YAML 1.1 scalar resolvers (yaml/resolver.py) for the forms a
# flat config takes: decimal ints, floats with a point, bools, null
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _scalar(text: str):
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        t = text.lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def read_flat_yaml(path: str) -> dict:
    """A flat ``key: value`` YAML file as ``yaml.safe_load`` reads it: int,
    float, bool and null by YAML 1.1's rules, else str; ``#`` comments and
    blank lines skipped.  Every merged key becomes a flag's value, so nested
    maps, lists and multi-line scalars are not read (a nested line raises).
    Ints are decimal: YAML 1.1's binary, octal, hex and ``_``-grouped forms,
    which no config uses, stay strings."""
    out = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            key, sep, value = line.rstrip("\n").partition(":")
            if not sep or key != key.strip() or not key:
                raise ValueError(f"{path}:{n}: not a flat 'key: value' line")
            value = value.strip()
            if value[:1] in ("'", '"'):
                value = value[:value.find(value[0], 1) + 1]
            else:
                value = re.sub(r"(^|\s)#.*$", "", value).strip()
            out[key] = _scalar(value)
    return out


def merge_config(cfg_path: str, args: argparse.Namespace) -> argparse.Namespace:
    """YAML wins over the command line for every non-None entry.  The file
    is read with ``read_flat_yaml`` wherever the CLI runs (PyYAML is not
    installed everywhere)."""
    for k, v in read_flat_yaml(cfg_path).items():
        if v is not None:
            setattr(args, k, v)
    return args


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Entrance for Quantization/FP training/Inference")
    # 'infer' is ours: serve a PTQ export (state_in_int8[_compress]/
    # state_in_fp) without recalibrating — the reference can only evaluate
    # a quantized net by re-running the whole PTQ pipeline
    # (src/ptqer.py:282-387)
    parser.add_argument("mission", choices=["train_fp", "ptq", "infer"])
    parser.add_argument("--pretrain")
    parser.add_argument("--resume")
    parser.add_argument("--device", default=0, type=int,
                        help="CUDA device index (cuda:<device>).")
    parser.add_argument("--task")
    parser.add_argument("--suffix", default="", type=str,
                        help="folder name suffix.")
    parser.add_argument("--test_fp", action="store_true")
    parser.add_argument("--config", type=str)

    # data config
    parser.add_argument("--data_dir")
    parser.add_argument("--split_dir")
    parser.add_argument("--round", default="1", type=str)
    parser.add_argument("--patch_size")
    # ours: the reference hardcodes the sliding-window overlap per task
    # (definer.py:33,44 — always 16); with --patch_size overridable, the
    # overlap must be too, or small patches hit a zero/negative stride
    parser.add_argument("--overlap", default=None,
                        help="sliding-window overlap override (d,h,w); "
                             "default is the task preset's 16,16,16")
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--test_batch_size", default=1, type=int)
    parser.add_argument("--crop_type", default="random")
    parser.add_argument("--balance_rate", type=float)
    parser.add_argument("--data_on_disk", action="store_true")
    parser.add_argument("--bin_label", help="convert to binary label")
    parser.add_argument("--multi_label", help="multiple labels per pixel")
    parser.add_argument("--merge_type", help="how to merge multiple labels")
    parser.add_argument("--random_noise_p", type=float)
    parser.add_argument("--access_type", default="npy")
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--da_scaling", type=str, default=None)
    parser.add_argument("--scal_order", type=int, default=1)

    # model config
    parser.add_argument("--model", default="UResQ")
    parser.add_argument("--nMod", type=int)
    parser.add_argument("--nClass", type=int)
    parser.add_argument("--init_stride", type=str, default="1")
    parser.add_argument("--resblock")
    parser.add_argument("--depth")
    parser.add_argument("--width")
    parser.add_argument("--dilation")
    parser.add_argument("--nla", default="relu")
    parser.add_argument("--norm", type=str, default="bn")
    parser.add_argument("--group_num", type=int, help="GN's group number")
    parser.add_argument("--drop_rate", default=0.2, type=float)
    parser.add_argument("--no_drop", action="store_true")
    parser.add_argument("--ds", type=str, default=None,
                        choices=["simple", "complex", ""])
    parser.add_argument("--init_kernel", default=3, type=int)
    parser.add_argument("--block_type", default="RBpre")
    parser.add_argument("--hetero_dim", action="store_true")
    parser.add_argument("--blk", type=str, default="pre")

    # FP training config
    parser.add_argument("--lr", default=0.001, type=float, metavar="LR",
                        help="initial learning rate")
    parser.add_argument("--max_epoch", type=int, default=20)
    parser.add_argument("--loss", type=str, default="CE")
    parser.add_argument("--test_interval", type=int, default=50)
    parser.add_argument("--disp_interval", type=int, default=10)
    parser.add_argument("--weight_decay", type=str, default="0")
    parser.add_argument("--no_test", action="store_true")
    parser.add_argument("--exp_id", type=str, default=None)

    # quantization config
    parser.add_argument("--qconv", default="conv")
    parser.add_argument("--qlvl_w", type=int)
    parser.add_argument("--qlvl_a", type=int)
    parser.add_argument("--q_first",
                        help="whether quantize first layer, e.g. 256,64")
    parser.add_argument("--q_last", help="similar to q_first")

    # PTQ config
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--lwq_dataid", type=int, default=0)
    parser.add_argument("--lwq_batchsz", type=int, default=1)
    parser.add_argument("--lwq_patchsz")
    parser.add_argument("--lwq_iter", type=int, default=200)
    parser.add_argument("--lwq_rho", type=float, default=10.0)
    parser.add_argument("--lwq_rho_max", type=float, default=1000.0)
    parser.add_argument("--lwq_eta", type=float, default=1.0)
    parser.add_argument("--lwq_verbose", action="store_true")
    # ours: block-granularity calibration (the functional realization of
    # the reference's aspirational PTQBlock, src/models/PTQBlock.py:48-49)
    parser.add_argument("--lwq_granularity", default="layer",
                        choices=["layer", "block"],
                        help="'block' calibrates each ResBlock's exit conv "
                             "against the block's FP output (absorbs "
                             "in-block quantization error).  EXPERIMENTAL: "
                             "it measurably lowers reconstruction error — "
                             "on held-out volumes too — but at 2-bit "
                             "reconstruction anti-correlates with dice and "
                             "'block' never beat 'layer' on held-out dice "
                             "on our gates (docs/quantization.md, "
                             "experiments/block_target_diag.json); prefer "
                             "--mixed_frac with the default --mixed_tail")
    # ours: per-output-channel alpha_w (the 'channel_wise' the reference's
    # PTQBlock reads but no PTQConv defines, src/models/PTQBlock.py:15)
    parser.add_argument("--channel_wise", action="store_true",
                        help="per-output-channel weight scales in the ADMM "
                             "projection and the int8 deployment epilogue")
    # ours: DFQ-style bias correction (Nagel et al. 2019) — absorb the
    # quantized kernel's residual per-channel mean error into the FP bias
    parser.add_argument("--bias_corr", action="store_true",
                        help="per-output-channel bias correction after each "
                             "layer's ADMM (exact for the weighted "
                             "reconstruction objective)")
    # ours: sensitivity-driven mixed precision (engine.run_ptq_mixed) — a
    # first pass ranks layers by relative reconstruction loss, a second
    # recalibrates the worst fraction at --mixed_qlvl.  Serving cost is
    # unchanged (any grid <= 256 levels packs into the same int8 codes).
    parser.add_argument("--mixed_frac", type=float, default=0.0,
                        help="fraction of most-sensitive layers to lift to "
                             "--mixed_qlvl (0 = uniform precision)")
    parser.add_argument("--mixed_tail", choices=["on", "off"], default="on",
                        help="structurally include the final-stage convs "
                             "in the --mixed_frac lift set (the W2A2 "
                             "basin-cascade trigger — basin_probe.py; the "
                             "rel-loss ranking underrates them)")
    parser.add_argument("--mixed_qlvl", type=int, default=16,
                        help="quantization levels for the lifted layers "
                             "(16 = 4-bit)")
    # ours: offset (signed-asymmetric) activation grids — the reference's
    # activation quantizer is unsigned (src/models/layer_helper.py:25-37);
    # layers whose inputs carry negative mass saturate at zero, the
    # measured W2A2 tail-collapse mechanism (docs/quantization.md).
    parser.add_argument("--act_offset", type=int, default=0,
                        help="EXPERIMENTAL: search offset activation grids "
                             "shifting up to K of the qlvl_a levels below "
                             "zero, per layer by input reconstruction "
                             "error (0 = off; deployment stays exact int8 "
                             "via signed codes)")
    parser.add_argument("--act_offset_scope", choices=["tail", "all"],
                        default="tail",
                        help="which convs the --act_offset search covers: "
                             "'tail' = the last ResBlock's (the basin-"
                             "trigger set), 'all' = every q_act conv")
    # ours: the measured W2A2 basin fix — the reconstruction-optimal tail
    # alpha_act clips too tightly for downstream dice; a validated sweep
    # of clip-range factors recovers +0.23 uniform-W2A2 dice on the gate
    # (experiments/tail_alpha_probe.json, docs/quantization.md)
    parser.add_argument("--tail_alpha_sweep", action="store_true",
                        help="after calibration, sweep activation-clip "
                             "factors on the tail convs and keep the best "
                             "by quantized dice on the labeled calibration "
                             "volumes (factor 1.0 included: zero regret "
                             "by the score)")
    parser.add_argument("--tail_alpha_factors",
                        default="1.0,1.3,1.7,2.2,3.0",
                        help="candidate clip-range multipliers for "
                             "--tail_alpha_sweep")
    # ours: calibration-volume selection (ptq/select.py) — the reference
    # leaves --lwq_dataid to the user with no guidance (src/ptqer.py:86-109)
    # while at 2-bit the draw swings dice ~0.1 (docs/quantization.md).
    # Scores each candidate's calibrated net by quantized dice on the
    # labeled candidate (train) volumes; validation is never touched.
    parser.add_argument("--lwq_select", type=int, default=0,
                        help="calibrate on each of K sequential candidate "
                             "volumes (after the --lwq_dataid skip) and "
                             "keep the best by train-volume dice (0 = off)")
    # whole-network alpha_act refinement after the per-layer sweep — the
    # reference implements this but never calls it (src/ptqer.py:238-272);
    # measured +0.002 dice at W2A2 (BASELINE.md). 0 = off, N = Adam iters.
    parser.add_argument("--tune_act", type=int, default=0,
                        help="joint activation-range tuning iterations "
                             "after per-layer PTQ (0 = off)")
    # quantization-aware fine-tuning (ptq/qat.py) — beyond-reference: the
    # reference stops at calibration (src/ptqer.py).  STE training under
    # the deployed fake-quant forward; the best-val-dice epoch is kept
    # (epoch 0 = the pure-PTQ state included, so the flag cannot hurt).
    parser.add_argument("--qat_epochs", type=int, default=0,
                        help="EXPERIMENTAL: QAT fine-tune epochs after PTQ "
                             "calibration (0 = off); trains weights AND "
                             "quantization ranges with STE, keeps the "
                             "best-val-dice epoch (pure PTQ included, so it "
                             "cannot ship worse). Measured boundaries: "
                             "cannot escape act-saturated basins, overfits "
                             "tiny val gates, helps undertrained nets "
                             "(docs/quantization.md)")
    parser.add_argument("--qat_lr", type=float, default=1e-4,
                        help="QAT fine-tune learning rate")

    # evaluation config
    parser.add_argument("--save_nii", action="store_true")
    # the reference implements lesion-level CC metrics and true-test
    # inference but hardcodes both off (src/train_seg.py:183-184); here they
    # are reachable from the CLI
    parser.add_argument("--is_cc", action="store_true",
                        help="lesion-level connected-component metrics "
                             "(fpl/fnl/totall) in the final metric files")
    parser.add_argument("--true_test", action="store_true",
                        help="label-free inference + NIfTI export on the "
                             "true-test split after the final tests")
    parser.add_argument("--patch_batch", type=int, default=0,
                        help="patches per eval forward; 0 = measured "
                             "auto-tune per geometry (eval/autotune.py)")
    parser.add_argument("--tune_serving", default="auto",
                        choices=("off", "auto", "force"),
                        help="serving patch_batch autotuner policy when "
                             "--patch_batch 0: 'auto' sweeps once per "
                             "geometry and caches on disk, 'force' "
                             "re-sweeps ignoring the cache, 'off' uses a "
                             "deterministic min(grid, 8) with no timing "
                             "sweep (no first-eval compile stall)")
    # serving path for the infer mission: 'none' = fake-quant eval graph,
    # 'int8' = every eligible qconv through the int8 deployment rewrite
    # (fused Pallas kernels on TPU), 'mixed' = int8 for the 3^3 convs only
    parser.add_argument("--deploy", default="none",
                        choices=("none", "int8", "mixed"),
                        help="infer-mission serving graph (ptq/deploy.py)")
    # ours: serving artifacts (export.py) — the final-head patch forward
    # with weights baked in, a torch.export program whose K1-K5 are the
    # registered effq:: operators.  The reference's deployment artifact is a weight file
    # that needs the full model code + exact flags to serve
    # (src/models/PTQConv.py:128-143); an artifact serves with neither.
    # ours: host-s2d serving — the init conv as the fused space-to-depth
    # Pallas stem with the s2d transform on the HOST (threaded C++,
    # data/native.py), the fastest measured serving mode (bench.py
    # mixed_s2d_hostvol).  Needs --deploy int8|mixed (or a ptq run's
    # deployed graph); falls back to the direct path per volume when the
    # geometry doesn't support it.  Numerics: bf16-reduction-order level,
    # like --serve_dtype bf16.
    parser.add_argument("--serve_stem", choices=["direct", "s2d"],
                        default="direct",
                        help="'s2d': fused space-to-depth Pallas stem with "
                             "a host-side transform (fastest serving mode; "
                             "patch grid, single device)")
    parser.add_argument("--export_column_depth", type=int, default=0,
                        help="with --export_artifact --serve_grid column: "
                             "the deepest volume D this artifact will "
                             "serve (column patch D is pinned at export; "
                             "shallower volumes pad up at serve time)")
    parser.add_argument("--export_artifact", action="store_true",
                        help="ptq/infer: also write serving_artifact.zip "
                             "(torch.export program of the final-head "
                             "patch forward, weights baked in)")
    parser.add_argument("--artifact", type=str, default=None,
                        help="infer: serve from a serving_artifact.zip — "
                             "no --pretrain and no model flags needed")
    # TPU-native extension (not in the reference flag surface): checkpoint
    # backend — 'pickle' is the reference-parity default, 'orbax' writes
    # directory-based multi-host-safe checkpoints (utils/checkpoint.py)
    parser.add_argument("--ckpt_backend", default="pickle",
                        choices=("pickle", "orbax"))
    # data parallelism over a 1-D device mesh: 0 = off (single device),
    # -1 = all local devices, N = first N devices. Batch must divide evenly.
    parser.add_argument("--dp_devices", type=int, default=0)
    # multi-host / multi-slice (SURVEY.md §2.2: ICI intra-slice, DCN
    # multi-slice): --distributed calls jax.distributed.initialize before
    # any backend work (coordinator/process env vars per jax docs);
    # --mesh_shape D,I builds a hybrid (dcn=D, ici=I) 2-D data mesh
    # (parallel/mesh.py::make_hybrid_mesh) — the batch shards over both
    # axes, --fsdp shards state over the ICI axis only
    parser.add_argument("--distributed", action="store_true",
                        help="initialize jax.distributed (multi-process; "
                             "reads JAX_COORDINATOR_ADDRESS / "
                             "JAX_NUM_PROCESSES / JAX_PROCESS_ID or the "
                             "TPU-pod autodetector)")
    parser.add_argument("--mesh_shape", type=str, default=None,
                        help="'D,I' hybrid data mesh: D slices over DCN x "
                             "I chips over ICI (replaces --dp_devices)")
    # with --dp_devices: ZeRO/FSDP-style sharding of parameters + optimizer
    # state over the data mesh (parallel/mesh.py::fsdp_shardings) — GSPMD
    # derives the all-gather-on-use / reduce-scatter schedule
    parser.add_argument("--fsdp", action="store_true")
    # train_fp: rematerialization — run the forward in N-node jax.checkpoint
    # segments so the backward recomputes segment interiors instead of
    # keeping every activation (nnir.apply remat=); 0 = off
    parser.add_argument("--remat", type=int, default=0)
    # train_fp: mixed-precision training — forward/backward activations at
    # bf16 (MXU-native, no loss scaling needed), f32 master params / grads /
    # BN stats / Adam state; composes with --remat and --fsdp
    parser.add_argument("--amp", action="store_true")
    # serving/eval compute dtype for the final tests and the infer mission:
    # bf16 runs the XLA convs with bf16 operands/outputs (f32 MXU
    # accumulation) — the bench's fastest serving mode; default f32 keeps
    # reference-exact eval numerics
    parser.add_argument("--serve_dtype", default="f32",
                        choices=("f32", "bf16"))
    # serving grid for the final tests and the infer mission: 'column'
    # serves full-depth (D, ph, pw) columns instead of the reference's
    # overlapped D-patch grid — on BraTS the D overlap (patch 128 over
    # D=155, starts {0,27}) recomputes 101 of 155 planes, and a TPU has
    # the HBM to skip that (+21% serving throughput, eval/sliding.py::
    # column_grid_plan).  Opt-in: full-depth activations of unbounded-D
    # tasks (LiTS) can exceed HBM, and D-boundary voxels see more context
    # than the reference grid (>99.9% voxel agreement on the flagship).
    parser.add_argument("--serve_grid", default="patch",
                        choices=("patch", "column"))
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        args = merge_config(args.config, args)
    if args.debug:
        torch.autograd.set_detect_anomaly(True)

    from .missions import infer, ptq, train_fp

    if args.mission == "train_fp":
        return train_fp(args)
    elif args.mission == "ptq":
        return ptq(args)
    elif args.mission == "infer":
        return infer(args)
    raise NotImplementedError(args.mission)


if __name__ == "__main__":
    main()
