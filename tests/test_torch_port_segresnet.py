"""SegResNet (MONAI; Myronenko, BraTS 2018) on the port, on the CPU, at
init_filters 8 with 32^3 patches, 4 modalities and 3 outputs, on seeded
weights, against the plain reference ``tests/segresnet_reference.py``.

- The float graph (``build_segresnet``) equals the reference up to the
  float32 rounding of its convs' sums, which run in another order
  (channels-last here, channels-first there) on the non-dyadic values
  that every GroupNorm emits.
- A ``group_norm`` node equals ``F.group_norm`` up to float32 rounding (its
  statistics are float64, torch's float32).
- The int8 deployment (``to_int8_inference``, then ``serving_graph``: K6
  before every K1 conv, K1's residual epilogue, K5 with its skip, K6's
  ReLU'd float before the head), on the kernels' plain CPU versions,
  equals the reference's quantized forward: dyadic weights, scales and
  intensities keep every conv's sum exact, and both GroupNorms round the
  same float64 statistics to the same float32 values.  Only the head's
  float32 sums of the GroupNorm's output differ, in order, so its logits
  agree to a few float32 ulps.
- The export's keys are MONAI's and round-trip through ``torch_io``.
- ``ptq`` then ``infer --deploy int8`` run ``--model SegResNet`` on
  ``data/synthetic.py`` volumes, and the served graph normalizes on K6's
  route.
- UResQ's deployed graphs come out of the new rewrite node for node.
"""
import math
import os
import os.path as P
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from efficientq_tpu_torch import models, nnir
from efficientq_tpu_torch.cli import definer, entrance
from efficientq_tpu_torch.data.synthetic import make_synthetic_dataset
from efficientq_tpu_torch.eval import sliding
from efficientq_tpu_torch.kernels import WRAPPERS
from efficientq_tpu_torch.kernels import groupnorm as K6
from efficientq_tpu_torch.models import (SegResNetConfig, build_segresnet,
                                         build_uresq, preset_config,
                                         torch_io)
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.ptq.deploy import (group_norm_serving,
                                             serving_graph,
                                             upsample_serving)

import segresnet_reference as ref

CFG = dict(num_mod=4, num_classes=3, init_filters=8,
           blocks_down=[1, 2, 2, 4], blocks_up=[1, 1, 1], num_groups=8,
           norm_eps=1e-5, qlvl_w=4, qlvl_act=4, q_first=[256, -1],
           q_last=[256, -1], act_k=1)
FLOAT = dict(CFG, qlvl_w=0, qlvl_act=0, q_first=[0, 0], q_last=[0, 0],
             act_k=0)
GRID = 2048  # intensities on a 1/2048 grid


def _port_config(cfg):
    quant = cfg["qlvl_w"] > 0
    return SegResNetConfig(
        num_mod=cfg["num_mod"], num_classes=cfg["num_classes"],
        init_filters=cfg["init_filters"], blocks_down=cfg["blocks_down"],
        blocks_up=cfg["blocks_up"], num_groups=cfg["num_groups"],
        norm_eps=cfg["norm_eps"], quantize=quant, qlvl_w=cfg["qlvl_w"] or 8,
        qlvl_act=cfg["qlvl_act"] or 8,
        q_first=tuple(cfg["q_first"]) if quant else None,
        q_last=tuple(cfg["q_last"]) if quant else None)


def _dyadic(t, step):
    return torch.round(t / step) * step


def _weights(cfg, seed=0):
    """A post-PTQ MONAI-style state dict: kaiming-normal kernels, each
    4-level one on its grid with alpha_w = 27 * 2^k nearest max |w|, the
    float ones on a 1/256 grid of their range, activation ranges 4/3, the
    head's bias and the GroupNorm affines on dyadic grids."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for c in ref.convs(cfg):
        w = (torch.randn(c.cout, c.cin, c.k, c.k, c.k, generator=gen)
             * math.sqrt(2.0 / (c.k ** 3 * c.cout)))
        peak = float(w.abs().max())
        if c.qlvl_w:
            nw = c.qlvl_w - 1
            unit = nw * (c.qlvl_act - 1) ** 2 if c.qlvl_act else nw
            alpha = unit * 2.0 ** round(math.log2(peak / unit))
            codes = torch.round((torch.clamp(w / alpha, -1, 1) + 1) * nw / 2)
            w = (codes * 2 - nw) * (alpha / nw)
            sd[f"{c.name}.alpha_w"] = torch.tensor(alpha)
            sd[f"{c.name}.alpha_act"] = torch.tensor(
                4.0 / (c.qlvl_act - 1) if c.qlvl_act else 1.0)
            if c.act_k:
                sd[f"{c.name}.act_k"] = torch.tensor(c.act_k,
                                                     dtype=torch.int32)
        else:
            w = _dyadic(w, 2.0 ** round(math.log2(peak)) / 256)
        sd[f"{c.name}.weight"] = w
        if c.bias:
            sd[f"{c.name}.bias"] = _dyadic(
                0.1 * torch.randn(c.cout, generator=gen), 2.0 ** -6)
    for name, ch, _ in ref.group_norms(cfg):
        sd[f"{name}.weight"] = 1.0 + _dyadic(
            0.2 * torch.randn(ch, generator=gen), 2.0 ** -8)
        sd[f"{name}.bias"] = _dyadic(0.2 * torch.randn(ch, generator=gen),
                                     2.0 ** -6)
    return sd


def _volume(n=1, shape=(32, 32, 32), seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn((n, 4, *shape), generator=gen) + 1.0
    return torch.clamp(torch.round(x * GRID), -2 * GRID, 2 * GRID - 1) / GRID


def _port(cfg, sd):
    """The folded graph and the variables holding ``sd``."""
    graph = build_segresnet(_port_config(cfg))
    fg, fv = fold_bn(graph, nnir.init(graph, 0, device="cpu"))
    return fg, torch_io.load_torch_state_dict(fg, fv, sd, strict=True)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _ncdhw(y):
    return y.permute(0, 4, 1, 2, 3)


def test_float_graph_equals_the_reference():
    sd = _weights(FLOAT)
    fg, fv = _port(FLOAT, sd)
    x = _volume(2)
    got = _ncdhw(nnir.apply(fg, fv, _ndhwc(x), mode="fp")[-1])
    want = ref.Reference(FLOAT, sd).forward(x)[0]
    # float32 sums of non-dyadic values (every conv after a GroupNorm) in
    # another order: a few ulps a layer, over 32 layers (1.3e-6 to 1.8e-6
    # of the largest logit on three seeds)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


def test_group_norm_node_equals_torch_group_norm():
    g = nnir.GraphBuilder()
    g.group_norm("gn", g.input(), 32, 8)
    node = g.build(["gn"]).node("gn")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 6, 5, 7, 32), generator=gen) * 3.0 + 1.5
    p = {"gn": {"scale": 1 + 0.3 * torch.randn(32, generator=gen),
                "bias": 0.3 * torch.randn(32, generator=gen)}}
    before = K6.group_norm.elements
    got = nnir.eval_node(node, p, {}, [x])
    assert K6.group_norm.elements - before == x.numel()
    want = _ndhwc(F.group_norm(_ncdhw(x), 8, p["gn"]["scale"],
                               p["gn"]["bias"], 1e-5))
    # float64 statistics here, float32 in torch: a few float32 ulps
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _deployed(cfg, sd):
    fg, fv = _port(cfg, sd)
    dg, dv = to_int8_inference(fg, fv)
    return serving_graph(dg), dv


def test_int8_deployment_equals_the_quantized_reference():
    sd = _weights(CFG)
    sg, dv = _deployed(CFG, sd)
    x = _volume(2)
    before = K6.group_norm.elements
    got = _ncdhw(nnir.apply(sg, dv, _ndhwc(x), mode="quantized")[-1])
    assert K6.group_norm.elements - before == 2 * 32 ** 3 * (
        8 * 5 + 16 * 6 / 8 + 32 * 6 / 64 + 64 * 8 / 512)
    want = ref.Reference(CFG, sd).forward(x)[0]
    # every value up to the head's input is the reference's, bit for bit;
    # the head sums 8 float32 products of a GroupNorm's output in another
    # order: its logits differ by a few ulps
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 4 * 2.0 ** -23 * scale


def test_a_serving_path_takes_the_plain_k6_by_the_record():
    """The volume inferencer serves on the kernel record it is given: with
    K6's plain version in its ``group_norm`` entry, each of the 25
    GroupNorms of every chunk's forward goes to it, and the prediction is
    the default record's."""
    sg, dv = _deployed(CFG, _weights(CFG))
    calls = []

    def plain_k6(x, *args):
        calls.append(x.shape[0])
        return K6.group_norm_reference(x, *args)

    vol = _ndhwc(_volume(1, (40, 32, 32)))  # 2 patches: one chunk
    kw = dict(patch_batch=2, mode="quantized", heads=slice(-1, None),
              hard_pred=True, multilabel=True)
    got = sliding.make_volume_inferencer(
        sg, kernels=WRAPPERS._replace(group_norm=plain_k6), **kw)(
        dv, vol, (32, 32, 32), (8, 8, 8))
    assert calls == [2] * 25
    want = sliding.make_volume_inferencer(sg, **kw)(dv, vol, (32, 32, 32),
                                                    (8, 8, 8))
    assert got.shape == (1, 1, 40, 32, 32, 3)
    assert torch.equal(got, want)


def test_serving_rewrite_routes_every_group_norm_to_k6():
    sg, _ = _deployed(CFG, _weights(CFG))
    live = nnir.live_nodes(sg, sg.outputs)
    k6 = [n for n in sg.nodes if n.op == "group_norm_k6"]
    assert len(k6) == 25 and not any(
        n.op == "group_norm" for n in sg.nodes)
    k1 = [n for n in sg.nodes if n.attrs.get("pallas")]
    assert len(k1) == 24
    assert {n.attrs["quant_for"] for n in k6 if n.attrs.get("quant_for")} \
        == {n.name for n in k1}
    assert all(n.attrs.get("input_quantized") for n in k1)
    assert sum(bool(n.attrs.get("residual")) for n in k1) == 12
    assert not any(n.attrs.get("residual_relu") for n in k1)
    head = sg.node("conv_final.0")
    assert head.attrs["relu"] and not head.attrs.get("quant_for")
    assert sg.node("conv_final.1").op == "identity"
    k5 = [n for n in sg.nodes if n.op == "upsample_k5"]
    assert len(k5) == 3 and all(len(n.inputs) == 2 for n in k5)
    signed = [n for n in sg.nodes if n.attrs.get("act_k")]
    assert len(signed) == 6
    assert all(n.attrs.get("int8") and not n.attrs.get("pallas")
               for n in signed)
    assert not any(n.op == "relu" and n.name in live for n in sg.nodes)


def test_uresq_deployments_come_out_of_the_rewrite_unchanged():
    for task in ("brats", "lits"):
        graph = build_uresq(preset_config(task, quantize=True))
        fg, fv = fold_bn(graph, nnir.init(graph, 0, device="cpu"))
        dg, _ = to_int8_inference(fg, fv)
        assert group_norm_serving(dg) is dg
        assert serving_graph(dg).nodes == upsample_serving(dg).nodes


def test_export_keys_are_monai_names_and_round_trip():
    sd = _weights(CFG)
    fg, fv = _port(CFG, sd)
    out = torch_io.to_torch_state_dict(fg, fv)
    assert set(out) == set(sd)
    for key in ("convInit.conv.weight", "down_layers.1.0.conv.weight",
                "down_layers.1.1.conv1.conv.weight",
                "down_layers.3.4.norm2.bias", "up_samples.0.0.conv.act_k",
                "up_layers.2.0.norm1.weight", "conv_final.0.weight",
                "conv_final.2.conv.bias"):
        assert key in out, key
    back = torch_io.load_torch_state_dict(
        fg, nnir.init(fg, 1, device="cpu"), out, strict=True)
    for name, entries in fv["params"].items():
        for k, v in entries.items():
            assert torch.equal(torch.as_tensor(back["params"][name][k]),
                               torch.as_tensor(v)), (name, k)


MODEL = ["--model", "SegResNet", "--norm", "gn", "--width", "8", "--depth",
         "1,2,2,4,1,1,1", "--nMod", "4", "--nClass", "4"]
QUANT = ["--qconv", "effq", "--qlvl_w", "4", "--qlvl_a", "4", "--q_first",
         "256,-1", "--q_last", "256,-1"]


def test_model_flags_give_the_segresnet_config():
    args = entrance.build_parser().parse_args(
        ["ptq", "--task", "brats", "--multi_label", "brats", *MODEL, *QUANT])
    cfg, info, n_mo = definer.get_model_config(args)
    assert isinstance(cfg, SegResNetConfig) and n_mo == 1
    assert (cfg.init_filters, cfg.blocks_down, cfg.blocks_up,
            cfg.num_groups, cfg.num_classes) == (8, (1, 2, 2, 4), (1, 1, 1),
                                                 8, 3)
    assert cfg.q_first == (256, -1) and info == "SegResNet_GN"
    assert models.min_input_divisor(cfg) == (8, 8, 8)
    with pytest.raises(ValueError, match="axes D"):
        models.validate_spatial_shape((36, 32, 32), cfg, "--patch_size")
    args.norm = "bn"
    with pytest.raises(NotImplementedError, match="--norm gn"):
        definer.get_model_config(args)


def test_ptq_then_int8_infer_on_synthetic_volumes(tmp_path):
    root = str(tmp_path)
    data_dir, split_dir = make_synthetic_dataset(
        root, task="brats", n_subjects=4, vol_shape=(32, 32, 32))
    args = entrance.build_parser().parse_args(
        ["ptq", "--task", "brats", "--multi_label", "brats", *MODEL,
         *QUANT])
    graph = build_segresnet(definer.get_model_config(args)[0])
    v = nnir.init(graph, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for node in graph.nodes:
        if node.op == "group_norm":
            p = v["params"][node.name]
            p["scale"] = 1 + 0.2 * torch.randn(p["scale"].shape,
                                               generator=gen)
            p["bias"] = 0.2 * torch.randn(p["bias"].shape, generator=gen)
    ckpt = P.join(root, "pretrain.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"state_dict": torch_io.to_torch_state_dict(graph, v)},
                    f)
    base = ["--task", "brats", "--data_dir", data_dir, "--split_dir",
            split_dir, "--round", "1", "--patch_size", "32,32,32",
            "--overlap", "8,8,8", "--access_type", "npy", "--multi_label",
            "brats", "--merge_type", "con", "--num_workers", "0", *MODEL,
            *QUANT]
    cwd, saved = os.getcwd(), os.environ.get("EFFQ_PLATFORM")
    os.chdir(root)
    os.environ["EFFQ_PLATFORM"] = "cpu"
    try:
        snap, _ = entrance.main(
            ["ptq", *base, "--pretrain", ckpt, "--lwq_patchsz", "32,32,32",
             "--lwq_iter", "4", "--act_offset", "1", "--act_offset_scope",
             "all"])
        export = P.join(snap, "state_in_int8.pkl")
        before = K6.group_norm.elements
        out, _ = entrance.main(["infer", *base, "--deploy", "int8",
                                "--pretrain", export])
    finally:
        os.chdir(cwd)
        if saved is None:
            os.environ.pop("EFFQ_PLATFORM", None)
        else:
            os.environ["EFFQ_PLATFORM"] = saved
    for name in ("layer_loss.txt", "state_in_int8.pkl", "ptq/test_seg.txt"):
        assert P.isfile(P.join(snap, name)), name
    assert P.isfile(P.join(out, "infer", "test_seg.txt"))
    with open(P.join(snap, "layer_loss.txt")) as f:
        assert len(f.read().splitlines()) == 32
    # the val and test volumes, whole, through the 25 GroupNorms
    per_volume = 32 ** 3 * (8 * 5 + 16 * 6 / 8 + 32 * 6 / 64
                            + 64 * 8 / 512)
    assert K6.group_norm.elements - before == 2 * per_volume
    sd = torch_io._read_export_state_dict(export)
    ks = [int(np.asarray(sd[k])) for k in sd if k.endswith(".act_k")]
    assert ks and all(k in (0, 1) for k in ks)
