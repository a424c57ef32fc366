"""SwinUNETR (MONAI; Hatamizadeh et al., BraTS 2021) on the port, on the
CPU, at feature_size 12 with heads (1, 2, 4, 8) (a head dimension of 12)
and 32^3 patches, 4 modalities and 3 outputs, on seeded weights, against
the plain reference ``tests/swinunetr_reference.py``.

- The float graph (``build_swin_unetr``) equals the reference up to the
  float32 rounding of its convs' and linears' sums, which run in another
  order.  At window 7 the stages' grids (16, 8, 4, 2) pad to 21 and 14
  and shift, then shrink to the extent; at window 3 they pad to 18, 9 and
  6 and shift, and the last shrinks (MONAI's ``get_window_size``).
- The int8 deployment (``to_int8_inference``, then ``serving_graph``: K3
  for every linear, 1^3 and transposed conv, K1 for every 3^3 conv, the
  offset-grid ones too, K6 for every InstanceNorm, K7 for every window
  attention), on the kernels' plain CPU versions, equals the reference's
  quantized forward to float32 rounding: dyadic weights, scales and
  intensities keep every conv's and linear's sum exact.
- At the published widths the served graph routes 19 convs to K1, 46 to
  K3, 8 attentions to K7 and 26 InstanceNorms to K6 (the graph alone).
- The export's keys are MONAI's (the linears (out, in), the transposed
  convs (in, out, 2, 2, 2), the position indices) and round-trip.
- ``ptq`` then ``infer --deploy int8 --model SwinUNETR`` run on
  ``data/synthetic.py`` volumes; training, QAT, s2d and the artifacts
  refuse it.
- The UResQ (LiTS, BraTS) and SegResNet served graphs, their kernel flags
  and their per-chunk counters are what the rewrites gave before
  SwinUNETR joined them.
"""
import math
import os
import os.path as P
import pickle

import numpy as np
import pytest
import torch

from efficientq_tpu_torch import models, nnir, ops
from efficientq_tpu_torch.cli import definer, entrance
from efficientq_tpu_torch.data.synthetic import make_synthetic_dataset
from efficientq_tpu_torch.kernels import groupnorm as K6
from efficientq_tpu_torch.kernels import window_attention as K7
from efficientq_tpu_torch.kernels.epilogue import fuse_int8_epilogues
from efficientq_tpu_torch.kernels.qmatmul import to_pallas_inference
from efficientq_tpu_torch.models import (SegResNetConfig, SwinUNETRConfig,
                                         build_model, build_segresnet,
                                         build_uresq, preset_config,
                                         torch_io)
from efficientq_tpu_torch.nnir import Graph
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.ptq.deploy import (group_norm_serving,
                                             serving_graph,
                                             upsample_serving)

import swinunetr_reference as ref

CFG = dict(num_mod=4, num_classes=3, feature_size=12, depths=[2, 2, 2, 2],
           num_heads=[1, 2, 4, 8], window_size=7, patch_size=2, mlp_ratio=4,
           norm_eps=1e-5, qlvl_w=4, qlvl_act=4, q_first=[256, -1],
           q_last=[256, -1], act_k=1)
FLOAT = dict(CFG, qlvl_w=0, qlvl_act=0, q_first=[0, 0], q_last=[0, 0],
             act_k=0)
PUBLISHED = dict(CFG, feature_size=48, num_heads=[3, 6, 12, 24])
GRID = 2048  # intensities on a 1/2048 grid


def _port_config(cfg):
    quant = cfg["qlvl_w"] > 0
    return SwinUNETRConfig(
        num_mod=cfg["num_mod"], num_classes=cfg["num_classes"],
        feature_size=cfg["feature_size"], depths=cfg["depths"],
        num_heads=cfg["num_heads"], window_size=cfg["window_size"],
        norm_eps=cfg["norm_eps"], quantize=quant,
        qlvl_w=cfg["qlvl_w"] or 8, qlvl_act=cfg["qlvl_act"] or 8,
        q_first=tuple(cfg["q_first"]) if quant else None,
        q_last=tuple(cfg["q_last"]) if quant else None)


def _dyadic(t, step):
    return torch.round(t / step) * step


def _shape(c):
    if c.kind == "linear":
        return (c.cout, c.cin)
    if c.kind == "transp":
        return (c.cin, c.cout, 2, 2, 2)
    return (c.cout, c.cin, c.k, c.k, c.k)


def _weights(cfg, seed=0):
    """A post-PTQ MONAI-style state dict: kaiming-normal weights, each
    4-level one on its grid with alpha_w = 27 * 2^k nearest max |w|, the
    float ones on a 1/256 grid of their range, activation ranges 4/3, the
    biases, LayerNorm affines and bias tables on dyadic grids."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for c in ref.layers(cfg):
        w = torch.randn(_shape(c), generator=gen) * math.sqrt(
            2.0 / (math.prod(_shape(c)) // c.cout))
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
    for name, ch, _, affine in ref.layer_norms(cfg):
        if affine:
            sd[f"{name}.weight"] = 1.0 + _dyadic(
                0.1 * torch.randn(ch, generator=gen), 2.0 ** -8)
            sd[f"{name}.bias"] = _dyadic(0.1 * torch.randn(ch, generator=gen),
                                         2.0 ** -6)
    rows = (2 * cfg["window_size"] - 1) ** 3
    for name, _, heads, _, _ in ref.attentions(cfg):
        sd[f"{name}.relative_position_bias_table"] = _dyadic(
            0.5 * torch.randn(rows, heads, generator=gen), 2.0 ** -8)
        sd[f"{name}.relative_position_index"] = ref.position_index(
            cfg["window_size"])
    return sd


def _volume(n=1, shape=(32, 32, 32), seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn((n, 4, *shape), generator=gen) + 1.0
    return torch.clamp(torch.round(x * GRID), -2 * GRID, 2 * GRID - 1) / GRID


def _port(cfg, sd):
    """The graph and the variables holding ``sd``."""
    graph = build_model(_port_config(cfg))
    return graph, torch_io.load_torch_state_dict(
        graph, nnir.init(graph, 0, device="cpu"), sd, strict=True)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _ncdhw(y):
    return y.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("window", [7, 3])
def test_float_graph_equals_the_reference(window):
    cfg = dict(FLOAT, window_size=window)
    sd = _weights(cfg)
    g, v = _port(cfg, sd)
    x = _volume(1)
    heads = K7.window_attention.window_heads
    got = _ncdhw(nnir.apply(g, v, _ndhwc(x), mode="fp")[-1])
    # the stages' windows, padding included: window 7 on 16^3 pads to
    # 21^3 (27 windows) and on 8^3 to 14^3 (8), 4^3 and 2^3 shrink to one;
    # window 3 pads to 18^3 (216), 9^3 (27), 6^3 (8), 2^3 shrinks
    per_stage = [27, 8, 1, 1] if window == 7 else [216, 27, 8, 1]
    assert K7.window_attention.window_heads - heads == sum(
        2 * n * h for n, h in zip(per_stage, cfg["num_heads"]))
    want = ref.Reference(cfg, sd).forward(x)[0]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale


def _brute_tile_scores(extent, window, shift, n, heads):
    """K7's tile scores counted on the plain version's own grid: a mask
    of the unpadded grid zero-padded, rolled and cut into windows as
    ``window_attention_reference`` cuts qkv; per window its real rows
    rounded up to a 16-row tile, times its tokens rounded up to 16."""
    w, s = K7.window_geometry(extent, window, shift)
    pad = [-(-e // k) * k for e, k in zip(extent, w)]
    real = torch.zeros(pad)
    real[:extent[0], :extent[1], :extent[2]] = 1
    real = torch.roll(real, shifts=[-k for k in s], dims=(0, 1, 2))
    tokens = w[0] * w[1] * w[2]
    rows = real.view(pad[0] // w[0], w[0], pad[1] // w[1], w[1],
                     pad[2] // w[2], w[2]).permute(0, 2, 4, 1, 3, 5)
    rows = rows.reshape(-1, tokens).sum(1).long()
    tiles = (rows + 15) // 16 * 16
    return n * heads * int(tiles.sum()) * (-(-tokens // 16) * 16)


# (extent, window, shift, samples, heads): the cell's eight attentions (a
# chunk of 8 patches of 128^3), then windows that shrink to the grid (to
# one token, to 30, to 7 x 7 x 5) or do not fill their tiles
TILE_CASES = [((e,) * 3, (7,) * 3, (s,) * 3, 8, hh)
              for e, hh in ((64, 3), (32, 6), (16, 12), (8, 24))
              for s in (0, 3)] + [
    ((1, 1, 1), (7,) * 3, (3,) * 3, 2, 2),
    ((2, 3, 5), (7,) * 3, (3,) * 3, 2, 2),
    ((16, 9, 5), (7,) * 3, (3,) * 3, 2, 2),
    ((4, 4, 4), (7,) * 3, (3,) * 3, 2, 2),
    ((5, 9, 16), (7,) * 3, (3,) * 3, 2, 2),
    ((13, 10, 9), (7,) * 3, (0,) * 3, 2, 2),
    ((48, 24, 12), (7,) * 3, (3,) * 3, 1, 3),
    ((18, 9, 6), (3,) * 3, (1,) * 3, 1, 4),
]


@pytest.mark.parametrize("extent,window,shift,n,heads", TILE_CASES)
def test_tile_scores_counts_the_padded_tiles(extent, window, shift, n,
                                             heads):
    got = K7.tile_scores(extent, window, shift, n, heads)
    assert got == _brute_tile_scores(extent, window, shift, n, heads)
    w, _ = K7.window_geometry(extent, window, shift)
    queries = n * heads * math.prod(extent)
    assert got >= queries * math.prod(w)


def test_tile_scores_is_a_counter_that_replays_add():
    from efficientq_tpu_torch.kernels import COUNTERS
    assert (K7.window_attention, "tile_scores") in COUNTERS
    # the cell's 64^3 stage: 6.7 % of its tiles' scores are padding
    ext, n = (64,) * 3, 8
    pad = K7.tile_scores(ext, (7,) * 3, (0,) * 3, n, 3) / (
        n * 3 * 64 ** 3 * 343)
    assert 1.06 < pad < 1.07


def _deployed(cfg, sd):
    g, v = _port(cfg, sd)
    dg, dv = to_int8_inference(g, v)
    return serving_graph(dg), dv


def test_int8_deployment_equals_the_quantized_reference():
    sd = _weights(CFG)
    sg, dv = _deployed(CFG, sd)
    x = _volume(2)
    gn, ln = K6.group_norm.elements, ops.layer_norm.elements
    got = _ncdhw(nnir.apply(sg, dv, _ndhwc(x), mode="quantized")[-1])
    assert K6.group_norm.elements - gn == 2 * sum(
        32 ** 3 // 8 ** lv * ch for _, ch, lv in ref.instance_norms(CFG))
    assert ops.layer_norm.elements - ln == 2 * sum(
        32 ** 3 // 8 ** lv * ch for _, ch, lv, _ in ref.layer_norms(CFG))
    want = ref.Reference(CFG, sd).forward(x)[0]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got >= 0, want >= 0)


def _offset(name):
    return (name.endswith(("attn.qkv", "attn.proj", "mlp.linear1",
                           "downsample.reduction"))
            or (name.endswith("conv1.conv")
                and not name.startswith("encoder1."))
            or (name.endswith("conv3.conv") and name.startswith("decoder")))


def test_served_routing_at_the_published_widths():
    """The int8 deployment's flags from the graph alone (no weights): the
    eligible convs int8, the offset-grid ones with act_k = 1."""
    graph = build_model(_port_config(PUBLISHED))
    nodes = []
    for n in graph.nodes:
        q = n.attrs.get("qcfg")
        if n.op == "conv" and q is not None and q.q_act and q.qlvl_w <= 128:
            attrs = dict(n.attrs, int8=True)
            if _offset(n.name):
                attrs["act_k"] = 1
            n = nnir.Node(n.name, n.op, n.inputs, attrs)
        nodes.append(n)
    dg = fuse_int8_epilogues(to_pallas_inference(
        Graph(nodes, list(graph.outputs), graph.input_name)))
    sg = serving_graph(dg)
    k1 = [n for n in sg.nodes if n.attrs.get("pallas")
          and n.attrs["kernel_size"] == (3, 3, 3)]
    k3 = [n for n in sg.nodes if n.attrs.get("pallas")
          and n.attrs["kernel_size"] == (1, 1, 1)]
    k6 = [n for n in sg.nodes if n.op == "group_norm_k6"]
    k7 = [n for n in sg.nodes if n.op == "window_attention"]
    assert (len(k1), len(k3), len(k7), len(k6)) == (19, 46, 8, 26)
    assert sum(bool(n.attrs.get("act_k")) for n in k1) == 9
    assert sum(bool(n.attrs.get("act_k")) for n in k3) == 33
    assert sum(bool(n.attrs.get("linear")) for n in k3) == 36
    assert sum(bool(n.attrs.get("transposed")) for n in k3) == 5
    # K6 emits conv2's codes (the leaky relu is its clip at 0), and the
    # other norms' floats, which the add and the leaky relu take
    assert {n.attrs.get("quant_for") for n in k6} - {None} == {
        n.name for n in k1 if n.name.endswith("conv2.conv")}
    assert all(bool(n.attrs.get("input_quantized")) == n.name.endswith(
        "conv2.conv") for n in k1)
    assert not any(n.op == "group_norm" for n in sg.nodes)
    # the float layers stay off the kernels
    assert {n.name for n in sg.nodes if n.op == "conv"
            and not n.attrs.get("pallas")} == {
        "swinViT.patch_embed.proj", "encoder1.layer.conv1.conv",
        "encoder1.layer.conv3.conv", "out.conv.conv"}


def test_export_keys_are_monai_names_and_round_trip():
    sd = _weights(CFG)
    g, v = _port(CFG, sd)
    out = torch_io.to_torch_state_dict(g, v)
    assert set(out) == set(sd)
    for key, shape in (
            ("swinViT.patch_embed.proj.weight", (12, 4, 2, 2, 2)),
            ("swinViT.layers1.0.blocks.1.attn.qkv.weight", (36, 12)),
            ("swinViT.layers1.0.blocks.1.attn.relative_position_bias_table",
             (2197, 1)),
            ("swinViT.layers1.0.blocks.1.attn.relative_position_index",
             (343, 343)),
            ("swinViT.layers4.0.blocks.0.mlp.linear2.weight", (96, 384)),
            ("swinViT.layers2.0.downsample.reduction.weight", (48, 192)),
            ("swinViT.layers2.0.downsample.norm.weight", (192,)),
            ("decoder5.transp_conv.conv.weight", (192, 96, 2, 2, 2)),
            ("decoder1.conv_block.conv3.conv.act_k", ()),
            ("encoder10.layer.conv2.conv.weight", (192, 192, 3, 3, 3)),
            ("out.conv.conv.bias", (3,))):
        assert tuple(np.shape(out[key])) == shape, key
    assert not any("norm1.weight" in k and "layer." in k for k in out)
    back = torch_io.load_torch_state_dict(
        g, nnir.init(g, 1, device="cpu"), out, strict=True)
    for name, entries in v["params"].items():
        for k, t in entries.items():
            assert torch.equal(torch.as_tensor(back["params"][name][k]),
                               torch.as_tensor(t)), (name, k)
    bad = dict(out)
    key = "swinViT.layers1.0.blocks.0.attn.relative_position_index"
    bad[key] = np.zeros_like(bad[key])
    with pytest.raises(ValueError, match="relative_position_index"):
        torch_io.load_torch_state_dict(g, v, bad)


MODEL = ["--model", "SwinUNETR", "--norm", "in", "--nla", "lrelu",
         "--width", "12", "--nMod", "4", "--nClass", "4"]
QUANT = ["--qconv", "effq", "--qlvl_w", "4", "--qlvl_a", "4", "--q_first",
         "256,-1", "--q_last", "256,-1"]


def test_model_flags_give_the_swinunetr_config():
    args = entrance.build_parser().parse_args(
        ["ptq", "--task", "brats", "--multi_label", "brats", *MODEL, *QUANT])
    cfg, info, n_mo = definer.get_model_config(args)
    assert isinstance(cfg, SwinUNETRConfig) and n_mo == 1
    assert (cfg.feature_size, cfg.depths, cfg.num_heads, cfg.window_size,
            cfg.num_classes) == (12, (2, 2, 2, 2), (3, 6, 12, 24), 7, 3)
    assert cfg.q_first == (256, -1) and info == "SwinUNETR_IN"
    assert models.min_input_divisor(cfg) == (32, 32, 32)
    with pytest.raises(ValueError, match="axes D"):
        models.validate_spatial_shape((48, 32, 32), cfg, "--patch_size")
    args.norm = "bn"
    with pytest.raises(NotImplementedError, match="--norm in"):
        definer.get_model_config(args)
    for argv, what in ((["train_fp"], "train_fp"),
                       (["ptq", "--qat_epochs", "1"], "--qat_epochs"),
                       (["infer", "--serve_stem", "s2d"], "--serve_stem"),
                       (["infer", "--export_artifact"], "--export_artifact")):
        with pytest.raises(NotImplementedError, match=what):
            entrance.main([*argv, "--task", "brats", *MODEL, *QUANT])


def test_ptq_then_int8_infer_on_synthetic_volumes(tmp_path):
    root = str(tmp_path)
    data_dir, split_dir = make_synthetic_dataset(
        root, task="brats", n_subjects=4, vol_shape=(32, 32, 32))
    args = entrance.build_parser().parse_args(
        ["ptq", "--task", "brats", "--multi_label", "brats", *MODEL,
         *QUANT])
    graph = build_model(definer.get_model_config(args)[0])
    v = nnir.init(graph, 0, device="cpu")
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
             "--lwq_iter", "2", "--act_offset", "1", "--act_offset_scope",
             "all"])
        export = P.join(snap, "state_in_int8.pkl")
        heads = K7.window_attention.window_heads
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
        assert len(f.read().splitlines()) == 69
    # the val and test volumes, whole: one 32^3 patch each, 8 attentions
    assert K7.window_attention.window_heads - heads == 2 * 2 * (
        27 * 3 + 8 * 6 + 12 + 24)
    sd = torch_io._read_export_state_dict(export)
    ks = [int(np.asarray(sd[k])) for k in sd if k.endswith(".act_k")]
    assert ks and all(k in (0, 1) for k in ks)


def _chunk_counters(sg, dv, x):
    before = [getattr(o, a) for o, a in _COUNTED]
    nnir.apply(sg, dv, x, mode="quantized", heads=slice(-1, None))
    return [getattr(o, a) - b for (o, a), b in zip(_COUNTED, before)]


_COUNTED = ((K6.group_norm, "elements"), (ops.layer_norm, "elements"),
            (K7.window_attention, "window_heads"))
_FLAGS = ("pallas", "int8", "act_k", "input_quantized", "epilogue_quant_for",
          "residual", "residual_relu", "epilogue_pool", "quant_for", "relu")


@pytest.mark.parametrize("net", ["lits", "brats", "segresnet"])
def test_shared_graphs_flags_and_counters_are_as_before(net):
    """The rewrites before SwinUNETR were ``group_norm_serving`` after
    ``upsample_serving``; on the UResQ presets and SegResNet the served
    graph is theirs node for node, no offset-grid conv reaches K1 or K3,
    K6 keeps its grouped pass, and a chunk normalizes what it did (no
    LayerNorm, no window attention)."""
    if net == "segresnet":
        cfg = SegResNetConfig(init_filters=8, quantize=True, qlvl_w=4,
                              qlvl_act=4, q_first=(256, -1),
                              q_last=(256, -1))
        graph = build_segresnet(cfg)
        shape = (1, 16, 16, 16, 4)
    else:
        graph = build_uresq(preset_config(net, quantize=True))
        shape = (1, 32, 32, 16, 1) if net == "lits" else (1, 16, 16, 16, 4)
    fg, fv = fold_bn(graph, nnir.init(graph, 0, device="cpu"))
    for n in fg.qconv_nodes():
        p = fv["params"][n.name]
        p["alpha_w"] = p["kernel"].abs().max()
        if net == "segresnet" and (n.attrs["stride"] != (1, 1, 1)
                                   or n.name.startswith("up_samples")):
            p["act_k"] = torch.tensor(1, dtype=torch.int32)
    dg, dv = to_int8_inference(fg, fv)
    served = serving_graph(dg)
    before = group_norm_serving(upsample_serving(dg))
    assert served.nodes == before.nodes and served.outputs == before.outputs
    assert not any(n.attrs.get("pallas") and n.attrs.get("act_k")
                   for n in served.nodes)
    flags = {n.name: {k: n.attrs.get(k) for k in _FLAGS}
             for n in served.nodes}
    assert flags == {n.name: {k: n.attrs.get(k) for k in _FLAGS}
                     for n in before.nodes}
    got = _chunk_counters(served, dv, torch.randn(shape))
    live = nnir.live_nodes(served, served.outputs[-1:])
    norms = [n for n in served.nodes if n.op == "group_norm_k6"
             and n.name in live]
    assert got[1:] == [0, 0]
    assert (got[0] > 0) == bool(norms) == (net == "segresnet")
    if net == "segresnet":
        for n in served.nodes:
            if n.op == "group_norm_k6":
                assert n.attrs["num_groups"] == 8
                assert not K6._plan((1, 16, 16, 16, n.attrs["ch"]),
                                    8)[2]


@pytest.mark.parametrize("yaml,model", [
    ("brats_swinunetr_ptq.yaml", SwinUNETRConfig),
    ("brats_segresnet_ptq.yaml", SegResNetConfig)])
def test_the_yaml_configs_give_their_models(yaml, model):
    """A YAML config's ``width`` is a number, which the model flags take as
    the flag's text."""
    path = P.join(P.dirname(P.dirname(P.abspath(__file__))), "config", yaml)
    args = entrance.merge_config(path, entrance.build_parser().parse_args(
        ["ptq", "--qlvl_w", "4", "--qlvl_a", "4", "--round", "1",
         "--config", path]))
    cfg = definer.get_model_config(args)[0]
    assert isinstance(cfg, model) and cfg.q_first == (256, -1)
