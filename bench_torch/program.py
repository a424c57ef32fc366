"""The system under test: the port's served network, built as the
``infer --deploy int8`` mission builds it from a PTQ export, its serving
pipeline, and the harness's spans around the port's calls in a traced
run.  The only module of the harness that imports the port."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from .model import _triple
from .trace import span

# the configuration's keys and the port's UResQConfig fields they fix
_ARCH = (("num_mod", "num_mod"), ("num_classes", "num_classes"),
         ("widths", "width_config"), ("depths", "depth_config"),
         ("init_stride", "init_stride"), ("init_kernel", "init_kernel"),
         ("blk", "blk_type"), ("ds", "ds"),
         ("ds_depth_limit", "ds_depth_limit"))


def _config(cfg: Dict):
    """The port's UResQConfig of the configuration's preset, checked
    against every architecture key the file states."""
    from efficientq_tpu_torch.models import preset_config

    ucfg = preset_config(cfg["preset"], quantize=True,
                         qlvl_w=cfg["qlvl_w"], qlvl_act=cfg["qlvl_act"],
                         q_first=tuple(cfg["q_first"]),
                         q_last=tuple(cfg["q_last"]))
    wrong = [k for k, f in _ARCH
             if (list(getattr(ucfg, f)) if isinstance(cfg[k], list)
                 else getattr(ucfg, f)) != cfg[k]]
    n_pools = len(cfg["widths"]) // 2
    if (wrong or ucfg.stride != 2 or ucfg.aniso_pool_depth < n_pools
            or set(ucfg.dilation_config) != {1} or not ucfg.inplace_nla):
        raise ValueError(f"the port's preset {cfg['preset']!r} differs from "
                         f"the configuration file in {wrong or 'pooling'}")
    return ucfg


def build(cfg: Dict, sd: Dict[str, torch.Tensor], device):
    """(deployed graph, its variables on ``device``): the preset's graph,
    BN folded, the export ``sd`` loaded (its keys must be exactly the
    folded graph's), then the int8 deployment rewrite."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.models import build_uresq, torch_io
    from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference

    graph = build_uresq(_config(cfg))
    fgraph, fvars = fold_bn(graph, nnir.init(graph, 0, device="cpu"))
    want = set(torch_io.to_torch_state_dict(fgraph, fvars))
    if set(sd) != want:
        raise ValueError(f"export keys differ from the port's graph: "
                         f"{sorted(set(sd) ^ want)[:8]}")
    fvars = torch_io.load_torch_state_dict(
        fgraph, fvars, {k: v.cpu().numpy() for k, v in sd.items()},
        strict=True)
    if cfg["deploy"] != "int8":
        raise ValueError(f"deploy {cfg['deploy']!r}: the harness serves "
                         f"the int8 deployment")
    dgraph, dvars = to_int8_inference(fgraph, fvars)
    return dgraph, nnir.to_device(dvars, device)


def k1_flags(dgraph) -> Dict[str, Dict]:
    """Each K1 node's epilogue flags, by name (what its call reads and
    writes)."""
    keys = ("input_quantized", "epilogue_quant_for", "residual",
            "epilogue_pool")
    return {n.name: {k: n.attrs.get(k) for k in keys}
            for n in dgraph.nodes
            if n.attrs.get("pallas") and n.attrs.get("int8")
            and n.attrs.get("kernel_size") == (3, 3, 3)}


def make_serve(dgraph, dvars, cfg: Dict, device, *, all_heads: bool):
    """``serve(x_ndhwc, token)`` as the validation loop's: the volume
    inferencer of the first volume (captured on a card), then one volume
    batch's hard prediction.  The patch batch is the port's untuned
    choice, min(grid, 8) (``--tune_serving off``): the autotuner's sweep
    times candidates once per checkout and keeps its pick, and close
    candidates would let two checkouts serve with different batches."""
    from efficientq_tpu_torch.eval.validate import _build_infer

    patch, overlap = _triple(cfg["patch"]), _triple(cfg["overlap"])
    state = {}

    def serve(x, _token):
        with span("serve_enqueue"):
            if "infer" not in state:
                state["infer"] = _build_infer(
                    dgraph, dvars, x, patch, overlap, mode="quantized",
                    patch_batch="auto",
                    multilabel=cfg.get("multi_label") is not None,
                    compute_dtype=None, serve_stem="direct",
                    heads=None if all_heads else slice(-1, None),
                    device=device, serve_grid="patch", stride_div=None,
                    tune_serving="off")
            return state["infer"](dvars, x, patch, overlap)

    serve.state = state
    return serve


def pipeline(loader, device, serve):
    """The port's 1-deep serving pipeline (``eval/validate.py``): pinned
    upload on a side stream, serve, readback on a second side stream;
    yields (host prediction, token) per loader batch, in order."""
    from efficientq_tpu_torch.eval.validate import _pipeline

    return _pipeline(loader, device, serve)


@contextlib.contextmanager
def instrumented(chunks: list):
    """Spans around the port's layer calls for a traced run: each chunk
    forward (its patch count appended to ``chunks``), each upload and each
    readback wait.  The calls themselves are unchanged."""
    from efficientq_tpu_torch.eval import sliding, validate

    call, feed, host = (sliding.CapturedForward.__call__,
                        validate.device_feed, validate._host)

    def chunk_call(self, *inputs):
        chunks.append(int(inputs[0].shape[0]))
        with span("chunk_forward"):
            return call(self, *inputs)

    def device_feed(loader, *a, **kw):
        it = feed(loader, *a, **kw)
        while True:
            with span("upload"):
                item = next(it, None)
            if item is None:
                return
            yield item

    def wait_host(readback):
        with span("readback_wait"):
            return host(readback)

    sliding.CapturedForward.__call__ = chunk_call
    validate.device_feed, validate._host = device_feed, wait_host
    try:
        yield
    finally:
        sliding.CapturedForward.__call__ = call
        validate.device_feed, validate._host = feed, host

