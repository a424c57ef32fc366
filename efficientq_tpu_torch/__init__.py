"""EfficientQ on PyTorch and CUDA: the port of the JAX package (the
repository's TPU implementation) to an NVIDIA Hopper GPU.

This slice runs two serving paths.  The int8 path: build the UResQ graph,
fold BN, load quantized weights, rewrite the graph for int8 deployment with
fused epilogues, run whole-volume sliding-window inference with a hard
prediction, and score Dice.  The s2d path (``--serve_stem s2d``) serves the
same int8 graph at bfloat16 with the init conv as the fused
space-to-depth stem.  The interior 3^3 int8 convs run on the hand-written
CUDA kernel K1 (kernels/qconv3d.py, csrc/qconv3d_int8.cu), the s2d stem on
K2 (kernels/stem.py, csrc/stem_s2d.cu).  The PTQ calibration
(``ptq.run_ptq``: attention pyramid, Gram solver, ADMM) produces the
quantized weights those paths serve; it runs on cuBLAS and cuSOLVER.  The
CLI, ``python -m efficientq_tpu_torch {train_fp,ptq,infer} ...``
(``cli/``), runs FP training (``train/``), the paper's ``ptq`` mission
with its quantization-aware fine-tune (``ptq/qat.py``) and the ``infer``
mission on its export with the JAX package's flags, config files and
artifact files, over the data layer (``data/``) and the validation loop
(``eval/validate.py``), whose upload goes through pinned memory on a side
stream.

Modules keep the JAX package's paths and function names; layouts are the
JAX package's (NDHWC activations, DHWIO kernels, flat variable dicts).
Entry points put tensors on the card unless given ``device="cpu"``.

Quick start::

    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.models import build_uresq, preset_config
    from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer

    graph = build_uresq(preset_config("brats", quantize=True))
    fgraph, fvars = fold_bn(graph, nnir.init(graph, seed=0))
    ...  # load a PTQ export: models.torch_io.load_int8_checkpoint
    dgraph, dvars = to_int8_inference(fgraph, fvars)
    infer = make_s2d_volume_inferencer(dgraph, dvars, multilabel=True,
                                       heads=slice(-1, None))
    pred = infer(None, volume_ndhwc, (128, 128, 128), (16, 16, 16))
"""

__version__ = "0.1.0"
