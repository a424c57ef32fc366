"""Serving artifacts: the deployed patch forward as an exported program.

Counterpart of the JAX package's ``export.py``.  The artifact is the
computation itself: the final-head patch forward with every weight baked
in, exported with ``torch.export`` (non-strict) and serialized with
``torch.export.save``.  K1-K6 are in it as the registered operators of
``kernels/library.py`` (the upsamples and GroupNorms rewritten by
``ptq.deploy.serving_graph``), so a consumer calls it with no
model-building code (``load_serving_artifact`` registers the operators
first).

Artifact = one zip file:
    manifest.json   serving metadata (patch size, overlap, grid, classes,
                    batch mode, platform, deployment, stitch defaults);
                    the JAX package's fields, name for name
    module.pt2      the ``torch.export.save`` bytes

The format string is the port's own (``FORMAT``): the JAX package's
artifact holds a ``jax.export`` module, this one a PyTorch program, so each
package's loader refuses the other's zip.  ``platforms`` is the one device
type the program was exported on (``["cuda"]`` or ``["cpu"]``): its
weights live there and its K1-K5 run there.

Calling convention of the exported program:
    (B, pd, ph, pw, nMod) float32  ->  (1, B, pd, ph, pw, C_out) float32
final-head logits only.  B is symbolic (a ``torch.export.Dim``) when the
graph exports with one; otherwise it is pinned to the export-time
``patch_batch`` and ``ServingArtifact.patch_model_fn`` zero-pads ragged
final chunks and drops the padded rows.  The s2d artifact
(``export_s2d_model``) takes the (s2d patches, parities) pair and returns
the channels-first head, at a pinned batch.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import nnir, ops

FORMAT = "efficientq-serving-torch/1"
JAX_FORMAT = "efficientq-serving/1"  # the JAX package's (jax.export)
MODULE_NAME = "module.pt2"
MANIFEST_NAME = "manifest.json"


class _PatchModel(nn.Module):
    """The final-head patch forward with the weights as buffers, on the
    op-backed kernel record (``kernels/library.py::OPS``)."""

    def __init__(self, graph, variables, mode, compute_dtype, heads):
        super().__init__()
        self.net = nnir.GraphModule(graph, variables, mode)
        self.compute_dtype = compute_dtype
        self.heads = heads

    def forward(self, xb):
        from .kernels.library import OPS

        return nnir.apply(self.net.graph, self.net.variables, xb,
                          mode=self.net.mode, heads=self.heads,
                          compute_dtype=self.compute_dtype,
                          kernels=OPS)[-1:]


class _S2DPatchModel(_PatchModel):
    """The s2d graph's patch forward: (s2d patches, parities) in."""

    def forward(self, stack, parities):
        return super().forward((stack, parities))


def export_patch_model(graph, variables, patch_size, n_mod: int, *,
                       mode: str = "quantized", patch_batch: int = 4,
                       compute_dtype=None, device="cuda"):
    """Export the final-head patch forward with the weights baked in, on
    ``device``.  Returns ``(exported, batch)``: ``batch`` is the string
    ``"symbolic"`` or the pinned int batch size.  ``compute_dtype`` bakes a
    low-precision serving dtype (--serve_dtype bf16) into the program; the
    head comes out float32 either way."""
    from .ptq.deploy import serving_rewrites

    patch_size = tuple(ops.triple(patch_size))
    device = torch.device(device)
    served, variables, _, _ = serving_rewrites(graph, variables)
    model = _PatchModel(served, nnir.to_device(variables, device), mode,
                        compute_dtype, slice(-1, None))

    def example(b):
        return (torch.zeros((b, *patch_size, n_mod), device=device),)

    try:
        # an example batch of 2 or more: export specializes sizes 0 and 1
        b = torch.export.Dim("b")
        return torch.export.export(model, example(max(2, patch_batch)),
                                   dynamic_shapes=({0: b},),
                                   strict=False), "symbolic"
    except Exception as e:  # noqa: BLE001 - any export refusal pins
        # a symbolic batch may not export through every op: pin it, and say
        # why, so a transient failure does not silently pin every serve
        print(f"export: symbolic batch unavailable ({type(e).__name__}: "
              f"{e}); pinning batch={patch_batch}")
        return (torch.export.export(model, example(int(patch_batch)),
                                    strict=False), int(patch_batch))


def export_s2d_model(graph, variables, patch_size, n_mod: int, *,
                     patch_batch: int, compute_dtype=torch.bfloat16,
                     device="cuda"):
    """Export the s2d serving forward (``--serve_stem s2d``,
    ``ptq.deploy.make_s2d_volume_inferencer``): the stem as K2 on the
    space-to-depth patches, the interior int8 convs on K1 at
    ``compute_dtype``, the channels-first final head.  The program takes
    ``(stack, parities)``, (B, pd/2+1, ph/2, pw/2, 8 nMod) bfloat16 and (B,)
    int32, at a pinned B.  The s2d transform itself is package code on the
    serving side (``kernels/stem.py``), driven by the manifest
    (``serve_stem='s2d'`` and ``stem_geometry``).  Returns ``(exported,
    batch, stem_attrs)``, or None when the graph has no eligible stem (use
    ``--deploy int8|mixed`` first)."""
    from .ptq.deploy import serving_rewrites

    patch_size = tuple(ops.triple(patch_size))
    device = torch.device(device)
    g2, v2, _, stem = serving_rewrites(graph, variables, s2d=True,
                                       heads=slice(-1, None))
    if stem is None:
        return None
    model = _S2DPatchModel(g2, nnir.to_device(v2, device), "quantized",
                           compute_dtype, None)
    pd, ph, pw = patch_size
    b = int(patch_batch)
    stack = torch.zeros((b, pd // 2 + 1, ph // 2, pw // 2, 8 * n_mod),
                        dtype=torch.bfloat16, device=device)
    parities = torch.zeros((b,), dtype=torch.int32, device=device)
    exported = torch.export.export(model, (stack, parities), strict=False)
    stem_attrs = {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in stem.attrs.items()
                  if k in ("kernel_size", "stride", "padding", "dilation",
                           "groups")}
    return exported, b, stem_attrs


def _platform(exported) -> str:
    """The device type of an exported program's weights."""
    for t in (*exported.state_dict.values(), *exported.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device.type
    raise ValueError("the exported program holds no weights")


def save_serving_artifact(path: str, exported, manifest: dict) -> None:
    manifest = dict(manifest)
    manifest["format"] = FORMAT
    manifest["platforms"] = [_platform(exported)]
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(MANIFEST_NAME, json.dumps(manifest, indent=1))
        z.writestr(MODULE_NAME, buf.getvalue())


class ServingArtifact:
    """A loaded serving artifact: ``.manifest`` and the exported program."""

    def __init__(self, exported, manifest: dict):
        self.exported = exported
        self.manifest = manifest
        self._module = None
        self._captured = self._weights = None

    @property
    def batch(self):
        return self.manifest["batch"]  # "symbolic" | int

    @property
    def patch_size(self):
        return tuple(self.manifest["patch_size"])

    @property
    def platforms(self):
        return list(self.manifest["platforms"])

    def check_platform(self, device) -> None:
        """Raises unless the program was exported for ``device``'s type."""
        kind = torch.device(device).type
        if kind not in self.platforms:
            raise RuntimeError(f"artifact was exported for {self.platforms}, "
                               f"the current device is {kind!r}")

    def module(self):
        """The exported program as a module (made once)."""
        if self._module is None:
            self._module = self.exported.module()
        return self._module

    def patch_model_fn(self):
        """A ``model_fn`` for ``eval.sliding.sliding_window_inference``:
        (B, pd, ph, pw, nMod) -> (1, B, pd, ph, pw, C_out), or for an s2d
        artifact the (stack, parities) pair -> the channels-first head.  It
        runs the program as ``nnir.apply`` runs its graph, with float32
        convs and matmuls exact (TF32 off: the program does not carry that
        setting).  A pinned-batch program gets ragged chunks zero-padded
        (every input's leading axis) and the padded rows dropped."""
        module = self.module()

        def run(*xb):
            with ops.exact_f32():
                return module(*xb)

        if self.batch == "symbolic":
            return run
        b = int(self.batch)

        def fn(*xb):
            n = xb[0].shape[0]
            if n > b:
                raise ValueError(f"chunk of {n} patches > artifact batch {b}")
            if n < b:
                xb = tuple(F.pad(a, (0, 0) * (a.dim() - 1) + (0, b - n))
                           for a in xb)
            return run(*xb)[:, :n]

        return fn

    def _model_fn(self, device):
        """The patch forward of a chunk on ``device``: replayed from CUDA
        graphs on a card (one ``CapturedForward`` per artifact, on the
        program's weights), eager elsewhere."""
        from .eval.sliding import CapturedForward, chunk_fn

        if self._captured is None:
            run = self.patch_model_fn()
            self._captured = CapturedForward(lambda _v, *xs: run(*xs))
            self._weights = list(self.module().state_dict().values())
        return chunk_fn(self._captured.forward, self._captured, None,
                        self._weights, torch.device(device))

    def volume_inferencer(self, patch_batch: Optional[int] = None,
                          hard_pred: bool = True, multilabel: bool = False):
        """Whole-volume sliding-window inference from the artifact: the
        serving loop ``eval.sliding.serve_volume`` with the program as its
        chunk forward (the direct inferencer's hard-prediction rules; the
        program emits the final head only), as
        ``infer(variables, image, patch_size, overlap)`` with ``variables``
        ignored, so ``eval/validate.py`` drives it unchanged.  On a card the
        patch forward replays from CUDA graphs.

        Column artifacts (manifest ``serve_grid='column'``): the patch D is
        the export-pinned column depth; volumes pad up to it (deeper ones
        need a new export) and the caller's patch and overlap give way to
        the manifest's.  s2d artifacts (manifest ``serve_stem='s2d'``): the
        volume goes to the artifact's device as float32 and to s2d space
        there (``ptq.deploy.s2d_extract_fn``, driven by the manifest's
        stem geometry), and the program's head is channels-first; geometry
        the s2d grid cannot serve (odd H/W starts or extents) raises,
        naming the direct artifact exported beside it."""
        from .eval.sliding import serve_volume
        from .ptq.deploy import s2d_extract_fn

        if patch_batch is None or patch_batch == "auto" or patch_batch <= 0:
            patch_batch = self.batch if self.batch != "symbolic" else 4
        s2d = self.manifest.get("serve_stem") == "s2d"
        column = self.manifest.get("serve_grid") == "column"
        col_d = int(self.manifest.get("column_depth", 0))
        stem_attrs = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in self.manifest.get("stem_geometry",
                                                    {}).items()}

        def infer(variables, image, patch_size, overlap):
            del variables
            grid, extract = {}, None
            if s2d:
                image = torch.as_tensor(image).to(self.platforms[0],
                                                  torch.float32)
                extract = s2d_extract_fn(tuple(image.shape[1:4]),
                                         patch_size, overlap, stem_attrs)
                if extract is None:
                    raise ValueError(
                        f"volume {tuple(image.shape[1:4])} has odd H/W grid "
                        f"geometry the s2d artifact cannot serve: use the "
                        f"direct serving artifact exported alongside "
                        f"(serving_artifact.zip)")
            elif column:
                if image.shape[1] > col_d:
                    raise ValueError(
                        f"volume depth {image.shape[1]} exceeds the "
                        f"artifact's pinned column depth {col_d}: re-export "
                        f"with a larger --export_column_depth")
                # the pinned depth as the column plan's stride multiple
                patch_size = self.patch_size
                overlap = tuple(self.manifest["overlap"])
                grid = dict(serve_grid="column", stride_div=col_d)
            with torch.inference_mode():
                return serve_volume(self._model_fn(image.device), image,
                                    patch_size, overlap, int(patch_batch),
                                    hard_pred=hard_pred,
                                    multilabel=multilabel,
                                    channels_first=s2d, extract_fn=extract,
                                    **grid)

        return infer


def load_serving_artifact(path: str) -> ServingArtifact:
    """Read an artifact zip written by ``save_serving_artifact``.  The zip
    of the JAX package (format ``JAX_FORMAT``) is refused with a
    ``ValueError``, as is any other."""
    from .kernels import library  # noqa: F401 - registers effq::*

    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read(MANIFEST_NAME))
        fmt = manifest.get("format")
        if fmt != FORMAT:
            raise ValueError(
                f"not a serving artifact of this package (format={fmt!r}, "
                f"want {FORMAT!r}; {JAX_FORMAT!r} is the JAX package's "
                f"jax.export format)")
        exported = torch.export.load(io.BytesIO(z.read(MODULE_NAME)))
    return ServingArtifact(exported, manifest)
