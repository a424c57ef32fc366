from . import segresnet, swin_unetr, uresq
from .segresnet import SegResNetConfig, build_segresnet  # noqa: F401
from .swin_unetr import SwinUNETRConfig, build_swin_unetr  # noqa: F401
from .uresq import (UResQConfig, build_uresq, num_mo,  # noqa: F401
                    preset_config)
from . import torch_io  # noqa: F401

_MODULES = ((SegResNetConfig, segresnet, build_segresnet),
            (SwinUNETRConfig, swin_unetr, build_swin_unetr))


def _module(cfg):
    return next((m for c, m, _ in _MODULES if isinstance(cfg, c)), uresq)


def build_model(cfg):
    """The graph of a model configuration: UResQ's, SegResNet's or
    SwinUNETR's."""
    return next((b for c, _, b in _MODULES if isinstance(cfg, c)),
                build_uresq)(cfg)


def min_input_divisor(cfg):
    """The per-axis divisor a spatial input shape of the configured model
    must satisfy (``uresq.min_input_divisor``,
    ``segresnet.min_input_divisor``, ``swin_unetr.min_input_divisor``)."""
    return _module(cfg).min_input_divisor(cfg)


def validate_spatial_shape(shape, cfg, what: str) -> None:
    """A clear ValueError when ``shape`` cannot flow through the configured
    model (see its module's ``validate_spatial_shape``)."""
    _module(cfg).validate_spatial_shape(shape, cfg, what)
