from . import segresnet, uresq
from .segresnet import SegResNetConfig, build_segresnet  # noqa: F401
from .uresq import (UResQConfig, build_uresq, num_mo,  # noqa: F401
                    preset_config)
from . import torch_io  # noqa: F401


def _module(cfg):
    return segresnet if isinstance(cfg, SegResNetConfig) else uresq


def build_model(cfg):
    """The graph of a model configuration: UResQ's or SegResNet's."""
    if isinstance(cfg, SegResNetConfig):
        return build_segresnet(cfg)
    return build_uresq(cfg)


def min_input_divisor(cfg):
    """The per-axis divisor a spatial input shape of the configured model
    must satisfy (``uresq.min_input_divisor``,
    ``segresnet.min_input_divisor``)."""
    return _module(cfg).min_input_divisor(cfg)


def validate_spatial_shape(shape, cfg, what: str) -> None:
    """A clear ValueError when ``shape`` cannot flow through the configured
    model (see its module's ``validate_spatial_shape``)."""
    _module(cfg).validate_spatial_shape(shape, cfg, what)
