from .uresq import (UResQConfig, build_uresq, min_input_divisor,  # noqa: F401
                    num_mo, preset_config, validate_spatial_shape)
from . import torch_io  # noqa: F401
