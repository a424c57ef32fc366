from .admm import PTQHyperParams, calibrate_layer  # noqa: F401
from .deploy import to_int8_inference  # noqa: F401
from .engine import (PTQReport, apply_qlvl_overrides,  # noqa: F401
                     block_calibration_targets, run_ptq, run_ptq_mixed,
                     tail_sensitive_convs)
from .fold_bn import fold_bn  # noqa: F401
