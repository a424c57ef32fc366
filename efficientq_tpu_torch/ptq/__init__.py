from .admm import PTQHyperParams, calibrate_layer  # noqa: F401
from .deploy import to_int8_inference  # noqa: F401
from .engine import PTQReport, apply_qlvl_overrides, run_ptq  # noqa: F401
from .fold_bn import fold_bn  # noqa: F401
