from .deploy import to_int8_inference  # noqa: F401
from .fold_bn import fold_bn  # noqa: F401
