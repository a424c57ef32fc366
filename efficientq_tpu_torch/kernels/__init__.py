"""Hand-written CUDA kernels (sources in ../csrc) and the graph passes that
route the deployed graph to them.  Counterpart of the JAX package's
``pallas/``."""
from .qmatmul import (fused_int8_matmul, fused_qact_matmul,  # noqa: F401
                      qconv1x1_ndhwc, to_pallas_inference)
