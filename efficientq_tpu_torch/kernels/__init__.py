"""Hand-written CUDA kernels (sources in ../csrc) and the graph passes that
route the deployed graph to them.  Counterpart of the JAX package's
``pallas/``."""
