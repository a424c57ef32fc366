from . import labels, synthetic  # noqa: F401
