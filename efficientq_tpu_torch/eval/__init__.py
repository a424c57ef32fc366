from .metrics import SegMetricMC, dice  # noqa: F401
from .sliding import (make_volume_inferencer, patch_grid,  # noqa: F401
                      sliding_window_inference)
