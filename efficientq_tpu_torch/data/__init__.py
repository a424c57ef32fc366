from . import labels, synthetic, transforms  # noqa: F401
from .datahub import DataHub  # noqa: F401
from .datasets import Loader, SegDataset, SegDatasetOnDisk  # noqa: F401
