from .losses import get_loss, head_loss_weights, multi_output_loss  # noqa: F401
from .schedule import make_optimizer, poly_warmup_schedule  # noqa: F401
from .tester import PTQTester, Tester  # noqa: F401
from .trainer import Trainer  # noqa: F401
