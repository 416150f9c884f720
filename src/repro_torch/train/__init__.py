from . import checkpoint  # noqa: F401
from .trainer import TrainConfig, Trainer  # noqa: F401
