"""Config, optimizer, train state, methods and the trainer of the port."""

from .config import TrainConfig
from .optim import poly_lr, reference_sgd
from .state import TrainState
from .trainer import Trainer

__all__ = ["TrainConfig", "TrainState", "Trainer", "poly_lr",
           "reference_sgd"]
