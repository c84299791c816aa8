from .optim import Optimizer, ema_update, make_optimizer, warmup_poly_schedule
from .state import TrainState, create_train_state
from .step import build_eval_step, build_train_step, loss_fn

__all__ = [
    "make_optimizer",
    "warmup_poly_schedule",
    "ema_update",
    "Optimizer",
    "TrainState",
    "create_train_state",
    "build_train_step",
    "build_eval_step",
    "loss_fn",
]
