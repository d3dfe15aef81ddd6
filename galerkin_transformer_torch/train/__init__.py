from .checkpoint import load_checkpoint, save_checkpoint
from .losses import LossResult1d, WeightedL2Loss
from .schedule import AdamOneCycle, onecycle_momentum_schedule, onecycle_schedule
from .steps import make_burgers_steps, microbatched_value_and_grad
from .trainer import TrainResult, run_train, validate_epoch

__all__ = ["load_checkpoint", "save_checkpoint", "LossResult1d", "WeightedL2Loss",
           "AdamOneCycle", "onecycle_momentum_schedule", "onecycle_schedule",
           "make_burgers_steps", "microbatched_value_and_grad", "TrainResult",
           "run_train", "validate_epoch"]
