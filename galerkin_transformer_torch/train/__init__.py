from .checkpoint import load_checkpoint, save_checkpoint
from .losses import LossResult1d, LossResult2d, WeightedL2Loss, WeightedL2Loss2d
from .schedule import AdamOneCycle, onecycle_momentum_schedule, onecycle_schedule
from .steps import make_burgers_steps, make_darcy_steps, microbatched_value_and_grad
from .trainer import TrainResult, run_train, validate_epoch

__all__ = ["load_checkpoint", "save_checkpoint", "LossResult1d", "LossResult2d",
           "WeightedL2Loss", "WeightedL2Loss2d", "AdamOneCycle",
           "onecycle_momentum_schedule", "onecycle_schedule", "make_burgers_steps",
           "make_darcy_steps", "microbatched_value_and_grad", "TrainResult",
           "run_train", "validate_epoch"]
