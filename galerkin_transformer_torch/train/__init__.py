from .checkpoint import (AsyncCheckpointer, load_checkpoint, load_jax_checkpoint,
                         load_pickle, msgpack_restore, msgpack_serialize, save_checkpoint,
                         save_jax_checkpoint, save_pickle)
from .device_loop import DeviceEpochRunner, restore_weights, stack_dataset
from .losses import LossResult1d, LossResult2d, WeightedL2Loss, WeightedL2Loss2d
from .schedule import (AdamOneCycle, AdamPlateau, ClippedAdam, PlateauController,
                       adam_plateau, onecycle_momentum_schedule, onecycle_schedule)
from .steps import (make_burgers_steps, make_darcy_steps, make_ns_steps,
                    microbatched_value_and_grad)
from .trainer import TrainResult, run_train, validate_epoch

__all__ = ["AsyncCheckpointer", "load_checkpoint", "load_jax_checkpoint", "load_pickle",
           "msgpack_restore", "msgpack_serialize", "save_checkpoint", "save_jax_checkpoint",
           "save_pickle", "DeviceEpochRunner", "restore_weights", "stack_dataset",
           "LossResult1d", "LossResult2d", "WeightedL2Loss", "WeightedL2Loss2d",
           "AdamOneCycle", "AdamPlateau", "ClippedAdam", "PlateauController", "adam_plateau",
           "onecycle_momentum_schedule", "onecycle_schedule", "make_burgers_steps",
           "make_darcy_steps", "make_ns_steps", "microbatched_value_and_grad", "TrainResult",
           "run_train", "validate_epoch"]
