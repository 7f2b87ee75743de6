"""Training runtime (port of ``repro.training``): the train / prefill /
decode steps and the fault-tolerant trainer.  LSS-gated LocalSGD
(``localsgd``) waits for ROADMAP A.10c."""

from .steps import (TrainHParams, build_decode_step, build_for_cell,
                    build_prefill_step, build_train_step, loss_and_grads)
from .trainer import Trainer, TrainerConfig, checkpoint_restorable_errors

__all__ = ["TrainHParams", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_for_cell", "loss_and_grads",
           "Trainer", "TrainerConfig", "checkpoint_restorable_errors"]
