"""Training runtime (port of ``repro.training``): the train / prefill /
decode steps (on one device or across a ``DeviceMesh``), the
fault-tolerant trainer and LSS-gated LocalSGD (``localsgd``, one replica
a rank)."""

from .localsgd import (LocalSGDConfig, LocalSGDGate, LocalSGDState,
                       make_localsgd, stack_params)
from .steps import (TrainHParams, build_decode_step, build_for_cell,
                    build_prefill_step, build_train_step, loss_and_grads)
from .trainer import Trainer, TrainerConfig, checkpoint_restorable_errors

__all__ = ["TrainHParams", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_for_cell", "loss_and_grads",
           "Trainer", "TrainerConfig", "checkpoint_restorable_errors",
           "LocalSGDConfig", "LocalSGDState", "LocalSGDGate", "make_localsgd",
           "stack_params"]
