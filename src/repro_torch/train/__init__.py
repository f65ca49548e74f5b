"""Training substrate: optimizer, train step, checkpoint-as-fork (§17)."""

from .checkpoint import CheckpointManager, ExperimentCheckpoints
from .optimizer import (AdamWConfig, adamw_init, adamw_update, distribute_opt_state,
                        opt_state_shardings, zero1_adamw_init, zero1_adamw_update)
from .step import local_batch, make_train_step, make_zero1_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "opt_state_shardings", "distribute_opt_state", "zero1_adamw_init",
           "zero1_adamw_update",
           "make_train_step", "make_zero1_train_step", "local_batch",
           "CheckpointManager", "ExperimentCheckpoints"]
