"""Training substrate: optimizer, train step, checkpoint-as-fork (§17)."""

from .checkpoint import CheckpointManager, ExperimentCheckpoints
from .optimizer import AdamWConfig, adamw_init, adamw_update, opt_state_shardings
from .step import make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "opt_state_shardings", "make_train_step",
           "CheckpointManager", "ExperimentCheckpoints"]
