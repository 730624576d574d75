from .state import (TrainState, init_sharded_train_state, init_train_state, list_checkpoints, restore_checkpoint,
                    save_checkpoint)
from .train_dit import (
    apply_update_,
    build_from_config,
    dit_loss,
    evaluate_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "init_train_state",
    "init_sharded_train_state",
    "list_checkpoints",
    "restore_checkpoint",
    "save_checkpoint",
    "apply_update_",
    "build_from_config",
    "dit_loss",
    "evaluate_step",
    "make_optimizer",
    "make_train_step",
]
