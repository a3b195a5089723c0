from .checkpoint import (
    CheckpointManager,
    latest_checkpoint,
    latest_step,
    load_pretrained,
    overlay_compatible,
    restore_variables,
)
from .evaluator import check_expected_results, evaluate, run_evaluation
from .train import (
    TrainState,
    add_proposal_slots,
    build_train_step,
    create_train_state,
    make_train_batch,
    to_device,
    train,
)

__all__ = [
    "TrainState", "add_proposal_slots", "build_train_step", "create_train_state", "make_train_batch", "to_device",
    "train", "evaluate", "run_evaluation", "check_expected_results", "CheckpointManager",
    "load_pretrained", "restore_variables", "overlay_compatible", "latest_checkpoint",
    "latest_step",
]
