from .train import TrainState, build_train_step, create_train_state, make_train_batch

__all__ = ["TrainState", "build_train_step", "create_train_state", "make_train_batch"]
