from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, split_train_state, train_state)
