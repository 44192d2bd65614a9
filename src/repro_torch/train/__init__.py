from repro_torch.train.train_state import TrainState  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    init_state,
    make_train_step,
    train_loop,
)
