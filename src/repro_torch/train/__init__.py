from repro_torch.train.loss import cross_entropy, make_loss_fn  # noqa: F401
from repro_torch.train.train_state import TrainState  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    eval_loss,
    init_state,
    make_train_step,
    train_loop,
)
