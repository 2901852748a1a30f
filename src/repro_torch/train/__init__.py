"""Adapter training: the train step and the host-driven trainer."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_full_ft_step,
    make_train_step,
    reinit_after_dmrg,
)
from repro_torch.train.trainer import Trainer  # noqa: F401
