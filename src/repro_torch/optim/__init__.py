"""AdamW with the paper's schedules and clipping."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    carry_state,
    clip_by_global_norm,
    global_norm,
    init_state,
    make_schedule,
    reinit_state,
    update,
)
