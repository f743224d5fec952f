from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    cosine_schedule,
    global_norm,
    init,
    make_train_step,
    update,
)
from repro_torch.optim import adamw, compress  # noqa: F401
