from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, adam, sgd, chain_clip, Optimizer,
    apply_updates, global_norm, cosine_schedule, linear_warmup,
    periodic_update, incremental_update,
)
