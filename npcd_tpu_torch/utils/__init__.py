"""Config, builders, the JAX parameter bridge, EMA, checkpoints, logging."""
