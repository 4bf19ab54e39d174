"""Config, builders and the JAX parameter bridge."""
