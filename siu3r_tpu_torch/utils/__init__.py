"""Label tables copied from the JAX package (framework-neutral)."""
