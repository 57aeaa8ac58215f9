"""Evaluation: the metrics (numpy), copied from the JAX package."""
