"""Evaluation: the metrics (numpy), copied from the JAX package, and the
file-driven Evaluator (``eval/evaluator.py``)."""
