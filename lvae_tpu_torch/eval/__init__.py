"""Evaluation estimators (port of ``lvae_tpu/eval``)."""
