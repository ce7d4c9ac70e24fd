"""Test-set loading and eval preprocessing (a subset of ``lvae_tpu/data``:
the Bernoulli datasets of the flagship slice)."""
