"""Training and its support (port of ``lvae_tpu/train``): the train step
and test-ELBO sweep (``state``), the loop (``trainer``), data-dependent
init, checkpoints, logging and weight conversion."""
