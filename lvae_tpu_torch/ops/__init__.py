"""Plain PyTorch math: the oracles of the port's kernels (port of
``lvae_tpu/ops``)."""
