"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it: ``stochastic`` (fused sample + KL,
elementwise and per sample, forward and backward) and ``logsumexp`` (the
IW-LL reduction); ``build`` compiles and binds them and counts their
launches."""
