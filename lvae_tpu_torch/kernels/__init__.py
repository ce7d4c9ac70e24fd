"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it: ``stochastic`` (fused sample + KL,
elementwise and per sample, forward and backward), ``logsumexp`` (the
IW-LL reduction), ``mixture`` (the discretized-logistic-mixture
log-prob and its backward) and ``segment`` (the train-mode dropout +
BatchNorm + activation segment and its backward); ``build`` compiles and
binds them and counts their launches."""
