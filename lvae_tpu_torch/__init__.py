"""PyTorch/CUDA port of ``lvae_tpu`` for one NVIDIA H100.

This package runs the flagship Ladder VAE's evaluation and serving path
(test ELBO, k-sample IW log-likelihood, reconstruct / encode / generate)
through two hand-written CUDA kernels: the fused sample+KL kernel
(``kernels/stochastic.py``) and the IW logsumexp (``kernels/logsumexp.py``).
Training comes later.

It imports torch and numpy, never jax or ``lvae_tpu``; ``lvae_tpu`` stays
the reference it is tested against (``tests/test_torch_*.py``). Public
functions keep ``lvae_tpu``'s NHWC layout; modules run NCHW inside.
"""

import torch


def fp32_math() -> None:
    """Run convolutions and matmuls in full fp32: this port is fp32-only,
    and cuDNN's TF32 default would keep about three decimal digits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
