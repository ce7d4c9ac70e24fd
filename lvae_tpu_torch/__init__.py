"""PyTorch/CUDA port of ``lvae_tpu`` for one NVIDIA H100.

This package trains the flagship Ladder VAE and the RGB models
(``python -m lvae_tpu_torch.main``) and runs their evaluation and serving
path (test ELBO, k-sample IW log-likelihood, reconstruct / encode /
generate) through hand-written CUDA kernels: the fused sample+KL kernels,
forward per element (K2) and per sample (K1) with their backward
(``kernels/stochastic.py``), the IW logsumexp (``kernels/logsumexp.py``),
the mixture head's log-prob and its backward (``kernels/mixture.py``) and
the train-mode dropout+BatchNorm+activation segment and its backward
(``kernels/segment.py``). ``--precision bf16`` runs the convolutions in
bf16 from fp32 parameters, as ``lvae_tpu``'s does, with bf16
instantiations of the segment, dropout and mixture kernels.
``python -m lvae_tpu_torch.bench`` measures train images/s and MFU on the
card, and ``profile_step``, ``perf_probe`` and ``iwll_probe`` take the
step and the evaluation apart (``profiling`` holds their helpers).
``--num-data-shards R`` trains and evaluates over R ranks, one process
each (``parallel/``), with the segment split around the all-reduce of its
statistics at R > 1.

It imports torch and numpy, never jax or ``lvae_tpu``; ``lvae_tpu`` stays
the reference it is tested against (``tests/test_torch_*.py``). Public
functions keep ``lvae_tpu``'s NHWC layout; modules run NCHW inside.
"""

import torch


def fp32_math() -> None:
    """Run fp32 convolutions and matmuls in full fp32: cuDNN's TF32 default
    would keep about three decimal digits, and ``lvae_tpu`` has no TF32
    switch (its reduced precision is ``--precision bf16``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
