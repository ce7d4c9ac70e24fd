"""Train a Ladder VAE with the PyTorch/CUDA port (port of ``main.py``).

    python -m lvae_tpu_torch.main --zdims 32 32 32 --downsample 1 1 1 \\
        --nonlin elu --skip --blocks-per-layer 4 --gated --freebits 0.5 \\
        --learn-top-prior --data-dep-init --seed 42 --dataset static_mnist \\
        --device cuda

The flags are ``lvae_tpu``'s, plus ``--device cuda|cpu``. ``--device
cuda`` needs a visible card and never falls back to the CPU; ``--device
cpu`` runs the kernels' plain PyTorch versions. A checkpoint under
``<output dir>/<run>/checkpoints/`` is what ``python -m
lvae_tpu_torch.evaluate --load <run dir> --state-dict <checkpoint>``
scores.
"""

from __future__ import annotations

import torch


def main(argv=None):
    """Train; returns the :class:`~lvae_tpu_torch.train.trainer.Trainer`
    after its run (its ``logger.history`` holds every logged line)."""
    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.train.trainer import Experiment, Trainer

    cfg, device = config_from_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); the port does not fall "
            "back to the CPU"
        )
    trainer = Trainer(Experiment(cfg, torch.device(device)))
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
