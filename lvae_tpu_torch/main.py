"""Train a Ladder VAE with the PyTorch/CUDA port (port of ``main.py``).

    python -m lvae_tpu_torch.main --zdims 32 32 32 --downsample 1 1 1 \\
        --nonlin elu --skip --blocks-per-layer 4 --gated --freebits 0.5 \\
        --learn-top-prior --data-dep-init --seed 42 --dataset static_mnist \\
        --device cuda

The flags are ``lvae_tpu``'s, plus ``--device cuda|cpu``. ``--device
cuda`` needs a visible card and never falls back to the CPU; ``--device
cpu`` runs the kernels' plain PyTorch versions. ``--grad-accum k``,
``--remat``, ``--defer-metrics``, ``--debug-nans`` and ``--profile A-B``
run as in ``lvae_tpu``. The run's checkpoints under ``<output
dir>/<run>/checkpoints/`` are what ``python -m lvae_tpu_torch.evaluate
--load <run>`` scores (the latest, or ``--step N``); the test hook writes
the sample, reconstruction and spatial-KL grids under ``<run>/imgs``.

``--num-data-shards R`` trains over R ranks, each on its rows of the
global batch (``lvae_tpu_torch/parallel/``). Without ``torchrun`` the
command starts its R ranks itself (NCCL, one a card, where R cards are
visible; else gloo: the CPU, or ranks sharing a card), passes SIGTERM on
to them and exits with the first failing rank's code; under ``torchrun
--nproc-per-node R`` each rank joins the group, whose size must be R.
``--spatial-shards S`` adds the space axis: ``R x S`` ranks, each data
shard's S ranks holding a band of rows of every activation of its rows
(``lvae_tpu``'s ``(data, space)`` mesh); the pre-pad image height must
divide by S.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None):
    """Train; returns the :class:`~lvae_tpu_torch.train.trainer.Trainer`
    after its run (its ``logger.history`` holds every logged line), or,
    where this call started the ranks of ``--num-data-shards R`` x
    ``--spatial-shards S`` > 1, None once every rank has ended (a failing
    rank raises SystemExit)."""
    from lvae_tpu_torch.config import config_from_args
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.parallel import multihost
    from lvae_tpu_torch.train.trainer import Experiment, Trainer, check_height

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, device = config_from_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); the port does not fall "
            "back to the CPU"
        )

    if cfg.spatial_shards > 1 and not multihost.launched():
        # before any rank starts: each would raise the same
        check_height(load_test_set(cfg.dataset, cfg.data_dir).img_size, cfg.spatial_shards)

    def train(layout):
        trainer = Trainer(Experiment(cfg, torch.device(device)))
        trainer.run()
        return trainer

    return multihost.run_ranks("lvae_tpu_torch.main", argv, cfg.num_data_shards, device,
                               train, spatial=cfg.spatial_shards)


if __name__ == "__main__":
    main()
