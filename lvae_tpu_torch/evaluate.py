"""Evaluate a saved run with the port (port of ``evaluate.py``): test ELBO,
then optionally the k-sample importance-weighted log-likelihood.

    python -m lvae_tpu_torch.evaluate --load <run dir> --state-dict <file.pt> \
        [--ll] [--iw-samples 100] [--device cuda]

``--load`` reads the run's ``config.json`` (an ``lvae_tpu`` run directory
works); ``--state-dict`` is the weights, e.g. what
``tools/export_torch_checkpoint.py`` writes. ``--device cuda`` (the
default) needs a CUDA device and never falls back to the CPU. Image grids
and the generation diagnostics of ``evaluate.py`` are not ported yet;
``lvae_tpu_torch.serving.generate`` takes their options.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from lvae_tpu_torch.train.trainer import FUSED_POLICIES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a saved Ladder VAE run "
                                            "with the PyTorch/CUDA port")
    p.add_argument("--load", required=True, help="run directory (holds config.json)")
    p.add_argument("--state-dict", required=True,
                   help="weights: a torch.save'd state_dict (e.g. from "
                        "tools/export_torch_checkpoint.py)")
    p.add_argument("--ll", action="store_true",
                   help="compute the importance-weighted log-likelihood")
    p.add_argument("--iw-samples", type=int, default=100)
    p.add_argument("--iw-chunk", type=int, default=1,
                   help="IW samples stacked into one forward (the estimate "
                        "does not depend on it)")
    p.add_argument("--iw-max-batches", type=int, default=None,
                   help="IW-LL over the first N test batches only "
                        "(default: the whole test set)")
    p.add_argument("--logsumexp", default=None, choices=["kernel", "streaming"],
                   help="IW reduction: the CUDA logsumexp kernel over the "
                        "[k, B] ELBO matrix, or the streaming accumulator "
                        "(default: kernel on CUDA, streaming elsewhere)")
    p.add_argument("--test-batch-size", type=int, default=None)
    p.add_argument("--num-data-shards", type=int, default=None,
                   help="only 1: the port evaluates on one device")
    p.add_argument("--fused", default=None, choices=FUSED_POLICIES,
                   help="override the run's kernel policy: 'auto' turns on, on "
                        "CUDA, the sample+KL kernel and, for the "
                        "discretized_logistic_mix head, the mixture log-prob "
                        "kernel; 'stochastic', 'mixture' and 'pallas' (both) "
                        "turn them on on any device; 'none' is plain PyTorch")
    p.add_argument("--data-dir", default=None, help="override the run's data dir")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the latent noise (binarisation is fixed)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); the port does not fall "
            "back to the CPU"
        )
    if args.num_data_shards is not None and args.num_data_shards != 1:
        raise SystemExit(
            f"--num-data-shards {args.num_data_shards}: the port evaluates on "
            f"one device (multi-GPU evaluation comes in a later PR)"
        )
    from lvae_tpu_torch.config import config_from_dict
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.eval.iwll import evaluate_iwll
    from lvae_tpu_torch.train.convert import load_state_dict_file
    from lvae_tpu_torch.train.state import evaluate_elbo
    from lvae_tpu_torch.train.trainer import default_logsumexp, make_model

    with open(os.path.join(args.load, "config.json")) as f:
        d = json.load(f)
    if args.test_batch_size:
        d["test_batch_size"] = args.test_batch_size
    if args.data_dir:
        d["data_dir"] = args.data_dir
    if args.fused is not None:
        d["fused"] = args.fused
    stored_ds = int(d.get("num_data_shards") or 1)
    stored_ss = int(d.get("spatial_shards") or 1)
    if stored_ds * stored_ss > 1:
        # evaluation is keyed per image, so the device count changes no
        # metric: evaluate a mesh-trained run on this one device
        print(
            f"note: run was trained on a {stored_ds}x{stored_ss} (data x "
            f"space) mesh, only 1 device here — evaluating on 1 (same "
            f"metrics)", flush=True,
        )
        d["num_data_shards"] = 1
        d["spatial_shards"] = 1
    cfg = config_from_dict(d)

    data = load_test_set(cfg.dataset, cfg.data_dir)
    model = make_model(cfg, data, device)
    model.load_state_dict(load_state_dict_file(args.state_dict), strict=True)
    print(f"restored {args.load} from {args.state_dict} on {device}", flush=True)

    test = torch.from_numpy(data.test).to(device)
    bs = min(cfg.test_batch_size, test.shape[0])
    metrics = evaluate_elbo(model, test, data.preprocess, bs, data.data_dims,
                            seed=args.seed)
    print(
        f"test elbo {metrics['elbo']:.2f}  recons {metrics['ll']:.2f}  "
        f"kl {metrics['kl']:.2f}  bpd {metrics['bpd']:.4f}", flush=True,
    )
    for i, v in enumerate(metrics["kl_layers"]):
        print(f"  kl/layer_{i}: {v:.2f}")
    print(f"  [{metrics['n_images']} images, {metrics['wall_s']:.2f}s, "
          f"{metrics['images_per_sec']:.1f} img/s]", flush=True)

    iw = None
    if args.ll:
        impl = args.logsumexp or default_logsumexp(device)
        iw = evaluate_iwll(
            model, test, data.preprocess, data.data_dims,
            n_samples=args.iw_samples, batch_size=bs, seed=args.seed,
            logsumexp_impl=impl, chunk=args.iw_chunk,
            max_batches=args.iw_max_batches,
        )
        print(
            f"IW log-likelihood ({iw['n_samples']} samples, "
            f"{iw['n_images']} images, chunk {args.iw_chunk}, {impl}): "
            f"{iw['iw_ll']:.2f} nats  bpd {iw['iw_bpd']:.4f}  "
            f"[exec {iw['wall_s']:.1f}s, {iw['images_per_sec']:.1f} img/s]",
            flush=True,
        )
    return {"elbo": metrics, "iw": iw}


if __name__ == "__main__":
    main()
