"""Evaluate a saved run with the port (port of ``evaluate.py``): test ELBO,
optionally the k-sample importance-weighted log-likelihood, then the
sample, reconstruction and spatial-KL grids and, when asked, a
generation-diagnostics grid.

    python -m lvae_tpu_torch.evaluate --load <run name or dir> [--step N] \\
        [--ll] [--iw-samples 100] [--nimages 64] \\
        [--mode-layers I ...] [--constant-layers I ...] [--temperature T ...] \\
        [--device cuda]

``--load`` is a run name under ``--output-dir`` (default ``./output``) or a
run directory; its ``config.json`` (the port's trainer's or ``lvae_tpu``'s)
builds the model. The weights are the run's latest checkpoint
(``checkpoints/ckpt_<step>.pt``), or the one ``--step`` names; a step with
no checkpoint raises, listing the steps that have one. ``--state-dict``
takes the weights from a file instead (e.g. what
``tools/export_torch_checkpoint.py`` writes from an ``lvae_tpu`` run), and
cannot be combined with ``--step``. ``--device cuda`` (the default) needs
a CUDA device and never falls back to the CPU. A run is scored in the
precision it was trained in (``config.json``'s ``"precision"``), or in the
one ``--precision`` gives, as ``lvae_tpu``'s ``evaluate.py`` does.

After the metrics, ``<run>/imgs`` gets ``sample_<step>.png`` (``--nimages``
prior samples), ``recon_<step>.png`` and ``kl_spatial_<step>.png``
(``Experiment.dump_images``); with any of ``--mode-layers`` (the mean at
those layers), ``--constant-layers`` (one draw for the whole batch there)
and ``--temperature`` (one value, or one per layer), also
``diag_<tag>_<step>.png``, named as ``lvae_tpu`` names it.

``--num-data-shards R`` scores over R ranks, as ``lvae_tpu``'s
``evaluate.py`` accepts it: each rank takes its rows of every test batch
(the last padded with its final index and masked) and the sums are
all-reduced, so the metrics are the one-rank ones up to the order of the
sums; rank 0 prints and writes the grids. Without ``torchrun`` the command
starts its R ranks itself, as ``lvae_tpu_torch.main`` does. A run trained
over several ranks is scored on one where the flag is not given (the
metrics do not depend on it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import torch

from lvae_tpu_torch.train.trainer import FUSED_POLICIES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a saved Ladder VAE run "
                                            "with the PyTorch/CUDA port")
    p.add_argument("--load", required=True, help="run name (or full run dir)")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--state-dict", default=None,
                   help="weights from this file instead of the run's checkpoint: a "
                        "torch.save'd state_dict (e.g. from "
                        "tools/export_torch_checkpoint.py) or a trainer checkpoint")
    p.add_argument("--ll", action="store_true",
                   help="compute the importance-weighted log-likelihood")
    p.add_argument("--iw-samples", type=int, default=100)
    # PROVISIONAL default: on one H100 chunk 10 ran 1.04-2.1x chunk 1's
    # images/s over one IW batch at k = 100 (most in bf16, whose chunk-1
    # forwards leave the card idle half the time; tools/torch_policy_ab.py,
    # PERF.md); the default waits for the benchmark's own cells
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
                   help="score over this many ranks (default: one)")
    p.add_argument("--fused", default=None, choices=FUSED_POLICIES,
                   help="override the run's kernel policy: 'auto' turns on, on "
                        "CUDA, the sample+KL kernel and, for the "
                        "discretized_logistic_mix head, the mixture log-prob "
                        "kernel; 'stochastic', 'mixture' and 'pallas' (both) "
                        "turn them on on any device; 'none' is plain PyTorch")
    p.add_argument("--precision", default=None, choices=["fp32", "bf16"],
                   help="override the run's conv compute dtype (checkpoints "
                        "have the same layout whatever the precision)")
    p.add_argument("--nimages", type=int, default=64, help="prior samples in the grids")
    p.add_argument("--data-dir", default=None, help="override the run's data dir")
    # generation diagnostics (lvae_tpu's evaluate.py:56-70)
    p.add_argument("--mode-layers", type=int, nargs="*", default=None, metavar="I",
                   help="sample the distribution MODE (z = mu) at these layer "
                        "indices when generating")
    p.add_argument("--constant-layers", type=int, nargs="*", default=None, metavar="I",
                   help="share one latent draw across the whole batch at these "
                        "layer indices when generating")
    p.add_argument("--temperature", type=float, nargs="+", default=None, metavar="T",
                   help="scale the prior sampling std when generating (T<1 "
                        "sharper, T=0 the mode); one value for all layers or "
                        "one per stochastic layer (bottom first)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the latent noise (binarisation is fixed)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def diagnostics_path(run_dir: str, step: int, mode_layers: Optional[Sequence[int]],
                     constant_layers: Optional[Sequence[int]],
                     temperature: Optional[Sequence[float]]) -> str:
    """``<run>/imgs/diag_<tag>_<step>.png``, the tag as ``lvae_tpu``'s
    (``evaluate.py:223-232``): ``mode`` and ``const`` with their layers,
    ``T`` with the temperatures, each part present where its flag has
    values (``T`` where the flag was given), joined by ``_``."""
    tag = []
    if mode_layers:
        tag.append("mode" + "-".join(map(str, mode_layers)))
    if constant_layers:
        tag.append("const" + "-".join(map(str, constant_layers)))
    if temperature is not None:
        tag.append("T" + "-".join(f"{t:g}" for t in temperature))
    return os.path.join(run_dir, "imgs", f"diag_{'_'.join(tag)}_{step}.png")


def _weights(args, run_dir: str):
    """``(state_dict, step)`` from ``--state-dict`` or the run's checkpoint."""
    from lvae_tpu_torch.train.checkpoint import CheckpointManager
    from lvae_tpu_torch.train.convert import load_state_dict_file

    if args.state_dict is None:
        ckpt = CheckpointManager(run_dir).load(args.step)
        return ckpt["model"], int(ckpt["step"]), f"its checkpoint of step {int(ckpt['step'])}"
    if args.step is not None:
        raise SystemExit("--step picks one of the run's checkpoints; it cannot be "
                         "combined with --state-dict, which names the weights itself")
    d = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    step = int(d["step"]) if isinstance(d.get("model"), dict) else 0
    return load_state_dict_file(args.state_dict), step, args.state_dict


def main(argv=None) -> Optional[dict]:
    """Score the run; returns the metrics and the grids' paths (on every
    rank), or, where this call started the ranks of ``--num-data-shards R
    > 1``, None once every rank has ended (a failing rank raises
    SystemExit)."""
    from lvae_tpu_torch.parallel import multihost

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is visible "
            "(torch.cuda.is_available() is False); the port does not fall "
            "back to the CPU"
        )
    shards = 1 if args.num_data_shards is None else args.num_data_shards
    if shards < 1:
        raise SystemExit(f"--num-data-shards must be >= 1, got {shards}")
    if args.iw_chunk < 1:
        raise SystemExit(f"--iw-chunk must be >= 1, got {args.iw_chunk}")
    return multihost.run_ranks("lvae_tpu_torch.evaluate", argv, shards, args.device,
                               lambda layout: _evaluate(args, device, layout))


def _evaluate(args, device: torch.device, layout) -> dict:
    from lvae_tpu_torch.config import config_from_dict
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.eval.iwll import evaluate_iwll
    from lvae_tpu_torch.eval.viz import save_image_grid
    from lvae_tpu_torch.train.state import evaluate_elbo
    from lvae_tpu_torch.train.trainer import default_logsumexp, dump_images, make_model

    run_dir = args.load if os.path.isdir(args.load) else os.path.join(args.output_dir,
                                                                      args.load)
    with open(os.path.join(run_dir, "config.json")) as f:
        d = json.load(f)
    if args.test_batch_size:
        d["test_batch_size"] = args.test_batch_size
    if args.data_dir:
        d["data_dir"] = args.data_dir
    if args.fused is not None:
        d["fused"] = args.fused
    if args.precision is not None:
        d["precision"] = args.precision
    say = print if layout.primary else (lambda *a, **k: None)
    stored_ds = int(d.get("num_data_shards") or 1)
    stored_ss = int(d.get("spatial_shards") or 1)
    if stored_ds * stored_ss > 1 and args.num_data_shards is None:
        # evaluation is keyed per image, so the device count changes no
        # metric: evaluate a mesh-trained run on this one device
        say(
            f"note: run was trained on a {stored_ds}x{stored_ss} (data x "
            f"space) mesh, only 1 device here — evaluating on 1 (same "
            f"metrics)", flush=True,
        )
    d["spatial_shards"] = 1
    cfg = config_from_dict(d)

    weights, step, source = _weights(args, run_dir)
    data = load_test_set(cfg.dataset, cfg.data_dir)
    model = make_model(cfg, data, device)
    model.load_state_dict(weights, strict=True)
    ranks = f" x {layout.size} ranks ({layout.backend})" if layout.sharded else ""
    say(f"restored {run_dir} from {source} on {device}{ranks} ({cfg.precision})",
        flush=True)

    test = torch.from_numpy(data.test).to(device)
    bs = min(cfg.test_batch_size, test.shape[0])
    metrics = evaluate_elbo(model, test, data.preprocess, bs, data.data_dims,
                            seed=args.seed)
    say(
        f"test elbo {metrics['elbo']:.2f}  recons {metrics['ll']:.2f}  "
        f"kl {metrics['kl']:.2f}  bpd {metrics['bpd']:.4f}", flush=True,
    )
    for i, v in enumerate(metrics["kl_layers"]):
        say(f"  kl/layer_{i}: {v:.2f}")
    say(f"  [{metrics['n_images']} images, {metrics['wall_s']:.2f}s, "
        f"{metrics['images_per_sec']:.1f} img/s]", flush=True)

    iw = None
    if args.ll:
        impl = args.logsumexp or default_logsumexp(device)
        try:
            iw = evaluate_iwll(
                model, test, data.preprocess, data.data_dims,
                n_samples=args.iw_samples, batch_size=bs, seed=args.seed,
                logsumexp_impl=impl, chunk=args.iw_chunk,
                max_batches=args.iw_max_batches,
            )
        except torch.cuda.OutOfMemoryError as e:
            if args.iw_chunk == 1:
                raise
            # name the flags instead of the allocator's trace
            # (lvae_tpu/evaluate.py:169-185)
            raise SystemExit(
                f"IW eval ran out of device memory at --iw-chunk {args.iw_chunk}: the "
                f"forward holds chunk x batch activations. Lower --iw-chunk or "
                f"--test-batch-size.\n\n{e}") from None
        say(
            f"IW log-likelihood ({iw['n_samples']} samples, "
            f"{iw['n_images']} images, chunk {args.iw_chunk}, {impl}): "
            f"{iw['iw_ll']:.2f} nats  bpd {iw['iw_bpd']:.4f}  "
            f"[exec {iw['wall_s']:.1f}s, {iw['images_per_sec']:.1f} img/s]",
            flush=True,
        )

    images = [os.path.join(run_dir, "imgs", f"{kind}_{step}.png")
              for kind in ("sample", "recon", "kl_spatial")]
    if layout.primary:
        dump_images(model, test, data.preprocess, run_dir, step, n_samples=args.nimages)
        print(f"wrote sample/recon grids to {os.path.join(run_dir, 'imgs')}")

    if layout.primary and (args.mode_layers is not None or args.constant_layers is not None
                           or args.temperature is not None):
        temps = args.temperature
        temperature = 1.0 if temps is None else temps[0] if len(temps) == 1 else tuple(temps)
        with torch.no_grad():
            samples = model.sample_prior(
                args.nimages, seed=step, mode_layers=tuple(args.mode_layers or ()),
                constant_layers=tuple(args.constant_layers or ()),
                temperature=temperature)["out_mean"]
        path = diagnostics_path(run_dir, step, args.mode_layers, args.constant_layers, temps)
        save_image_grid(samples.float().cpu().numpy(), path)
        images.append(path)
        print(f"wrote generation-diagnostics grid to {path}")
    return {"elbo": metrics, "iw": iw, "step": step, "images": images}


if __name__ == "__main__":
    main()
