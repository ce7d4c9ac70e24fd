"""Decompose the IW-LL evaluation's time on the card (the twin of
``tools/iwll_probe.py``).

    python -m lvae_tpu_torch.iwll_probe [--batch-size 1024] [--iters 8] [--k 8]

At fp32 and bf16, on the flagship (the bench's ``mnist`` preset, seeded
weights, no init from data), each leg timed with :func:`~lvae_tpu_torch.
profiling.timed` and profiled once (:func:`~lvae_tpu_torch.profiling.
device_union`):

- ``batched_fwd``: the model's eval forward over the batch;
- ``per_image_fwd``: the evaluation's inner op,
  ``train/state.py:per_image_forward``. In ``lvae_tpu`` it is a vmapped
  batch-1 forward; the port runs the batch as one batch with each row's
  noise keyed by its index, so both legs are one forward and the gap
  between them is noise;
- ``iwll_c1``, ``iwll_c4``: ``eval/iwll.py:iwll_batch`` at ``--k``
  samples in chunks of 1 and 4 (with the port's default reduction: the
  logsumexp kernel on the card), whose per-image results agree, as the
  sweep's chunk invariance says.

Each prints ms per call, ms per forward, forward images/s, and on the
card the device's busy time (the union of its kernels) with the idle
share of the call. :func:`iw_sweep` profiles one batch of the real sweep
(``evaluate_iwll``) on one of :func:`iw_cells`, the flagship at B = 1,000
and celeba64 at B = 500 with seeded weights (:func:`seeded_model`), for
the smoke run and the A/B (``tools/torch_policy_ab.py``).

``--device cpu`` runs the legs on the CPU for the tests (no profile).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

PRECISIONS = ("fp32", "bf16")
# the run configs of the IW sweep's two cells; test_batch_size is the
# sweep's batch. chip_smoke.py trains and evaluates the same two models.
FLAGSHIP = {
    "dataset": "static_mnist", "zdims": [32, 32, 32], "downsample": [1, 1, 1],
    "blocks_per_layer": 4, "n_filters": 64, "gated": True, "skip": True,
    "learn_top_prior": True, "nonlin": "elu", "dropout": 0.2,
    "test_batch_size": 1000, "fused": "auto", "freebits": 0.5, "batch_size": 64,
}
CELEBA = {
    "dataset": "celeba", "zdims": [32] * 4, "downsample": [1] * 4,
    "blocks_per_layer": 2, "n_filters": 64, "gated": True, "skip": True,
    "learn_top_prior": True, "nonlin": "elu", "dropout": 0.2, "freebits": 0.5,
    "test_batch_size": 500, "fused": "auto", "batch_size": 128,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the IW-LL evaluation's time on the card, by leg")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--n-filters", type=int, default=64)
    p.add_argument("--blocks-per-layer", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda needs a visible card; cpu is for the tests")
    return p


def seeded_model(config, meta, device, seed=2024):
    """The model of ``config`` (a run's config dict) over the dataset
    metadata ``meta`` with seeded random weights: lecun-scale convs, the
    Gaussian and likelihood heads at their normal(1e-2) init, small random
    biases and top prior (so every layer's KL is well above 0), BatchNorm
    running stats away from 0/1."""
    from lvae_tpu_torch.config import config_from_dict
    from lvae_tpu_torch.train.trainer import make_model

    g = torch.Generator().manual_seed(seed)
    model = make_model(config_from_dict(config), meta, device, generator=g)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith("bias") or name.endswith("top_prior"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return model


def rgb_blobs(n, seed, img=64, device="cuda"):
    """``n`` synthetic RGB images, uint8 ``[n, img, img, 3]``: a Gaussian
    blob per channel at a random centre and radius (the shape of
    ``lvae_tpu``'s RGB fixture), drawn on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    ax = torch.arange(img, device=dev, dtype=torch.float32)
    yy, xx = ax.view(1, img, 1, 1), ax.view(1, 1, img, 1)

    def draw(lo, hi):
        return torch.rand(n, 1, 1, 3, generator=g, device=dev) * (hi - lo) * img + lo * img

    cx, cy, r = draw(0.25, 0.75), draw(0.25, 0.75), draw(0.1, 0.3)
    blob = torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2))
    return (blob * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()


def celeba_dataset(train_u8, test_u8):
    """The splits as the registry's celeba (64x64 RGB, dequantized, the
    mixture head)."""
    from lvae_tpu_torch.data.registry import Dataset

    return Dataset("celeba", test_u8, (64, 64), (64, 64), 3, "dequantize",
                   "discretized_logistic_mix", train=train_u8)


def iw_cells(celeba_test=None) -> dict:
    """{name: (config, metadata, test uint8, preprocess, data dims, batch)}
    of the IW sweep's cells: the flagship on a batch of
    ``make_synthetic(seed=5)``'s test split, celeba64 on ``celeba_test``
    (default: :func:`rgb_blobs` with seed 12, drawn on the card)."""
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.data.sources import make_synthetic

    b, cb = FLAGSHIP["test_batch_size"], CELEBA["test_batch_size"]
    _, f_test = make_synthetic(n_train=0, n_test=b, seed=5)
    c_test = rgb_blobs(cb, seed=12) if celeba_test is None else celeba_test[:cb]
    return {"flagship": (FLAGSHIP, load_test_set("synthetic"), f_test, "none", 784, b),
            "celeba64": (CELEBA, celeba_dataset(None, c_test), c_test, "dequantize",
                         64 * 64 * 3, cb)}


def iw_sweep(model, test_u8: torch.Tensor, preprocess: str, data_dims: int, batch: int,
             k: int = 100, chunk: int = 1, logsumexp: str = "kernel") -> dict:
    """One batch of the IW-LL sweep on the card (``evaluate_iwll``,
    ``max_batches=1``) under the profiler, with no warm call outside it:
    wall ms, device busy ms (the union of the kernels), the idle share,
    images/s and the IW-LL."""
    from lvae_tpu_torch.eval.iwll import evaluate_iwll
    from lvae_tpu_torch.profiling import device_union

    res = {}

    def run():
        res.update(evaluate_iwll(model, test_u8, preprocess, data_dims, k, batch,
                                 logsumexp_impl=logsumexp, chunk=chunk, max_batches=1))

    busy, kernel_sum, wall, n_events = device_union(run, warm=False)
    return {"batch": batch, "k": k, "chunk": chunk, "logsumexp": logsumexp, "wall_ms": wall,
            "device_busy_ms": busy, "kernel_sum_ms": kernel_sum, "idle_share": 1.0 - busy / wall,
            "kernel_events": n_events, "images_per_sec": res["n_images"] / (wall / 1e3),
            "iw_ll": res["iw_ll"]}


def main(argv=None) -> dict:
    """Run every leg at both precisions; print a line each and return
    ``{precision: {leg: row}}`` (each ``iwll_*`` row with its per-image
    IW-LL under ``values``)."""
    from lvae_tpu_torch import bench
    from lvae_tpu_torch.config import EvalConfig
    from lvae_tpu_torch.data.device import eval_preprocess_batch
    from lvae_tpu_torch.eval.iwll import iwll_batch
    from lvae_tpu_torch.models.stochastic import Noise
    from lvae_tpu_torch.profiling import device_union, timed
    from lvae_tpu_torch.train.state import per_image_forward
    from lvae_tpu_torch.train.trainer import default_logsumexp, make_model

    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; the probe never falls "
                         "back to the CPU")
    device, b, k = torch.device(args.device), args.batch_size, args.k
    on_card = device.type == "cuda"
    b_args = bench.parse_args([
        "--preset", "mnist", "--n-filters", str(args.n_filters),
        "--blocks-per-layer", str(args.blocks_per_layer)])
    cfg, data = bench.bench_config(b_args)
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    lse = default_logsumexp(device)
    print(f"device: {name}  batch {b}  k {k}  logsumexp {lse}", flush=True)
    batch_u8 = torch.from_numpy((np.random.default_rng(1).uniform(size=(b, 28, 28, 1)) < 0.5)
                                .astype(np.uint8)).to(device)
    index = torch.arange(b, device=device)
    x = eval_preprocess_batch(batch_u8, data.preprocess, index)
    out = {}
    for precision in PRECISIONS:
        eval_cfg = EvalConfig(**{f: getattr(cfg, f) for f in (
            "zdims", "downsample", "blocks_per_layer", "n_filters", "skip", "gated",
            "learn_top_prior", "fused")}, precision=precision)
        model = make_model(eval_cfg, data, device,
                           generator=torch.Generator().manual_seed(cfg.seed))

        @torch.no_grad()
        def batched_fwd():
            o = model(x, noise=Noise(0, index, 0))
            return o["ll"] - o["kl_sep"].sum(dim=0)

        @torch.no_grad()
        def per_image_fwd():
            ll, kl_sep = per_image_forward(model, x, index, 0)
            return ll - kl_sep.sum(dim=0)

        def iwll(chunk):
            return lambda: iwll_batch(model, x, index, 0, k, lse, chunk)

        rows = {}
        for leg, fn, per in (("batched_fwd", batched_fwd, 1),
                             ("per_image_fwd", per_image_fwd, 1),
                             ("iwll_c1", iwll(1), k), ("iwll_c4", iwll(4), k)):
            sec = timed(fn, args.iters)
            row = {"ms_per_call": sec * 1e3, "ms_per_fwd": sec * 1e3 / per,
                   "fwd_images_per_sec": b * per / sec}
            line = (f"[{precision}] {leg:>14}: {row['ms_per_call']:8.2f} ms/call  "
                    f"{row['ms_per_fwd']:8.2f} ms/fwd  {row['fwd_images_per_sec']:9.0f} "
                    "fwd-img/s")
            if on_card:
                busy, _, wall, _ = device_union(fn)
                row.update(device_busy_ms=busy, wall_ms=wall, idle_share=1.0 - busy / wall)
                line += f"  device busy {busy:8.2f} ms of {wall:8.2f}, idle {1 - busy / wall:.3f}"
            if leg.startswith("iwll"):
                row["values"] = fn().float().cpu()
            print(line, flush=True)
            rows[leg] = row
        c1, c4 = rows["iwll_c1"]["values"], rows["iwll_c4"]["values"]
        rows["chunk_rel_diff"] = float(((c1 - c4).abs() / c1.abs()).max())
        print(f"[{precision}] iwll_c1 vs iwll_c4: max relative difference "
              f"{rows['chunk_rel_diff']:.3e}", flush=True)
        out[precision] = rows
        del model
    return out


if __name__ == "__main__":
    main()
