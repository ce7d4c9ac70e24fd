#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lvae_tpu_torch/csrc`` and checks each
against its plain PyTorch version at the flagship's shapes, then drives the
flagship model (static_mnist, z 32-32-32, 4 blocks per layer, 64 filters,
gated, skip, learned top prior; seeded random weights) through the normal
entry point, ``lvae_tpu_torch.evaluate.main``: test ELBO over 10,000
synthetic static_mnist-shaped images and the k=100 IW log-likelihood over
the first 1,000 of them (a prefix, to keep the run short). It checks that
this run launched every kernel of the path, that the kernel path, the
plain path and a CPU run agree, and times each kernel against its plain
version and the two sweeps in images/s.

Prints the card (``nvidia-smi`` name and power limit), one JSON line with
each kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and no result line is printed. Exits non-zero at once
when no CUDA device is visible.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 1000                                    # flagship eval batch
LATENT_SHAPES = [(32, 8, 8), (32, 4, 4), (32, 2, 2)]   # (c, h, w) per layer
N_TEST = 10_000
IW_SAMPLES = 100


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps=50, warmup=5):
    """Mean ms per call on the card (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps=1):
    """(device-busy ms per call, wall ms per call, table of the top
    kernels) from torch.profiler over ``reps`` calls. Device-busy time is
    the sum of the kernels' (device-side events') durations; the CPU-side
    operator events, which carry their kernels' time too, are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:8]
    table = [(e.key[:70], e.device_time_total / 1e3 / reps, e.count // reps)
             for e in top]
    return busy, wall, table, sum(e.count for e in kernels)


def device_ms(fn, reps=20, tries=3):
    """Device-busy ms per call, or None ("not measured") when no trace of
    ``tries`` holds as many kernel events as calls: the profiler was seen
    to drop the events of kernels launched through ctypes."""
    for _ in range(tries):
        busy, _, _, n_events = device_profile(fn, reps)
        if n_events >= reps:
            return busy
    return None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def total(values):
    return None if any(v is None for v in values) else sum(values)


def write_amat(path, images_u8):
    """Binary images as a Larochelle .amat: one row of 784 '0'/'1' per
    image, space separated."""
    n = images_u8.shape[0]
    row = np.full((n, 784 * 2), ord(" "), np.uint8)
    row[:, 0::2] = images_u8.reshape(n, 784) + ord("0")
    row[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(row.tobytes())


def phase_build():
    from lvae_tpu_torch.kernels import build

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    path, log = build.build()
    build.library()
    print(f"  built {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())


def phase_sample_kl(card):
    import torch
    from scipy import stats

    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops.philox import keyed_normal

    print("[2] sample+KL kernel vs its plain version", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    err, times = 0.0, []
    for layer, (c, h, w) in enumerate(LATENT_SHAPES):
        q = (torch.randn(B, 2 * c, h, w, generator=g) * 0.7).to(dev)
        p = (torch.randn(B, 2 * c, h, w, generator=g) * 0.7).to(dev)
        eps = torch.randn(B, c, h, w, generator=g).to(dev)
        index = torch.randperm(50_000, generator=g)[:B].to(dev)

        z, kl = sk.sample_kl_eps(q, p, eps)
        zr, klr = sk._plain_sample_kl_eps(q, p, eps)
        rel = max(((z - zr).abs() / zr.abs().clamp_min(1.0)).max().item(),
                  ((kl - klr).abs() / klr.abs().clamp_min(1.0)).max().item())
        check(rel <= 1e-6, f"[{B},{c},{h},{w}] given eps: z, kl within 1e-6 "
                           f"relative (max {rel:.2e})")

        z, kl = sk.sample_kl(q, p, index, 1234, 0, layer)
        zr, klr = sk._plain_sample_kl(q, p, index, 1234, 0, layer)
        e = max((z - zr).abs().max().item(), (kl - klr).abs().max().item())
        err = max(err, e)
        check(e <= 1e-5, f"[{B},{c},{h},{w}] Philox: z, kl match the plain "
                         f"generator (max abs {e:.2e})")
        pb = p[:1].expand(B, -1, -1, -1)
        zb, klb = sk.sample_kl(q, pb, index, 1234, 0, layer)
        zf, klf = sk.sample_kl(q, pb.contiguous(), index, 1234, 0, layer)
        check(torch.equal(zb, zf) and torch.equal(klb, klf),
              "row-stride-0 prior equals the materialised prior")
        perm = torch.randperm(B, generator=g).to(dev)
        zp, klp = sk.sample_kl(q[perm].contiguous(), p[perm].contiguous(),
                               index[perm], 1234, 0, layer)
        check(torch.equal(zp, z[perm]) and torch.equal(klp, kl[perm]),
              "a batch permuted with its index gives permuted outputs")

        kernel = lambda: sk.sample_kl(q, p, index, 1234, 0, layer)  # noqa: E731
        plain = lambda: sk._plain_sample_kl(q, p, index, 1234, 0, layer)  # noqa: E731
        t = [cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)]
        dk, dp = device_ms(kernel), device_ms(plain)
        times.append(((t[1] + t[2]) / 2, (t[0] + t[3]) / 2, dk, dp))
        print(f"  time [{B},{c},{h},{w}] per call: kernel {times[-1][0]:.4f} ms, "
              f"plain {times[-1][1]:.4f} ms; device busy: kernel {fmt_ms(dk)}, "
              f"plain {fmt_ms(dp)}  ({card})")

    # noise statistics: with mu = log-var = 0, z is eps itself
    c, h, w = LATENT_SHAPES[0]
    zeros = torch.zeros(B, 2 * c, h, w, device=dev)
    draws = []
    for seed in (7, 8):
        z, _ = sk.sample_kl(zeros, zeros, torch.arange(B, device=dev), seed, 0, 0)
        ref = keyed_normal(z.shape, seed, torch.arange(B, device=dev), 0, 0)
        e = (z - ref).abs().max().item()
        check(e <= 1e-5, f"kernel eps equals the plain generator's (max abs {e:.2e})")
        draws.append(z.flatten().double().cpu().numpy())
    x = np.concatenate(draws)
    n = x.size
    se = 1.0 / np.sqrt(n)
    check(n >= 1_000_000, f"{n} draws")
    check(abs(x.mean()) < 6 * se, f"eps mean {x.mean():+.2e} within 6 se")
    check(abs(x.var() - 1) < 6 * np.sqrt(2) * se, f"eps var {x.var():.6f} within 6 se")
    p1 = np.mean(np.abs(x) < 1.0)
    check(abs(p1 - 0.682689) < 1e-3, f"eps |x|<1 mass {p1:.4f}")
    ks = stats.kstest(x, "norm")
    check(ks.pvalue > 1e-3, f"KS vs N(0,1): D={ks.statistic:.2e} p={ks.pvalue:.3f}")
    lag = float(np.corrcoef(draws[0][:-1], draws[0][1:])[0, 1])
    check(abs(lag) < 6 / np.sqrt(draws[0].size), f"lag-1 autocorr {lag:+.2e}")
    return err, [total([t[i] for t in times]) for i in range(4)]


def phase_logsumexp(card):
    import torch

    from lvae_tpu_torch.kernels import logsumexp as lse

    print("[3] logsumexp kernel vs its plain version", flush=True)
    g = torch.Generator().manual_seed(1)
    err = 0.0
    for b in (1000, 777):
        x = torch.randn(100, b, generator=g) * 30 - 200
        x[:, 0] = float("-inf")             # all -inf -> -inf
        x[1:, 1] = float("-inf")            # all but one -> that one
        x[:, 2] = 1e30
        x[:, 3] = -1e30
        x[::2, 4] = 1e30
        x = x.cuda()
        out, ref = lse.logsumexp(x), lse._plain_logsumexp(x)
        check(out[0].item() == float("-inf") and not torch.isnan(out).any(),
              f"[100,{b}] all -inf column gives -inf, no NaN")
        check(out[1].item() == x[0, 1].item(), f"[100,{b}] all-but-one -inf column")
        check(out[2].item() == x[0, 2].item() and out[3].item() == x[0, 3].item(),
              f"[100,{b}] columns at +-1e30")
        fin = torch.isfinite(ref)
        check(torch.equal(fin, torch.isfinite(out)), "the same columns are finite")
        e = (out[fin] - ref[fin]).abs().max().item()
        rel = ((out[fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1.0)).max().item()
        err = max(err, e)
        check(rel <= 1e-6, f"[100,{b}] within 1e-6 relative (max abs {e:.2e})")
    x = (torch.randn(IW_SAMPLES, B, generator=g) * 30 - 200).cuda()
    t = [cuda_ms(lambda: lse._plain_logsumexp(x)), cuda_ms(lambda: lse.logsumexp(x)),
         cuda_ms(lambda: lse.logsumexp(x)), cuda_ms(lambda: lse._plain_logsumexp(x))]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    dk = device_ms(lambda: lse.logsumexp(x))
    dp = device_ms(lambda: lse._plain_logsumexp(x))
    print(f"  time [{IW_SAMPLES},{B}] per call: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; device busy: kernel {fmt_ms(dk)}, plain "
          f"{fmt_ms(dp)}  ({card})")
    return err, [ms, plain_ms, dk, dp]


FLAGSHIP = {
    "dataset": "static_mnist", "zdims": [32, 32, 32], "downsample": [1, 1, 1],
    "blocks_per_layer": 4, "n_filters": 64, "gated": True, "skip": True,
    "learn_top_prior": True, "nonlin": "elu", "dropout": 0.2,
    "test_batch_size": B, "fused": "auto", "freebits": 0.5, "batch_size": 64,
}


def flagship_model(device):
    """The flagship with seeded random weights: lecun-scale convs, the
    Gaussian heads at their normal(1e-2) init, small random biases and top
    prior (so every layer's KL is well above 0), BatchNorm running stats
    away from 0/1."""
    import torch

    from lvae_tpu_torch.config import config_from_dict
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.train.trainer import make_model

    cfg = config_from_dict(FLAGSHIP)
    meta = load_test_set("synthetic")     # the same 28x28x1 Bernoulli metadata
    g = torch.Generator().manual_seed(2024)
    model = make_model(cfg, meta, device, generator=g)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith("bias") or name.endswith("top_prior"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return model


def per_image_elbo(model, x, index, seed=0):
    from lvae_tpu_torch.train.state import per_image_forward

    ll, kl_sep = per_image_forward(model, x, index, seed)
    return ll - kl_sep.sum(dim=0)


def phase_slice(card):
    import torch

    from lvae_tpu_torch import evaluate, serving
    from lvae_tpu_torch.data.device import eval_preprocess_batch
    from lvae_tpu_torch.data.sources import make_synthetic
    from lvae_tpu_torch.eval.iwll import evaluate_iwll
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.train.state import evaluate_elbo

    print("[4] the slice through lvae_tpu_torch.evaluate.main", flush=True)
    dev = torch.device("cuda")
    model = flagship_model(dev)
    _, test = make_synthetic(n_train=0, n_test=N_TEST, seed=5)
    out = {}
    with tempfile.TemporaryDirectory() as run_dir:
        data_dir = os.path.join(run_dir, "data")
        os.makedirs(os.path.join(data_dir, "static_mnist"))
        write_amat(os.path.join(data_dir, "static_mnist", "binarized_mnist_test.amat"), test)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(dict(FLAGSHIP, data_dir=data_dir), f)
        weights = os.path.join(run_dir, "weights.pt")
        torch.save(model.state_dict(), weights)

        build.reset_launches()
        res = evaluate.main(["--load", run_dir, "--state-dict", weights, "--ll",
                             "--iw-samples", str(IW_SAMPLES), "--iw-max-batches", "1",
                             "--device", "cuda"])
        launches = dict(build.LAUNCHES)
    n_batches = N_TEST // B
    print(f"  launches in the evaluate run: {launches}")
    check(launches["sample_kl"] == 3 * (n_batches + IW_SAMPLES),
          f"sample+KL kernel: 3 launches per forward ({launches['sample_kl']})")
    check(launches["logsumexp"] == 1, "logsumexp kernel: 1 launch per IW batch")
    m, iw = res["elbo"], res["iw"]
    check(m["n_images"] == N_TEST and iw["n_images"] == B, "sweep sizes")
    vals = [m["elbo"], m["ll"], m["kl"], m["bpd"], iw["iw_ll"], *m["kl_layers"]]
    check(all(np.isfinite(v) for v in vals), "finite metrics")
    check(min(m["kl_layers"]) > 0.1, f"every layer has KL > 0.1 nats ({m['kl_layers']})")
    out["elbo"], out["iw"] = m, iw

    # the kernel path against the plain path and the CPU, per image
    test_dev = torch.from_numpy(test).to(dev)
    index = torch.arange(B, device=dev)
    x = eval_preprocess_batch(test_dev[:B], "none", index)
    with torch.no_grad():
        e_fused = per_image_elbo(model, x, index)
        for layer in model.top_down_layers:
            layer.stochastic.fused = False
        e_plain = per_image_elbo(model, x, index)
        model_cpu = flagship_model(torch.device("cpu"))
        model_cpu.load_state_dict(model.state_dict())
        for layer in model_cpu.top_down_layers:
            layer.stochastic.fused = False
        e_cpu = per_image_elbo(model_cpu, x[:16].cpu(), index[:16].cpu())
        for layer in model.top_down_layers:
            layer.stochastic.fused = True
    # log-mean-exp >= mean: the k=100 bound sits above the ELBO of the same
    # images, up to the noise of a one-sample ELBO mean (4 standard errors)
    mean, se = e_fused.mean().item(), e_fused.std().item() / B ** 0.5
    check(iw["iw_ll"] >= mean - 4 * se,
          f"IW-LL {iw['iw_ll']:.2f} >= ELBO {mean:.2f} - 4 se ({se:.2f}) of the "
          f"same {B} images")
    d = (e_fused - e_plain).abs().max().item()
    check(d <= 1e-3, f"per-image ELBO, --fused stochastic vs none: max {d:.2e} nats")
    d = (e_fused[:16].cpu() - e_cpu).abs().max().item()
    check(d <= 1e-2, f"per-image ELBO, GPU vs CPU: max {d:.2e} nats")

    u8 = test_dev[:64]
    r = serving.reconstruct(model, u8, 0, index[:64])
    check(r["out_mean"].shape == (64, 28, 28, 1) and torch.isfinite(r["elbo"]).all(),
          "reconstruct")
    d = (r["elbo"] - e_fused[:64]).abs().max().item()
    check(d <= 1e-3, f"reconstruct's ELBO is evaluate's ({d:.2e})")
    enc = serving.encode(model, u8, 0, index[:64])
    check([tuple(t.shape) for t in enc["mu"]]
          == [(64, 8, 8, 32), (64, 4, 4, 32), (64, 2, 2, 32)], "encode")
    gen = serving.generate(model, 16, seed=3)
    check(gen.shape == (16, 28, 28, 1) and bool(((gen >= 0) & (gen <= 1)).all()),
          "generate")

    print("[5] end-to-end times", flush=True)
    torch.cuda.synchronize()
    rates = {}
    for fused in (True, False, False, True):
        for layer in model.top_down_layers:
            layer.stochastic.fused = fused
        r = evaluate_elbo(model, test_dev, "none", B, 784)
        rates.setdefault(("elbo", fused), []).append(r["images_per_sec"])
    for fused, impl in ((True, "kernel"), (False, "streaming")):
        for layer in model.top_down_layers:
            layer.stochastic.fused = fused
        r = evaluate_iwll(model, test_dev, "none", 784, IW_SAMPLES, B,
                          logsumexp_impl=impl, max_batches=1)
        rates[("iw", fused)] = [r["images_per_sec"]]
    out["rates"] = {f"{k[0]}_{'kernels' if k[1] else 'plain'}": float(np.mean(v))
                    for k, v in rates.items()}
    for k, v in out["rates"].items():
        print(f"  {k}: {v:.1f} img/s  ({card})")

    # where a test-ELBO batch's time goes (kernels on, 2 batches)
    for layer in model.top_down_layers:
        layer.stochastic.fused = True
    busy, wall, table, _ = device_profile(
        lambda: evaluate_elbo(model, test_dev[:2 * B], "none", B, 784), 3)
    out["elbo_profile"] = {"device_busy_ms": busy, "wall_ms": wall,
                           "idle_share": 1.0 - busy / wall, "top": table}
    print(f"  test-ELBO profile, 2 batches of {B}: wall {wall:.2f} ms, device "
          f"busy {busy:.2f} ms, idle share {1.0 - busy / wall:.3f}  ({card})")
    for name, ms, count in table:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name}")
    out["launches"] = launches
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is "
              "False); this smoke run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import lvae_tpu_torch  # noqa: F401  (fails when run outside the repository)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"tf32 off", flush=True)
    t0 = time.perf_counter()
    phase_build()
    k2_err, k2_t = phase_sample_kl(card)
    k4_err, k4_t = phase_logsumexp(card)
    res = phase_slice(card)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": "sample_kl", "route": "cuda",
         "source": "lvae_tpu_torch/csrc/stochastic_kl.cu",
         "replaces": "lvae_tpu/kernels/stochastic_pallas.py:149",
         "launches": res["launches"]["sample_kl"], "max_abs_err": k2_err,
         "ms": k2_t[0], "plain_ms": k2_t[1], "device_ms": k2_t[2],
         "plain_device_ms": k2_t[3], "shapes": "3 layers at B=1000"},
        {"name": "logsumexp", "route": "cuda",
         "source": "lvae_tpu_torch/csrc/logsumexp.cu",
         "replaces": "lvae_tpu/kernels/logsumexp_pallas.py:36",
         "launches": res["launches"]["logsumexp"], "max_abs_err": k4_err,
         "ms": k4_t[0], "plain_ms": k4_t[1], "device_ms": k4_t[2],
         "plain_device_ms": k4_t[3], "shapes": "[100, 1000]"},
    ], "images_per_sec": res["rates"], "elbo_profile": res["elbo_profile"],
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
