"""Hardware checks of the port's CUDA kernels: the twin of
``tools/tpu_hw_tests.py``.

    python -m lvae_tpu_torch.hw_tests        (exit 0 = every check passes)

The CPU tests run each kernel wrapper's plain PyTorch version; the
kernels themselves, with the keyed Philox generator inside K1, K2 and K5,
run only on the card. This runs them there, with the checks of
``tools/tpu_hw_tests.py:84-279`` under the same names, in the same order,
at the same shapes (NCHW here) and thresholds; where a name holds a JAX
function its counterpart takes its place ("torch.logsumexp" for
"jax.nn.logsumexp", "autograd of the plain version" for "autodiff"):

1. the sample+KL kernels, elementwise (K2, K2-bwd) and reduced per row
   (K1, K1-bwd), forward and gradient, and their KL against the plain
   oracle (fp64 for the per-row sums), on ``[512, 64, 14, 14]`` q and p;
2. the eps stream, from the kernel's own z at mu = log-variance = 0, four
   keys of ``[1024, 16, 32, 32]`` (33.5M draws): moments, the |x| < 1
   mass and the |x| > 3 tail, correlation across blocks, lag 1 and
   across keys, one key redrawn bit for bit (:func:`eps_checks`, which
   takes the draws, so a CPU test runs it on ``keyed_normal``'s);
3. the IW logsumexp (K4) on ``[100, 1000]``, and a ragged ``[100, 999]``
   with a column of -inf;
4. the mixture log-prob (K3) and its hand-written backward (K3-bwd) on x
   ``[32, 3, 32, 32]``, params ``[32, 100, 32, 32]``;
5. the segment (K5) and its backward (K5-bwd) on ``[256, 64, 32, 32]``:
   without dropout against a plain BatchNorm + ELU, and at rate 0.2 its
   masks across calls and its zero-gradient rate.

Without a CUDA device it prints that it is a hardware test and returns 2:
it never scores the plain versions instead.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_KL_SHAPE = (512, 32, 14, 14)     # (B, c, h, w): q and p [512, 64, 14, 14]
EPS_SHAPE = (1024, 8, 32, 32)           # z of [1024, 16, 32, 32] params: 8.4M draws a key
EPS_KEYS = (0, 1, 2, 3)
BLOCK = 128 * 1024                      # the JAX tool's per-block stream, in elements


def row(name: str, ok, detail: str = "") -> tuple:
    """One check: ``(name, passed, detail)``."""
    return name, bool(ok), detail


def print_row(r: tuple) -> None:
    name, ok, detail = r
    print(f"[{'ok ' if ok else 'FAIL'}] {name:<52} {detail}", flush=True)


def _normal(rng: np.random.Generator, shape, scale=1.0, device="cuda") -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(device)


def sample_kl_checks(rng: np.random.Generator, device) -> list:
    """Checks 1-5: K2 and K1 forward and gradient, their KL gradients
    against each other and their KL against the plain oracle."""
    from lvae_tpu_torch.kernels import stochastic as sk
    from lvae_tpu_torch.ops.stochastic import gaussian_kl

    qmu, qlv, pmu, plv = (_normal(rng, SAMPLE_KL_SHAPE, s, device)
                          for s in (1.0, 0.5, 1.0, 0.5))
    index = torch.arange(SAMPLE_KL_SHAPE[0], device=device)

    def grads(fn, z_weight):
        q = torch.cat([qmu, qlv], 1).requires_grad_()
        p = torch.cat([pmu, plv], 1).requires_grad_()
        z, kl = fn(q, p, index, 0, 0, 0)
        (z.sum() * z_weight + kl.sum()).backward()
        return kl.detach(), (q.grad, p.grad)

    kl, g_e = grads(sk.sample_kl, 1e-3)
    klb, g_r = grads(sk.sample_kl_per_sample, 1e-3)
    out = [row("elementwise fwd+grad compiles and is finite",
               all(bool(torch.isfinite(g).all()) for g in g_e)),
           row("reduced fwd+grad compiles and is finite",
               all(bool(torch.isfinite(g).all()) for g in g_r))]
    # the KL's gradients alone: both variants draw one stream here, but the
    # z term's gradient depends on it, and the check is of the KL's
    _, gk_e = grads(sk.sample_kl, 0.0)
    _, gk_r = grads(sk.sample_kl_per_sample, 0.0)
    dmax = max(float((a - b).abs().max()) for a, b in zip(gk_e, gk_r))
    out.append(row("elementwise vs reduced KL grads agree", dmax < 1e-4,
                   f"max |d| = {dmax:.2e}"))
    # per-row sums of F = 6,272 fp32 terms in another order than the
    # oracle's: an fp64 reference at fp32 reassociation noise
    ref = gaussian_kl(qmu, qlv, pmu, plv)
    ref64 = ref.double().sum(dim=(1, 2, 3))
    e1 = float((kl - ref).abs().max())
    rel2 = float(((klb.double() - ref64).abs() / ref64.abs().clamp_min(1.0)).max())
    out += [row("elementwise KL matches oracle", e1 < 1e-5, f"max err {e1:.2e}"),
            row("reduced per-sample KL matches fp64 oracle", rel2 < 1e-5,
                f"rel err {rel2:.2e}")]
    return out


def eps_draws(device, keys=EPS_KEYS, shape=EPS_SHAPE) -> tuple:
    """``(draws, rerun)``: the kernel's z at mu = log-variance = 0, which is
    its eps, for each key (fp64 numpy, flattened), and key ``keys[0]``'s
    drawn again."""
    from lvae_tpu_torch.kernels import stochastic as sk

    b, c, h, w = shape
    zeros = torch.zeros(b, 2 * c, h, w, device=device)
    index = torch.arange(b, device=device)

    def draw(key):
        z, _ = sk.sample_kl(zeros, zeros, index, key, 0, 0)
        return z.flatten().double().cpu().numpy()

    return [draw(k) for k in keys], draw(keys[0])


def eps_checks(draws, rerun) -> list:
    """Checks 6-15 on standard-normal ``draws``, one flat array a key (at
    least two keys, each at least two blocks of 128 x 1024), and
    ``rerun``, the first key's drawn again: thresholds at 6 standard
    errors of the draws' count, as ``tools/tpu_hw_tests.py:124-168``."""
    eps = np.concatenate(draws)
    se = 1.0 / np.sqrt(eps.size)        # standard error of the mean
    mean, var = eps.mean(), eps.var()
    skew = (eps ** 3).mean()
    exkurt = (eps ** 4).mean() - 3.0
    p1 = np.mean(np.abs(eps) < 1.0)
    p3 = np.mean(np.abs(eps) > 3.0)
    out = [row("eps mean ~ 0", abs(mean) < 6 * se, f"{mean:+.2e} (6se={6 * se:.1e})"),
           row("eps var ~ 1", abs(var - 1) < 6 * np.sqrt(2) * se, f"{var:.6f}"),
           row("eps skew ~ 0", abs(skew) < 6 * np.sqrt(15) * se, f"{skew:+.2e}"),
           row("eps excess kurtosis ~ 0", abs(exkurt) < 6 * np.sqrt(96) * se,
               f"{exkurt:+.2e}"),
           row("eps |x|<1 mass ~ 0.6827", abs(p1 - 0.682689) < 1e-3, f"{p1:.4f}"),
           row("eps |x|>3 tail ~ 0.0027", abs(p3 - 0.002700) < 2e-4, f"{p3:.5f}")]
    # the JAX tool's blocks of 128 x 1024 draws; here each is 16 rows of
    # the [1024, 8, 32, 32] map, every element keyed by its own counter
    e0 = draws[0]
    nblk = min(e0.size // BLOCK, 8)
    blocks = e0[:nblk * BLOCK].reshape(nblk, BLOCK)
    cmax = max(abs(float(np.corrcoef(blocks[a], blocks[b])[0, 1]))
               for a in range(nblk) for b in range(a + 1, nblk))
    out.append(row("cross-block |corr| small", cmax < 5 * BLOCK ** -0.5, f"max {cmax:.2e}"))
    lag1 = float(np.corrcoef(e0[:-1], e0[1:])[0, 1])
    out.append(row("lag-1 autocorr ~ 0", abs(lag1) < 6 / np.sqrt(e0.size), f"{lag1:+.2e}"))
    c01 = float(np.corrcoef(draws[0], draws[1])[0, 1])
    out.append(row("different keys decorrelated", abs(c01) < 6 * se, f"{c01:+.2e}"))
    out.append(row("same key deterministic", np.array_equal(rerun, draws[0])))
    return out


def logsumexp_checks(rng: np.random.Generator, device) -> list:
    """Checks 16-17: K4 against ``torch.logsumexp``, and a ragged batch
    with a column of -inf (a fully masked sample gives -inf, not NaN)."""
    from lvae_tpu_torch.kernels.logsumexp import logsumexp

    elbo = torch.from_numpy(rng.normal(size=(100, 1000)).astype(np.float32) * 5 - 40
                            ).to(device)
    e4 = float((logsumexp(elbo) - torch.logsumexp(elbo, 0)).abs().max())
    out = [row("logsumexp matches torch.logsumexp", e4 < 1e-5, f"max err {e4:.2e}")]
    elbo2 = elbo[:, :999].contiguous()
    elbo2[:, 7] = -float("inf")
    got2 = logsumexp(elbo2).cpu().numpy()
    want2 = torch.logsumexp(elbo2, 0).cpu().numpy()
    fin = np.isfinite(want2)
    out.append(row("logsumexp ragged + all--inf column",
                   np.allclose(got2[fin], want2[fin], atol=1e-5) and got2[7] == -np.inf
                   and not np.any(np.isnan(got2)), f"col7={got2[7]}"))
    return out


def mixture_checks(rng: np.random.Generator, device) -> list:
    """Checks 18-19: K3 against the plain oracle, and K3-bwd against
    autograd of it."""
    from lvae_tpu_torch.kernels.mixture import mix_log_prob
    from lvae_tpu_torch.ops.likelihoods import discretized_logistic_mix_log_prob

    xm = torch.from_numpy(np.round(rng.uniform(size=(32, 3, 32, 32)) * 255).astype(np.float32)
                          / 255.0).to(device)
    pm = _normal(rng, (32, 100, 32, 32), device=device)
    gm = torch.from_numpy(rng.standard_normal((32, 32, 32)).astype(np.float32)).to(device)
    e5 = float((mix_log_prob(xm, pm) - discretized_logistic_mix_log_prob(xm, pm, dim=1))
               .abs().max())
    out = [row("mixture log-prob matches oracle", e5 < 1e-3, f"max err {e5:.2e}")]

    def grad(fn):
        p = pm.clone().requires_grad_()
        (fn(xm, p) * gm).sum().backward()
        return p.grad

    e6 = float((grad(mix_log_prob)
                - grad(lambda x, p: discretized_logistic_mix_log_prob(x, p, dim=1)))
               .abs().max())
    out.append(row("mixture hand-written VJP matches autograd of the plain version",
                   e6 < 1e-2, f"max err {e6:.2e}"))
    return out


def _seg_ref(x, g, b, eps=1e-5):
    """Train-mode BatchNorm (biased variance, fp32 sums) then ELU."""
    mean = x.mean(dim=(0, 2, 3))
    var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
    z = ((x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + eps).view(1, -1, 1, 1)
         * g.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))
    return F.elu(z), mean, var


def segment_checks(rng: np.random.Generator, device) -> list:
    """Checks 20-24: K5 without dropout against :func:`_seg_ref`, K5-bwd
    against autograd of it, and at rate 0.2 the keyed masks across calls
    and the backward's zero rate (51 of 256 bytes drop)."""
    from lvae_tpu_torch.kernels.segment import dropout_bn_act

    xs = _normal(rng, (256, 64, 32, 32), device=device)
    gam = _normal(rng, (64,), 0.2, device) + 1.0
    bet = _normal(rng, (64,), 0.1, device)
    with torch.no_grad():
        y_f, m_f, v_f = dropout_bn_act(xs, gam, bet, rate=0.0, act="elu")
        y_r, m_r, v_r = _seg_ref(xs, gam, bet)
    e7 = float((y_f - y_r).abs().max())
    e8 = max(float((m_f - m_r).abs().max()), float((v_f - v_r).abs().max()))
    out = [row("segment fwd matches oracle (no dropout)", e7 < 1e-4, f"max err {e7:.2e}"),
           row("segment batch stats match oracle", e8 < 1e-4, f"max err {e8:.2e}")]

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (xs, gam, bet)]
        y = fn(*ts)[0]
        (y * y).sum().backward()
        return [t.grad for t in ts]

    g_f = grads(lambda x, g, b: dropout_bn_act(x, g, b, rate=0.0, act="elu"))
    g_r = grads(_seg_ref)
    e9 = max(float((a - b).abs().max() / b.abs().max().clamp_min(1.0))
             for a, b in zip(g_f, g_r))
    out.append(row("segment VJP (incl. BN stats terms) matches autograd of the plain version",
                   e9 < 1e-3, f"max rel err {e9:.2e}"))

    xd = xs.abs() + 0.5
    with torch.no_grad():
        yd1, yd2 = (dropout_bn_act(xd, gam, bet, rate=0.2, act="relu", seed=7)[0]
                    for _ in range(2))
    out.append(row("segment dropout deterministic across calls", torch.equal(yd1, yd2)))
    x = xd.clone().requires_grad_()
    y = dropout_bn_act(x, gam, bet, rate=0.2, act="relu", seed=7)[0]
    (y * y).sum().backward()
    frac0 = float((x.grad == 0).double().mean())
    out.append(row("segment bwd mask matches fwd (zero-dx rate ~ 51/256)",
                   abs(frac0 - 51.0 / 256.0) < 0.01, f"{frac0:.4f}"))
    return out


def run_checks(device="cuda") -> tuple:
    """Every check in order on ``device``, each printed as it is made:
    ``(rows, draws)``, the rows and the eps draws of checks 6-15."""
    rng = np.random.default_rng(0)
    rows = []

    def add(new):
        for r in new:
            print_row(r)
        rows.extend(new)

    add(sample_kl_checks(rng, device))
    draws, rerun = eps_draws(device)
    add(eps_checks(draws, rerun))
    add(logsumexp_checks(rng, device))
    add(mixture_checks(rng, device))
    add(segment_checks(rng, device))
    return rows, draws


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("this is a hardware test; no CUDA device found", file=sys.stderr)
        return 2
    rows, _ = run_checks("cuda")
    ok = all(r[1] for r in rows)
    print("\nALL OK" if ok else "\nFAILURES", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
