#!/usr/bin/env python
"""Long-horizon drift of the PyTorch port (``lvae_tpu_torch``) against
``lvae_tpu``, on the CPU: the counterpart of ``tools/parity_drift.py``,
which holds ``lvae_tpu`` against the torch mirror.

    python tools/parity_drift_torch.py --steps 500 --conv-pad same --skip-merge pre
    python tools/parity_drift_torch.py --steps 500 --conv-pad torch --skip-merge post

One stochastic training trajectory runs through both packages' own train
steps (``lvae_tpu``'s ``make_batch_train_step`` and the port's
``train_step``: preprocessing, free bits, the warm-up beta, Adamax and the
metric EMA), in fp32 with dropout 0, from the same weights (carried across
by ``flax_to_torch_state_dict``). The latent noise of each (step, layer)
is one numpy draw given to both (``forced_eps``). The data order comes
from the two packages' ``ArrayLoader``s over ``tests/drift_harness.py``'s
blob images, seeded by ``--stream-seed``, and each step's two batches are
checked identical. Reported: the terminal test ELBO under shared eval
noise, its drift in bpd every ``--eval-every`` steps, and the per-step
loss gap. Imports both packages; it is not part of the port.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _ForcedEps:
    """``lvae_tpu``'s model with the latent draw given: what
    ``make_batch_train_step`` calls is ``apply``."""

    def __init__(self, model, eps):
        self.model, self.eps = model, eps

    def apply(self, variables, x, train=False, **kw):
        from tests.drift_harness import fwd_eps

        return self.model.apply(variables, x, self.eps, train, method=fwd_eps, **kw)


def run_drift_torch(steps=500, batch=32, zdims=(32, 32, 32), n_filters=64,
                    blocks_per_layer=2, img=28, conv_pad="same", skip_merge="pre",
                    free_bits=0.5, beta_anneal=200, lr=3e-4, seed=0, stream_seed=0,
                    n_train=2048, n_eval=256, eval_eps=4, eval_every=None,
                    progress=None) -> dict:
    """Run the shared trajectory; return the drift record: ``history``
    rows (step, both losses, both test ELBOs, the drift in bpd),
    ``losses`` (every step's pair), the terminal ELBOs, bpd and drift, and
    the largest per-step loss gap relative to ``lvae_tpu``'s loss."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from lvae_tpu.data.streaming import ArrayLoader as JArrayLoader
    from lvae_tpu.models.lvae import LadderVAE as JLadderVAE
    from lvae_tpu.train.convert import flax_to_torch_state_dict
    from lvae_tpu.train.state import LossConfig as JLossConfig
    from lvae_tpu.train.state import TrainState as JTrainState
    from lvae_tpu.train.state import make_batch_train_step
    from lvae_tpu.train.state import make_optimizer as j_make_optimizer
    from lvae_tpu_torch.data.streaming import ArrayLoader, HostFeed
    from lvae_tpu_torch.models.lvae import LadderVAE
    from lvae_tpu_torch.train.state import (
        LossConfig,
        TrainState,
        init_ema,
        make_optimizer,
        train_step,
    )
    from tests.drift_harness import _latent_shapes, fwd_eps, make_blob_data

    rng = np.random.default_rng(seed)
    pad = 32 if img == 28 else img
    dims, ln2 = img * img, float(np.log(2.0))
    train_u8 = make_blob_data(n_train, img, rng).astype(np.uint8)
    eval_x = make_blob_data(n_eval, img, rng)
    kw = dict(z_dims=tuple(zdims), downsample=(1,) * len(zdims),
              blocks_per_layer=blocks_per_layer, n_filters=n_filters, stochastic_skip=True,
              gated=True, learn_top_prior=True, img_size=(pad, pad), data_size=(img, img),
              batchnorm=True, dropout_rate=0.0, conv_pad=conv_pad, skip_merge_mode=skip_merge,
              likelihood="bernoulli")
    jm = JLadderVAE(color_ch=1, **kw)
    x0 = jnp.asarray(train_u8[:batch], jnp.float32)
    variables = jax.jit(lambda x: jm.init(
        {"params": jax.random.key(seed), "sample": jax.random.key(1)}, x, train=True))(x0)
    z_shapes = []          # static shapes: tracing the forward is enough
    jax.eval_shape(lambda v, x: z_shapes.extend(_latent_shapes(jm, v, x)), variables, x0)
    n_layers = len(zdims)

    # lvae_tpu: its own batch step, the latent draw given
    jcfg = JLossConfig(free_bits=free_bits, beta_anneal_steps=beta_anneal, preprocess="none")
    tx = j_make_optimizer(lr)
    params = variables["params"]
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=variables.get("batch_stats", {}), opt_state=tx.init(params),
        ema={"elbo": jnp.zeros(()), "ll": jnp.zeros(()), "kl": jnp.zeros(()),
             "loss": jnp.zeros(()), "kl_layers": jnp.zeros((n_layers,))},
        rng=jax.random.key(seed + 1))

    @jax.jit
    def jstep(state, batch_u8, eps):
        return make_batch_train_step(_ForcedEps(jm, eps), tx, jcfg)(state, batch_u8)

    @jax.jit
    def jeval(params, stats, x, eps):
        out = jm.apply({"params": params, "batch_stats": stats}, x, eps, False,
                       method=fwd_eps)
        return (out["ll"] - out["kl_sep"].sum(axis=0)).mean()

    # the port: its train_step from the same weights
    tm = LadderVAE(color_ch=1, **kw)
    sd = flax_to_torch_state_dict(variables["params"], variables["batch_stats"])
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                       strict=True)
    tstate = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, lr),
                        ema=init_ema(n_layers, "cpu"), seed=seed + 1)
    tcfg = LossConfig(free_bits=free_bits, beta_anneal_steps=beta_anneal, preprocess="none")

    def teval(x, eps):
        with torch.no_grad():
            out = tm(torch.from_numpy(x), forced_eps=[torch.from_numpy(e) for e in eps])
            return float((out["ll"] - out["kl_sep"].sum(dim=0)).mean())

    def eval_both():
        """Shared-noise test ELBO of both, averaged over ``eval_eps``
        draws, in batches of ``batch``."""
        ej = et = 0.0
        erng = np.random.default_rng(seed + 999)
        n_batches = n_eval // batch
        for _ in range(eval_eps):
            for bi in range(n_batches):
                xb = eval_x[bi * batch:(bi + 1) * batch]
                eps = [erng.normal(size=(batch,) + s).astype(np.float32) for s in z_shapes]
                ej += float(jeval(jstate.params, jstate.batch_stats, jnp.asarray(xb),
                                  [jnp.asarray(e) for e in eps]))
                et += teval(xb, eps)
        return ej / (eval_eps * n_batches), et / (eval_eps * n_batches)

    jbatches = JArrayLoader(train_u8, batch, seed=stream_seed).epochs()
    tbatches = HostFeed(ArrayLoader(train_u8, batch, seed=stream_seed),
                        torch.device("cpu")).stream()
    eps_rng = np.random.default_rng([seed, 1])
    history, losses = [], []
    t0 = time.time()
    for step in range(steps):
        jb = next(jbatches)
        index, tb = next(tbatches)
        if not np.array_equal(jb, tb.numpy()):
            raise AssertionError(f"step {step}: the two loaders' batches differ")
        eps = [eps_rng.normal(size=(batch,) + s).astype(np.float32) for s in z_shapes]
        jstate, jm_ = jstep(jstate, jnp.asarray(jb), [jnp.asarray(e) for e in eps])
        tm_ = train_step(tstate, tb, index, tcfg, forced_eps=[torch.from_numpy(e) for e in eps])
        losses.append((float(jm_["loss"]), float(tm_["loss"])))
        if eval_every and (step + 1) % eval_every == 0:
            ej, et = eval_both()
            row = dict(step=step + 1, loss_jax=losses[-1][0], loss_torch=losses[-1][1],
                       elbo_jax=ej, elbo_torch=et, drift_bpd=abs(ej - et) / (dims * ln2))
            history.append(row)
            if progress:
                progress(f"step {row['step']:>5}  loss lvae_tpu/port {row['loss_jax']:.4f}/"
                         f"{row['loss_torch']:.4f}  test-elbo {ej:.4f}/{et:.4f}  drift "
                         f"{row['drift_bpd']:.3e} bpd  [{time.time() - t0:.0f}s]")
    ej, et = eval_both()
    gaps = [abs(a - b) / abs(a) for a, b in losses]
    return {
        "history": history, "losses": losses,
        "loss_rel_gap_max": max(gaps), "loss_rel_gap_last": gaps[-1],
        "elbo_jax": ej, "elbo_torch": et,
        "bpd_jax": -ej / (dims * ln2), "bpd_torch": -et / (dims * ln2),
        "drift_bpd": abs(ej - et) / (dims * ln2),
        "ema_loss": (float(jstate.ema["loss"]), float(tstate.ema["loss"])),
        "steps": steps, "wall_s": time.time() - t0,
        "config": dict(steps=steps, batch=batch, zdims=tuple(zdims), n_filters=n_filters,
                       blocks_per_layer=blocks_per_layer, img=img, conv_pad=conv_pad,
                       skip_merge=skip_merge, free_bits=free_bits, beta_anneal=beta_anneal,
                       lr=lr, seed=seed, stream_seed=stream_seed, n_train=n_train,
                       n_eval=n_eval, eval_eps=eval_eps),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--zdims", type=int, nargs="+", default=[32, 32, 32])
    p.add_argument("--n-filters", type=int, default=64)
    p.add_argument("--blocks-per-layer", type=int, default=2)
    p.add_argument("--conv-pad", default="same", choices=["same", "torch"])
    p.add_argument("--skip-merge", default="pre", choices=["pre", "post"])
    p.add_argument("--freebits", type=float, default=0.5)
    p.add_argument("--beta-anneal", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stream-seed", type=int, default=0,
                   help="the seed of both ArrayLoaders' data order")
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--n-eval", type=int, default=256)
    p.add_argument("--eval-eps", type=int, default=4)
    p.add_argument("--json", action="store_true", help="print the record as JSON")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    r = run_drift_torch(
        steps=args.steps, batch=args.batch, zdims=tuple(args.zdims), n_filters=args.n_filters,
        blocks_per_layer=args.blocks_per_layer, conv_pad=args.conv_pad,
        skip_merge=args.skip_merge, free_bits=args.freebits, beta_anneal=args.beta_anneal,
        lr=args.lr, seed=args.seed, stream_seed=args.stream_seed, eval_every=args.eval_every,
        n_eval=args.n_eval, eval_eps=args.eval_eps, progress=lambda s: print(s, flush=True))
    print(f"\nterminal ({r['steps']} steps, {args.conv_pad}-{args.skip_merge}): test-ELBO "
          f"lvae_tpu {r['elbo_jax']:.4f} ({r['bpd_jax']:.5f} bpd)  port {r['elbo_torch']:.4f} "
          f"({r['bpd_torch']:.5f} bpd)  |drift| {r['drift_bpd']:.3e} bpd; per-step loss gap "
          f"max {r['loss_rel_gap_max']:.3e}, last {r['loss_rel_gap_last']:.3e} relative  "
          f"[wall {r['wall_s']:.0f} s]", flush=True)
    if args.json:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
