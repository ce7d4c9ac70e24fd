"""The port's entry points for a quick check (the twin of
``__graft_entry__.py``): the flagship's eval forward on one card, and a
dry run of training over several ranks.

    python graft_entry_torch.py [cpu]                 # entry() on the card (or CPU)
    python -c "import graft_entry_torch as g; g.dryrun_multichip(2, device='cpu')"

As ``lvae_tpu``'s, :func:`dryrun_multichip` builds a 2-D ``(data, space)``
layout with a space axis of 2 for an even rank count (``--spatial-shards
2``: each data shard's two ranks hold a band of rows of every activation),
and a data axis alone for an odd one. It imports torch and
``lvae_tpu_torch``, never jax or ``lvae_tpu``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the share of the dry run's parameter and statistic elements that may lie
# beyond 1e-4 of the one-rank run's: ~10x the flagship's readings on an
# H100 (4.8e-7 to 1.9e-6: one to four of its ~2.07M)
FAR_SHARE = 2e-5


def _flagship(device="cuda", seed: int = 0, **overrides):
    """The flagship: the static-binarized-MNIST Ladder VAE
    (``__graft_entry__._flagship``), its weights drawn from ``seed``."""
    from lvae_tpu_torch.models.lvae import LadderVAE

    kw = dict(color_ch=1, z_dims=(32, 32, 32), blocks_per_layer=2, n_filters=64,
              stochastic_skip=True, gated=True, downsample=(1, 1, 1), learn_top_prior=True,
              img_size=(32, 32), data_size=(28, 28), likelihood="bernoulli",
              dropout_rate=0.2)
    kw.update(overrides)
    return LadderVAE(generator=torch.Generator().manual_seed(seed), **kw).to(device)


def _device(device: Optional[str]) -> torch.device:
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (torch.cuda.is_available() is False); "
                           "pass device='cpu' to run the plain versions")
    return device


def entry(device: Optional[str] = None) -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: the flagship's eval forward ``ll -
    kl_sep.sum(0)`` per image (``__graft_entry__.entry``), on the card
    unless ``device='cpu'``. ``fn(model, x, seed, forced_eps=None)`` takes
    the model, an NHWC batch in [0, 1] and the latents' seed (image ``i``
    keyed by ``(seed, i)``); ``forced_eps`` (per-layer NHWC) replaces the
    draw."""
    from lvae_tpu_torch.models.stochastic import Noise

    device = _device(device)
    model = _flagship(device).eval()

    @torch.no_grad()
    def fwd(model, x, seed, forced_eps=None):
        index = torch.arange(x.shape[0], device=x.device)
        out = model(x, noise=Noise(seed, index, 0), forced_eps=forced_eps)
        return out["ll"] - out["kl_sep"].sum(dim=0)

    return fwd, (model, torch.zeros((8, 28, 28, 1), device=device), 1)


# ---------------------------------------------------------------------------
# the data-parallel dry run
# ---------------------------------------------------------------------------

def _dryrun_config(n_devices: int, flagship: bool, shards: int, spatial: int = 1):
    """The dry run's config under ``--fused all`` (the segments run split
    over the ranks) on ``shards x spatial`` ranks: ``__graft_entry__``'s
    tiny one (z 8-8-8, 8 filters, one block, global batch 2n), or the
    README's flagship at full width and depth (z 32-32-32, 64 filters,
    four blocks a layer, dropout 0.2, global batch 64)."""
    from lvae_tpu_torch.config import TrainConfig

    if flagship:
        kw = dict(zdims=(32, 32, 32), blocks_per_layer=4, n_filters=64, dropout=0.2,
                  batch_size=64)
    else:
        kw = dict(zdims=(8, 8, 8), blocks_per_layer=1, n_filters=8, dropout=0.1,
                  batch_size=2 * n_devices)
    return TrainConfig(dataset="dryrun", downsample=(1, 1, 1), skip=True, gated=True,
                       learn_top_prior=True, test_batch_size=kw["batch_size"], seed=0,
                       dry_run=True, fused="all", num_data_shards=shards,
                       spatial_shards=spatial, **kw)


def _dryrun_data(batch: int):
    """The dry run's data, as ``__graft_entry__`` makes it: ``4 batch``
    binary 28x28 train images (the test split their first ``batch``), then
    the mixture check's pixels and parameters, all from
    ``np.random.default_rng(0)``."""
    from lvae_tpu_torch.data.registry import Dataset

    rng = np.random.default_rng(0)
    train = (rng.uniform(size=(4 * batch, 28, 28, 1)) < 0.5).astype(np.uint8)
    data = Dataset("dryrun", train[:batch], (28, 28), (32, 32), 1, "none", "bernoulli",
                   train=train)
    xk = np.round(rng.uniform(size=(4 * batch, 8, 8, 3)) * 255.0) / 255.0
    pk = rng.normal(size=(4 * batch, 8, 8, 100))
    return data, xk.astype(np.float32), pk.astype(np.float32)


def _dryrun_body(spec: dict, layout, out_dir: str) -> dict:
    """One rank's dry run (``layout`` its rank layout; ``Layout()`` for the
    one-rank reference): 3 train steps on its rows of global batches 0-2,
    the sharded test ELBO, a checkpoint round trip (rank 0 writes, every
    rank restores into a fresh model, bit-equal) and a step after it, the
    mixture log-prob on its rows against the plain version on the whole
    batch (``rtol=1e-4, atol=1e-5``, ``__graft_entry__.py:199-207``)."""
    from lvae_tpu_torch.kernels import build
    from lvae_tpu_torch.kernels.mixture import _plain_mix_log_prob, mix_log_prob
    from lvae_tpu_torch.parallel import mesh, multihost
    from lvae_tpu_torch.train.checkpoint import CheckpointManager
    from lvae_tpu_torch.train.state import train_step
    from lvae_tpu_torch.train.trainer import Experiment

    device = torch.device(spec["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = _dryrun_config(spec["n_devices"], spec["flagship"], layout.n_data, layout.n_space)
    batch = cfg.batch_size
    data, xk, pk = _dryrun_data(batch)
    exp = Experiment(cfg, device, data=data)
    state = exp.init_state()

    def step(state, i):
        index = mesh.make_global_batch_indices(
            torch.arange(batch, device=device) + i * batch, layout)
        return train_step(state, exp.train_data.gather(index), index, exp.loss_cfg)

    build.reset_launches()
    t0 = time.perf_counter()
    metrics = [step(state, i) for i in range(3)]
    elbos = [float(m["elbo"]) for m in metrics]
    losses = [float(m["loss"]) for m in metrics]
    if device.type == "cuda":
        torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    assert state.step == 3
    assert all(np.isfinite(e) for e in elbos), elbos
    assert elbos[-1] > elbos[0] - 50.0, elbos      # 3 Adamax steps do not blow the loss up
    params = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}

    ev = exp.evaluate(state)
    assert np.isfinite(ev["elbo"]) and np.isfinite(ev["bpd"]), ev

    mngr = CheckpointManager(out_dir, keep=1)
    if layout.primary:
        mngr.save(state)
    multihost.barrier(layout)
    restored = mngr.restore(Experiment(cfg, device, data=data).init_state(data_dep_init=False))
    assert restored.step == 3
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v.cpu(), params[k]), k
    m4 = step(restored, 3)
    assert restored.step == 4 and np.isfinite(float(m4["elbo"]))

    # the mixture log-prob on this rank's rows: K3 on the card, its plain
    # version on the CPU; against the plain version on the whole batch
    rows = layout.rows(xk.shape[0])
    x = torch.from_numpy(xk).to(device).permute(0, 3, 1, 2).contiguous()
    p = torch.from_numpy(pk).to(device).permute(0, 3, 1, 2).contiguous()
    got = mix_log_prob(x[rows], p[rows])
    want = _plain_mix_log_prob(x, p, 10, 256)[rows]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)

    return {"rank": layout.rank, "size": layout.size, "backend": layout.backend,
            "spatial": layout.n_space,
            "elbos": elbos, "losses": losses, "steps_s": steps_s, "launches": launches,
            "eval": {k: float(ev[k]) for k in ("elbo", "ll", "kl", "bpd")},
            "eval_images": int(ev["n_images"]), "elbo_after_restore": float(m4["elbo"]),
            "mix_max_abs_err": float((got - want).abs().max()), "params": params}


def _dryrun_rank(spec_path: str) -> None:
    """A launched rank's part of :func:`dryrun_multichip`: join the group,
    run :func:`_dryrun_body`; rank 0 writes the result."""
    from lvae_tpu_torch.parallel import multihost

    spec = json.loads(Path(spec_path).read_text())
    layout = multihost.initialize(device=spec["device"], spatial=spec["spatial"])
    try:
        result = _dryrun_body(spec, layout, spec["dir"])
        if layout.primary:
            torch.save(result, os.path.join(spec["dir"], "rank0.pt"))
        multihost.barrier(layout)
    finally:
        multihost.shutdown()


def dryrun_multichip(n_devices: int, device: Optional[str] = None, flagship: bool = False,
                     timeout_s: float = 600.0) -> dict:
    """``__graft_entry__.dryrun_multichip`` over ``n_devices`` ranks of a
    ``(data, space)`` layout with, as ``__graft_entry__.py:112-140``, a
    space axis of 2 where ``n_devices`` is even, else none (data only):
    ``n_devices`` processes (NCCL, one a card, where that
    many cards are visible; else gloo, on the CPU or sharing a card) each
    run 3 training steps under ``--fused all`` at a finite ELBO (each rank
    on its data shard's rows, and on its band of them), the sharded
    ``Experiment.evaluate``, a checkpoint round trip with bit-equal
    parameters and a step after the restore, and the mixture log-prob on
    their rows (K3 on the card) against the plain version on the whole
    batch. Then this process runs the same 3 steps on one rank, with no
    process group, and holds rank 0's losses and parameters against them:
    losses to 1e-5 relative; every parameter and statistic within Adamax's
    bound of 2 lr a step, and all but FAR_SHARE of their elements within
    1e-4 (Adamax moves an element by about the lr a step in its gradient's
    direction, which the order of the sums can flip where the gradient is
    within rounding of 0: the conv biases that only a BatchNorm reads,
    ``tests/test_torch_train.py``, and stray elements of a wide model).

    ``device`` 'cuda' (the default) or 'cpu'; ``flagship`` the flagship at
    full width instead of the tiny model. Returns rank 0's result with the
    one-rank run's beside it."""
    from lvae_tpu_torch.parallel import Layout, multihost

    device = str(_device(device))
    spatial = 2 if n_devices % 2 == 0 else 1
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"n_devices": n_devices, "device": device, "flagship": flagship, "dir": tmp,
                "spatial": spatial}
        spec_path = os.path.join(tmp, "spec.json")
        Path(spec_path).write_text(json.dumps(spec))
        t0 = time.perf_counter()
        try:
            code = multihost.launch([sys.executable, str(ROOT / "graft_entry_torch.py"),
                                     "--dryrun-rank", spec_path], n_devices, timeout_s)
        except TimeoutError as e:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {e}") from e
        if code:
            raise RuntimeError(f"dryrun_multichip({n_devices}): a rank exited with code {code}")
        wall_s = time.perf_counter() - t0
        result = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
        with tempfile.TemporaryDirectory() as tmp1:
            one = _dryrun_body(spec, Layout(), tmp1)
    lr = _dryrun_config(n_devices, flagship, 1).lr
    np.testing.assert_allclose(result["losses"], one["losses"], rtol=1e-5)
    diff = torch.cat([(result["params"][k].double() - v.double()).abs().reshape(-1)
                      for k, v in one["params"].items()])
    # Adamax moves an element by about lr a step in its gradient's
    # direction, so one whose gradient is within the sums' rounding of 0
    # (the conv biases that only a BatchNorm reads, and stray elements) can
    # land up to 2 lr a step away; all others agree to 1e-4
    far = float((diff > 1e-4).double().mean())
    assert float(diff.max()) <= 2 * lr * 3, float(diff.max())
    assert far <= FAR_SHARE, far
    result.update(one_rank={k: one[k] for k in ("elbos", "losses", "eval", "launches")},
                  param_max_diff=float(diff.max()), param_share_beyond_1e4=far,
                  wall_s=wall_s)
    result.pop("params")
    axes = (f"{n_devices // spatial} data x {spatial} space" if spatial > 1 else "data only")
    print(f"dryrun_multichip: {n_devices} ranks ({result['backend']}, {axes}) OK on "
          f"{device} — 3 steps elbo {result['elbos'][0]:.2f} -> {result['elbos'][-1]:.2f} "
          f"(one rank {one['elbos'][-1]:.2f}), eval elbo {result['eval']['elbo']:.2f} "
          f"(bpd {result['eval']['bpd']:.3f}), checkpoint roundtrip bitwise + "
          f"post-restore step OK, sharded mixture log-prob matches the plain version")
    return result


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-rank":
        _dryrun_rank(sys.argv[2])
    else:       # python graft_entry_torch.py [cuda|cpu]
        fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else None)
        out = fn(*args)
        print("entry forward:", tuple(out.shape), float(out.mean()))
