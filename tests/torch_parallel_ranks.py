"""The rank side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_spatial*.py``: run as a launched rank
(``lvae_tpu_torch.parallel.multihost.launch`` sets RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT),

    python tests/torch_parallel_ranks.py <spec.pt>

it joins the gloo group on the CPU (with the spec's space axis, ``spatial``),
runs each case of the spec on its rows of the global batch (and its band of
them) and saves rank 0's results beside the spec (``<spec>.out.pt``). It
imports torch and the port only, never jax: the test process runs
``lvae_tpu``'s side and compares."""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lvae_tpu_torch.models.lvae import LadderVAE  # noqa: E402
from lvae_tpu_torch.parallel import mesh, multihost  # noqa: E402
from lvae_tpu_torch.train.state import (  # noqa: E402
    LossConfig,
    TrainState,
    evaluate_elbo,
    init_ema,
    make_optimizer,
    train_step,
)


def train_case(case: dict, layout) -> dict:
    """``case["steps"]`` float64 train steps of the model built from
    ``case["model"]`` with ``case["state_dict"]`` (or, without one, drawn
    from seed 3), on this rank's rows of each global batch, the latents
    given (``forced_eps``) or, where ``case["eps"]`` holds None, keyed.
    Returns per step the loss, the metrics, the gradients the optimiser
    took (after the sum over the ranks) and the state_dict; with a space
    axis also ``band_faults``, the convolution inputs on any rank taller
    than their band plus a halo (:func:`band_hooks`)."""
    torch.manual_seed(0)
    model = LadderVAE(generator=torch.Generator().manual_seed(3), **case["model"])
    if case.get("state_dict") is not None:
        model.load_state_dict(case["state_dict"], strict=True)
    model = model.double()
    state = TrainState(step=0, model=model, optimizer=make_optimizer(model, case["lr"]),
                       ema=init_ema(len(case["model"]["z_dims"]), "cpu"), seed=0)
    cfg = LossConfig(**case["loss"])
    gather = mesh.gather_rows
    faults = band_hooks(model) if layout.n_space > 1 else None
    out = []
    for i, (batch, eps) in enumerate(zip(case["batches"], case["eps"])):
        rows = layout.rows(batch.shape[0])
        index = torch.arange(batch.shape[0])[rows] + i * batch.shape[0]
        m = train_step(state, batch[rows], index, cfg,
                       forced_eps=None if eps is None else [e[rows] for e in eps])
        out.append({"loss": float(m["loss"]),
                    "metrics": {k: v.clone() for k, v in m.items()},
                    "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                              if p.grad is not None},
                    "state_dict": {k: v.clone() for k, v in model.state_dict().items()}})
    result = {"steps": out}
    mesh.gather_rows = gather
    if faults is not None:
        n = torch.tensor([float(len(faults["bad"])), float(faults["seen"])], dtype=torch.float64)
        torch.distributed.all_reduce(n, group=layout.group)
        result.update(band_faults=int(n[0]), conv_inputs_seen=int(n[1]), faults=faults["bad"])
    return result


def band_hooks(model) -> dict:
    """Forward pre-hooks on every convolution of ``model`` before the crop
    noting each input (a band) taller than its map's band, ``ceil(H / S)``
    rows, and a
    wrap of the halo exchange (``mesh.gather_rows``, which the caller puts
    back) noting each rank's rows taller than the band plus 4 (the widest
    halo, the 5x5 stride-2 conv's, takes 3): no rank holds more of an
    activation than its band and the halo its next op reads."""
    from lvae_tpu_torch.models.blocks import Conv2d, ConvTranspose2d

    seen = {"bad": [], "seen": 0}

    def pre(module, args):
        bands = mesh.current_bands()
        if bands is None:
            return
        x = args[0]
        h = bands.height(x)
        seen["seen"] += 1
        if x.shape[-2] > -(-h // bands.count):
            seen["bad"].append((type(module).__name__, tuple(x.shape), h))

    head = set(model.likelihood_head.modules())     # per pixel, on the crop's rows
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)) and m not in head:
            m.register_forward_pre_hook(pre)
    gather = mesh.gather_rows

    def checked(x, want, bands=None):
        bands = bands or mesh.current_bands()
        h = bands.height(x)
        lo, hi = want[bands.index]
        c = -(-h // bands.count)
        if hi - lo > c + 4:
            seen["bad"].append(("rows", (lo, hi), h))
        return gather(x, want, bands)

    mesh.gather_rows = checked
    return seen


def modules_case(case: dict, layout) -> dict:
    """Each banded module of ``case["specs"]`` (a conv, the transposed
    conv, the nearest resize) in float64 on this rank's band of a seeded
    ``[2, 3, H, H]`` input, against the module on the whole input: the
    output band, the input's gradient band and the weight's and bias's
    gradients summed over the space group, from a seeded cotangent. Returns
    each spec's largest error over the ranks."""
    from lvae_tpu_torch.models.blocks import (Conv2d, ConvTranspose2d, init_parameters,
                                              resize_nearest)

    bands = mesh.Bands(layout.space, layout.n_space, layout.space_group, (1, 1))
    worst = {}
    for i, (kind, pad, k, stride, h) in enumerate(case["specs"]):
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(2, 3, h, h, generator=g, dtype=torch.float64)
        if kind == "conv":
            mod = Conv2d(3, 4, k, stride, conv_pad=pad)
        elif kind == "convT":
            mod = ConvTranspose2d(3, 4, k, stride, conv_pad=pad)
        else:
            mod = None
        if mod is not None:
            init_parameters(mod, g)
            with torch.no_grad():
                mod.bias.copy_(torch.randn(4, generator=g))
            mod = mod.double()
            fn = mod
        else:
            size = (h // 2, h // 2) if kind == "down" else (2 * h, 2 * h)
            fn = lambda t, size=size: resize_nearest(t, size)    # noqa: E731
        xr = x.clone().requires_grad_(True)
        yr = fn(xr)
        r = torch.randn(yr.shape, generator=g, dtype=torch.float64)
        (yr * r).sum().backward()
        h0, h1 = mesh.band(h, bands.count, bands.index)
        o0, o1 = mesh.band(yr.shape[-2], bands.count, bands.index)
        grads_ref = [p.grad.clone() for p in (mod.parameters() if mod is not None else [])]
        if mod is not None:
            mod.zero_grad(set_to_none=True)
        xb = x[:, :, h0:h1].clone().requires_grad_(True)
        with mesh.banded(bands):
            yb = fn(xb)
            (yb * r[:, :, o0:o1]).sum().backward()
        errs = [0.0 if yb.numel() == 0 else float((yb - yr[:, :, o0:o1]).abs().max()),
                float(tuple(yb.shape) != (2, yr.shape[1], o1 - o0, yr.shape[-1])),
                0.0 if xb.numel() == 0 else float((xb.grad - xr.grad[:, :, h0:h1]).abs().max())]
        if mod is not None:
            for p, ref in zip(mod.parameters(), grads_ref):
                total = p.grad.clone()
                torch.distributed.all_reduce(total, group=layout.space_group)
                errs.append(float((total - ref).abs().max()))
        e = torch.tensor([max(errs)], dtype=torch.float64)
        torch.distributed.all_reduce(e, op=torch.distributed.ReduceOp.MAX, group=layout.group)
        worst[(kind, pad, k, stride, h)] = float(e)
    return {"worst": worst}


def halo_case(case: dict, layout) -> dict:
    """``mesh.halo`` in float64 at each ``(H, top, bottom)`` of
    ``case["specs"]``: each rank's rows against the zero-padded whole map,
    and each band's gradient against the whole map's from every rank's
    seeded cotangent. Returns each spec's largest error over the ranks."""
    import torch.nn.functional as F

    bands = mesh.Bands(layout.space, layout.n_space, layout.space_group, (1, 1))
    worst = {}
    for h, top, bottom in case["specs"]:
        x = torch.randn(2, 3, h, h, generator=torch.Generator().manual_seed(h),
                        dtype=torch.float64)
        padded = F.pad(x, (0, 0, top, bottom))
        grad = torch.zeros_like(padded)
        for s in range(bands.count):
            a, b = mesh.band(h, bands.count, s)
            if b > a:
                r = torch.randn(2, 3, b - a + top + bottom, h, dtype=torch.float64,
                                generator=torch.Generator().manual_seed(1000 * h + s))
                grad[:, :, a:b + top + bottom] += r
        h0, h1 = mesh.band(h, bands.count, bands.index)
        xb = x[:, :, h0:h1].clone().requires_grad_(True)
        out = mesh.halo(xb, top, bottom, bands=bands)
        errs = [float(tuple(out.shape[-2:]) != ((h1 - h0 + top + bottom if h1 > h0 else 0), h))]
        if h1 > h0:
            errs.append(float((out - padded[:, :, h0:h1 + top + bottom]).abs().max()))
            r = torch.randn(out.shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(1000 * h + bands.index))
        else:
            r = torch.zeros_like(out)
        (out * r).sum().backward()
        if h1 > h0:
            errs.append(float((xb.grad - grad[:, :, top + h0:top + h1]).abs().max()))
        e = torch.tensor([max(errs)], dtype=torch.float64)
        torch.distributed.all_reduce(e, op=torch.distributed.ReduceOp.MAX, group=layout.group)
        worst[(h, top, bottom)] = float(e)
    return {"worst": worst}


def eval_case(case: dict, layout) -> dict:
    """The test ELBO and the IW-LL of a seeded model over ``case["test"]``
    at ``case["batch_size"]`` (a size the split does not divide)."""
    from lvae_tpu_torch.eval.iwll import evaluate_iwll

    model = LadderVAE(generator=torch.Generator().manual_seed(3), **case["model"]).eval()
    test = case["test"]
    elbo = evaluate_elbo(model, test, "none", case["batch_size"], case["data_dims"])
    iw = evaluate_iwll(model, test, "none", case["data_dims"], n_samples=4,
                       batch_size=case["batch_size"], logsumexp_impl="streaming", chunk=2)
    return {"elbo": elbo, "iw": iw}


def init_case(case: dict, layout) -> dict:
    """Data-dependent init through ``Experiment.init_state`` on every rank,
    then every parameter and buffer broadcast from rank 0 and compared with
    this rank's own: the ranks must hold one state."""
    from lvae_tpu_torch.config import TrainConfig
    from lvae_tpu_torch.data.registry import load_dataset
    from lvae_tpu_torch.train.trainer import Experiment

    cfg = TrainConfig(**case["config"])
    exp = Experiment(cfg, torch.device("cpu"), data=load_dataset(cfg.dataset))
    exp.init_state()
    same = True
    for t in [*exp.model.parameters(), *exp.model.buffers()]:
        mine = t.detach().clone()
        theirs = mine.clone()
        torch.distributed.broadcast(theirs, src=0, group=layout.group)
        same &= bool(torch.equal(mine, theirs))
    flag = torch.tensor([int(same)])
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN, group=layout.group)
    return {"same": bool(flag.item()),
            "state_dict": {k: v.clone() for k, v in exp.model.state_dict().items()}}


CASES = {"train": train_case, "eval": eval_case, "init": init_case,
         "modules": modules_case, "halo": halo_case}


def bn_fed_keys(model) -> set:
    """The state_dict keys of each conv bias whose output only a BatchNorm
    reads (true gradient 0; ``tests/test_torch_train.py`` ``_bn_fed``), and
    of that BatchNorm's running mean, which follows the bias."""
    from lvae_tpu_torch.models.blocks import ResidualBlock

    keys = set()
    for name, m in model.named_modules():
        if isinstance(m, ResidualBlock) and m.batchnorm:
            letters = m.block_type.replace("d", "")
            nc = nb = 0
            for i, ch in enumerate(letters):
                if ch == "c" and letters[i + 1:i + 2] == "b":
                    keys |= {f"{name}.Conv_{nc}.bias", f"{name}.BatchNorm_{nb}.running_mean"}
                nc += ch == "c"
                nb += ch == "b"
    return keys


def launch_cases(cases: dict, world: int = 2, timeout_s: float = 120.0,
                 spatial: int = 1) -> dict:
    """The test side: run ``cases`` (name -> case) on ``world`` gloo ranks
    of this script (``spatial`` of them to a data index), with a timeout;
    rank 0's results."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.pt")
        torch.save({"world": world, "spatial": spatial, "cases": cases}, path)
        code = multihost.launch([sys.executable, os.path.abspath(__file__), path], world,
                                timeout_s)
        assert code == 0, f"a rank exited with code {code}"
        return torch.load(path + ".out.pt", weights_only=False)


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    layout = multihost.initialize(device="cpu", spatial=spec.get("spatial", 1))
    assert mesh.current() is layout and layout.size == spec["world"]
    torch.set_num_threads(1)
    try:
        results = {name: CASES[case["kind"]](case, layout)
                   for name, case in spec["cases"].items()}
        if layout.primary:
            torch.save(results, spec_path + ".out.pt")
        multihost.barrier(layout)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
