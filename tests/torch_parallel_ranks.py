"""The rank side of ``tests/test_torch_parallel.py``: run as a launched
rank (``lvae_tpu_torch.parallel.multihost.launch`` sets RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT),

    python tests/torch_parallel_ranks.py <spec.pt>

it joins the gloo group on the CPU, runs each case of the spec on its rows
of the global batch and saves rank 0's results beside the spec
(``<spec>.out.pt``). It imports torch and the port only, never jax: the
test process runs ``lvae_tpu``'s side and compares."""

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
    ``case["model"]`` with ``case["state_dict"]``, on this rank's rows of
    each global batch, the latents given (``forced_eps``). Returns per
    step the loss, the metrics, the gradients the optimiser took (after
    the sum over the ranks) and the state_dict."""
    torch.manual_seed(0)
    model = LadderVAE(**case["model"])
    model.load_state_dict(case["state_dict"], strict=True)
    model = model.double()
    state = TrainState(step=0, model=model, optimizer=make_optimizer(model, case["lr"]),
                       ema=init_ema(len(case["model"]["z_dims"]), "cpu"), seed=0)
    cfg = LossConfig(**case["loss"])
    out = []
    for i, (batch, eps) in enumerate(zip(case["batches"], case["eps"])):
        rows = layout.rows(batch.shape[0])
        index = torch.arange(batch.shape[0])[rows] + i * batch.shape[0]
        m = train_step(state, batch[rows], index, cfg, forced_eps=[e[rows] for e in eps])
        out.append({"loss": float(m["loss"]),
                    "metrics": {k: v.clone() for k, v in m.items()},
                    "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                              if p.grad is not None},
                    "state_dict": {k: v.clone() for k, v in model.state_dict().items()}})
    return {"steps": out}


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


CASES = {"train": train_case, "eval": eval_case, "init": init_case}


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


def launch_cases(cases: dict, world: int = 2, timeout_s: float = 120.0) -> dict:
    """The test side: run ``cases`` (name -> case) on ``world`` gloo ranks
    of this script, with a timeout; rank 0's results."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.pt")
        torch.save({"world": world, "cases": cases}, path)
        code = multihost.launch([sys.executable, os.path.abspath(__file__), path], world,
                                timeout_s)
        assert code == 0, f"a rank exited with code {code}"
        return torch.load(path + ".out.pt", weights_only=False)


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    layout = multihost.initialize(device="cpu")
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
