"""The one general generator: each traffic ``kind`` is a loop of the port
driven by the mix's parameters, with its set-up, its measured window and
the observations its output check compares.

``train`` (:class:`Train`): the port's ``Experiment`` over a
device-resident split of ``n_train`` seeded uint8 images and its
``MultiStep``, ``steps_per_call`` steps a CUDA graph, fed the index
stream ``(arange(k B) + i k B) % n_train`` (so each call's rows all
differ). Set-up: the first call (``k`` eager steps, then the capture)
and one replay of the graph that the window replays, steps ``k .. 2k-1``.
Observed for the output check: on their way through the first call, the
first three steps (each step's loss, the first gradient from Adamax's
state after one step, the parameters after three); after the replay, its
returned loss (step ``2k-1``'s), the parameters, the metrics' EMA and the
BatchNorm running statistics, which the reference reaches over the same
``2k`` steps. The window: calls until ``seconds`` have passed, at most
two in flight, closed by a readback.

``iwll`` (:class:`Iwll`): ``eval/iwll.py`` ``iwll_batch``, the body of
``evaluate_iwll``'s sweep, over a device-resident test split of
``n_test`` seeded images in batches of ``batch``, ``n_samples`` samples
an image, ``chunk`` samples a forward, the ``logsumexp`` reduction named.
Set-up: one batch at ``warm_samples`` samples (every shape of the
window). ``head_scales`` draws the heads' weights at a trained model's
scale (:func:`portbench.weights.make`). The window: whole batches until ``seconds`` have passed, at
most two in flight, closed by a readback; the answers are each image's
IW-LL, of which ``n_check`` drawn from the seed are compared.

The weights come from :mod:`portbench.weights` and the data from the
seed; the program gets both and nothing else of the benchmark.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import weights
from portbench.reference import train as rt
from portbench.reference.model import LadderVAE, ladder

B1 = 0.9          # Adamax's first-moment decay (optax's default, the program's)
OBSERVED_STEPS = 3


def images(config: dict, n: int, seed: int) -> np.ndarray:
    """``n`` uint8 NHWC images drawn from the seed."""
    (h, w), c = config["data"]["img_size"], config["data"]["color_ch"]
    return np.random.default_rng(seed).integers(0, 256, size=(n, h, w, c), dtype=np.uint8)


def reference_shapes(config: dict) -> Dict[str, torch.Size]:
    """Every parameter and BatchNorm statistic of the configuration's
    model, by name, as the reference builds it (on the meta device)."""
    a, d = ladder(config), config["data"]
    with torch.device("meta"):
        model = LadderVAE(d["color_ch"], a["zdims"], a["downsample"], a["blocks_per_layer"],
                          a["n_filters"], d["img_size"], config["train"]["dropout"])
    return {k: v.shape for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@torch.no_grad()
def load(model: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's model, every
    parameter and BatchNorm statistic by name."""
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in w or tuple(w[name].shape) != tuple(t.shape):
            raise KeyError(f"the benchmark has no weight {name!r} of shape {tuple(t.shape)}")
        t.copy_(w[name])


def program_config(cell, seed: int, **extra):
    """The port's ``TrainConfig`` of the configuration file."""
    from lvae_tpu_torch.config import TrainConfig

    m, d, t = cell.config["model"], cell.config["data"], cell.config["train"]
    flags = {k: m[k] for k in ("skip", "gated", "learn_top_prior")}
    return TrainConfig(dataset="portbench", likelihood=d["likelihood"], seed=seed % 2**31,
                       dry_run=True, **ladder(cell.config), **flags, **t, **extra)


def dataset(cell, u8: np.ndarray, test: np.ndarray):
    from lvae_tpu_torch.data.registry import Dataset

    d = cell.config["data"]
    return Dataset("portbench", test, tuple(d["img_size"]), tuple(d["padded_size"]),
                   d["color_ch"], d["preprocess"], d["likelihood"], train=u8)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _change_gap(prog: dict, ref: dict, w0: dict, names, worst: bool = False) -> float:
    """Each leaf's gap of norms of the change from ``w0``, against the
    larger of the reference's norm of that leaf's change and of the median
    leaf's: the leaf at the 90th percentile of those gaps, or the worst.
    (A parameter's worst leaf is not compared: one small leaf, a BatchNorm
    scale over 2x2 maps, was seen to differ between two runs of the program
    on one seed by 2.4e-3 of the median leaf's change; PERF.md.)"""
    d_ref = {k: norm(ref[k] - w0[k]) for k in names}
    med = statistics.median(d_ref.values())
    gaps = [abs(norm(prog[k] - w0[k]) - d) / max(d, med) for k, d in d_ref.items()]
    if worst or len(gaps) < 2:
        return max(gaps)
    return statistics.quantiles(gaps, n=10, method="inclusive")[-1]


def train_numbers(prog: dict, ref: dict, w0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared in a training cell, each a gap to the
    reference (see PERF.md): the worst of the first steps' relative loss
    gaps, and the replay's (its last step's); the worst leaf's gap of
    first-gradient norms against the larger of the reference's norm of
    that leaf and of the median leaf; the same gap of norms of the change
    over the first steps and after the replay at the 90th-percentile leaf;
    the worst BatchNorm running statistic's after the replay; the widest
    gap of an entry of the metrics' EMA, against the larger of its
    reference and the median entry's. Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of the change."""
    ref_losses = ref["losses"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_losses))
    replay_loss = abs(prog["replay_loss"] - ref_losses[-1]) / abs(ref_losses[-1])
    g_ref = {k: norm(g) for k, g in ref["grads"].items()}
    med_g = statistics.median(g_ref.values())
    grad = max(abs(norm(prog["grads"][k]) - g) / max(g, med_g) for k, g in g_ref.items())
    moved = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    end, ref_end = prog["end"], ref["end"]
    e_prog = torch.cat([end["ema"][k].double().flatten().cpu() for k in sorted(ref_end["ema"])])
    e_ref = torch.cat([ref_end["ema"][k].flatten().cpu() for k in sorted(ref_end["ema"])])
    floor = e_ref.abs().median()
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "change_norm_gap": _change_gap(prog["params"], ref["params"], w0, moved),
            "replay_loss_gap": replay_loss,
            "replay_change_gap": _change_gap(end["params"], ref_end["params"], w0, moved),
            "bn_stats_gap": _change_gap(end["bn"], ref_end["bn"], w0, ref_end["bn"], worst=True),
            "ema_gap": float(((e_prog - e_ref).abs() / e_ref.abs().clamp_min(floor)).max())}


class _Kind:
    laps: List[tuple] = []

    def lap(self, what: str) -> None:
        """Note the end of a stage of set-up (the run's log reads them)."""
        self.laps.append((what, time.perf_counter()))

    def kernels(self) -> None:
        """Load the program's kernel library on a card, which builds it in
        a checkout's first run, as a stage of its own."""
        if self.device.type == "cuda":
            from lvae_tpu_torch.kernels import build

            build.library()
            self.lap("the kernels' library (nvcc in a checkout's first run)")


class Train(_Kind):
    kind = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t = cell.traffic
        self.k, self.n_train = int(t["steps_per_call"]), int(t["n_train"])
        self.batch = int(cell.config["train"]["batch_size"])
        self.rows = self.batch
        if self.k < OBSERVED_STEPS:
            raise ValueError(f"steps_per_call {self.k}: the first call's first "
                             f"{OBSERVED_STEPS} steps are observed")

    def setup(self) -> None:
        from lvae_tpu_torch.train.state import MultiStep
        from lvae_tpu_torch.train.trainer import Experiment

        cell, k, b = self.cell, self.k, self.batch
        self.laps = []
        self.lap("imports")
        self.kernels()
        u8 = images(cell.config, self.n_train, self.seed)
        exp = Experiment(program_config(cell, self.seed, steps_per_call=k), self.device,
                         dataset(cell, u8, u8[:1]))
        self.lap("data and the program's model")
        self.w0 = weights.make(reference_shapes(cell.config), self.seed, self.device)
        load(exp.model, self.w0)
        self.lap("weights")
        state = exp.init_state(data_dep_init=False)
        self.state_seed, self.loss_cfg = state.seed, exp.loss_cfg
        self.step = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k)
        period = self.n_train // math.gcd(self.n_train, k * b)
        base = torch.arange(k * b, device=self.device)
        self.calls = [((base + i * k * b) % self.n_train).view(k, b) for i in range(period)]
        rows = torch.cat([self.calls[0], self.calls[1 % len(self.calls)]])
        self.observed_rows = [(exp.train_data.gather(r), r) for r in rows]
        probe = _Probe(exp.model, state.optimizer, exp.loss_cfg.free_bits)
        try:
            self.step(self.calls[0])                 # k eager steps, then the capture
        finally:
            probe.remove()
        self.prog = probe.observed()
        self.lap(f"the first call: {k} eager steps and the capture")
        self.i = 1
        self.prog["replay_loss"] = float(self._call()["loss"])     # one replay
        self.prog["end"] = {
            "params": {n: p.detach().clone() for n, p in exp.model.named_parameters()},
            "ema": {n: e.clone() for n, e in state.ema.items()},
            "bn": {n: b.clone() for n, b in exp.model.named_buffers() if "running_" in n}}
        self.lap("one replay")
        self.exp = exp

    def window(self, seconds: float) -> dict:
        calls, dt, out = _in_flight(self._call, seconds, lambda m: float(m["loss"]))
        return {"attempted": calls * self.k, "images": calls * self.k * self.batch,
                "seconds": dt, "failed": 0 if math.isfinite(out) else calls * self.k}

    @staticmethod
    def end_to_end(w: dict, peak_bytes: int) -> Dict[str, float]:
        """The rate of the window, and the run's peak of allocated device
        memory: the window's graph replays allocate nothing, so the peak is
        set by the same step's eager runs and capture in set-up."""
        return {"train_images_per_s": w["images"] / w["seconds"],
                "train_peak_mem_gib": peak_bytes / 2**30}

    def _call(self) -> dict:
        m = self.step(self.calls[self.i % len(self.calls)])
        self.i += 1
        return m

    def free(self) -> None:
        del self.step, self.exp

    def reference(self, tf32: bool = False) -> dict:
        model = rt.build(self.cell.config, self.w0, self.device)
        with rt.matmul_precision(tf32):
            out = rt.train_steps(model, self.observed_rows, self.state_seed,
                                 self.loss_cfg.free_bits, self.cell.config["train"]["lr"],
                                 self.loss_cfg.ema_decay, OBSERVED_STEPS)
        self.ref_model = model
        return out

    def numbers(self, ref: dict, prog: Optional[dict] = None) -> Dict[str, float]:
        """The numbers of the program's observations, or of ``prog``: another
        run's, or a reference run's read as the program's (the control)."""
        prog = self.prog if prog is None else prog
        if "replay_loss" not in prog:
            prog = {**prog, "losses": prog["losses"][:OBSERVED_STEPS],
                    "replay_loss": prog["losses"][-1]}
        return train_numbers(prog, ref, self.w0)

    def flops_per_image(self) -> float:
        return rt.flops(self.ref_model, self.observed_rows[0][0][:2], train=True)


class _Probe:
    """Hooks that watch the first steps of a training call: the loss of
    each forward (from the model's outputs, as the program forms it), the
    first gradient from Adamax's moments after one step, and the
    parameters after ``OBSERVED_STEPS``. Idle while a graph is captured."""

    def __init__(self, model, optimizer, free_bits: float):
        self.names = {p: n for n, p in model.named_parameters()}
        self.opt, self.free_bits = optimizer, free_bits
        self.losses: List[torch.Tensor] = []
        self.grads = self.params = None
        self.steps = 0
        self.handles = [model.register_forward_hook(self._forward),
                        optimizer.register_step_post_hook(self._stepped)]

    def _forward(self, module, args, out) -> None:
        if _capturing() or len(self.losses) >= OBSERVED_STEPS:
            return
        kl = torch.clamp_min(out["kl_sep"].detach().double().mean(dim=1), self.free_bits)
        self.losses.append(-(out["ll"].detach().double().mean() - kl.sum()))

    def _stepped(self, optimizer, args, kwargs) -> None:
        if _capturing():
            return
        self.steps += 1
        if self.steps == 1:
            self.grads = {}
            for p, name in self.names.items():
                st = self.opt.state.get(p)
                self.grads[name] = (st["exp_avg"] / (1.0 - B1) if st else torch.zeros_like(p))
        if self.steps == OBSERVED_STEPS:
            self.params = {name: p.detach().clone() for p, name in self.names.items()}

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def observed(self) -> dict:
        if len(self.losses) < OBSERVED_STEPS or self.params is None:
            raise RuntimeError(f"the first call ran {self.steps} optimiser steps and "
                               f"{len(self.losses)} forwards; {OBSERVED_STEPS} are observed")
        return {"losses": [float(v) for v in self.losses], "grads": self.grads,
                "params": self.params}


class Iwll(_Kind):
    kind = "iwll"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        t = cell.traffic
        self.batch, self.n_test = int(t["batch"]), int(t["n_test"])
        self.k, self.chunk = int(t["n_samples"]), int(t["chunk"])
        self.lse, self.n_check = t["logsumexp"], int(t["n_check"])
        self.rows = self.batch * self.chunk
        if self.n_test % self.batch:
            raise ValueError(f"n_test {self.n_test} is not a multiple of the batch {self.batch}")

    def setup(self) -> None:
        from lvae_tpu_torch.train.trainer import make_model

        cell = self.cell
        self.laps = []
        self.lap("imports")
        self.kernels()
        u8 = images(cell.config, self.n_test, self.seed)
        data = dataset(cell, u8[:1], u8)
        self.model = make_model(program_config(cell, self.seed), data, self.device)
        self.lap("data and the program's model")
        self.w0 = weights.make(reference_shapes(cell.config), self.seed, self.device,
                               head_scales=self.cell.traffic.get("head_scales"))
        load(self.model, self.w0)
        self.model.eval()
        self.test = torch.from_numpy(u8).to(self.device)
        self.lap("weights")
        self.preprocess = data.preprocess
        self.answers: List[torch.Tensor] = []
        self.i = 0
        float(self._batch(int(self.cell.traffic["warm_samples"]))[0])
        self.lap("one batch at warm_samples")
        self.answers.clear()
        self.i = 0

    def _batch(self, k: Optional[int] = None) -> torch.Tensor:
        from lvae_tpu_torch.data.device import eval_preprocess_batch
        from lvae_tpu_torch.eval.iwll import iwll_batch

        start = (self.i * self.batch) % self.n_test
        index = torch.arange(start, start + self.batch, device=self.device)
        x = eval_preprocess_batch(self.test[start:start + self.batch], self.preprocess, index)
        ll = iwll_batch(self.model, x, index, self.seed, k or self.k, self.lse, self.chunk)
        self.answers.append(ll)
        self.i += 1
        return ll

    def window(self, seconds: float) -> dict:
        batches, dt, _ = _in_flight(self._batch, seconds, lambda ll: float(ll[0]))
        bad = int(sum(int((~torch.isfinite(a)).sum()) for a in self.answers))
        return {"attempted": batches * self.batch, "images": batches * self.batch,
                "seconds": dt, "failed": bad}

    @staticmethod
    def end_to_end(w: dict, peak_bytes: int) -> Dict[str, float]:
        return {"iwll_images_per_s": w["images"] / w["seconds"]}

    def free(self) -> None:
        """Keep the compared answers and their rows; drop the model."""
        n = len(self.answers) * self.batch
        rng = np.random.default_rng(self.seed)
        pick = np.sort(rng.choice(n, size=min(self.n_check, n), replace=False))
        answers = torch.cat(self.answers)
        self.prog = answers[torch.from_numpy(pick).to(self.device)].double().cpu()
        index = torch.from_numpy(pick % self.n_test).to(self.device)
        self.check_rows = (self.test[index], index)
        del self.model, self.answers

    def reference(self, tf32: bool = False) -> torch.Tensor:
        model = rt.build(self.cell.config, self.w0, self.device)
        u8, index = self.check_rows
        # as many samples a forward as the window's batch holds rows
        chunk = max(1, min(self.k, self.rows // max(1, len(index))))
        with rt.matmul_precision(tf32):
            out = rt.iwll(model, u8, index, self.seed, self.k, chunk)
        self.ref_model = model
        return out.double().cpu()

    def numbers(self, ref: torch.Tensor, prog: Optional[torch.Tensor] = None
                ) -> Dict[str, float]:
        """The widest relative gap of an image's IW-LL to the reference's."""
        prog = self.prog if prog is None else prog
        return {"iwll_gap": float(((prog - ref).abs() / ref.abs()).max())}

    def flops_per_image(self) -> float:
        return rt.flops(self.ref_model, self.check_rows[0][:2], train=False)


KINDS = {"train": Train, "iwll": Iwll}


def _in_flight(call, seconds: float, readback):
    """Run ``call()`` until ``seconds`` have passed, with at most two calls
    queued on the device (the host waits for the one before the last),
    then read the last result back (``readback``), which waits for every
    call: ``(calls, seconds taken, what was read)``."""
    t0 = time.perf_counter()
    prev, n = None, 0
    while True:
        out = call()
        n += 1
        ev = torch.cuda.Event() if out_on_cuda(out) else None
        if ev is not None:
            ev.record()
        if prev is not None:
            prev.synchronize()
        prev = ev
        if time.perf_counter() - t0 >= seconds:
            break
    value = readback(out)
    return n, time.perf_counter() - t0, value


def out_on_cuda(out) -> bool:
    t = out if isinstance(out, torch.Tensor) else next(iter(out.values()))
    return t.is_cuda


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: str
    config: dict
    traffic: dict
    rows: int                   # rows a forward
    rate: float                 # images/s over the traced window
    window_s: float
    spans: list                 # (demangled name, start ns, end ns) device events
    launches: Dict[str, int]    # the program's kernel launches in the window
    flops_per_image: float
