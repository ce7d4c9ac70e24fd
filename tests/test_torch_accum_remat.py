"""``--grad-accum``, ``--remat``, ``--defer-metrics``, ``--debug-nans`` and
``--profile`` in the port's trainer, on the CPU:

- ``--grad-accum 2`` and ``3`` (and ``2`` with a binding clip) against
  ``lvae_tpu``'s ``optax.MultiSteps`` in float64 over 6 steps, at
  ``TestTrainStepParity``'s tolerances (losses rtol 1e-7, parameters and
  running statistics atol 1e-6); the parameters unmoved, bit for bit, on
  every micro-step but the k-th;
- ``MultiStep`` with accumulation bit-equal to single steps, from the
  start of an accumulation and from its middle;
- ``--auto-resume`` from a checkpoint in the middle of an accumulation
  bit-equal to an uninterrupted run (parameters, Adamax, the accumulator,
  its micro-step, the EMA);
- a ``--remat`` step bit-equal to a plain one (loss, every gradient, every
  running buffer, the parameters after Adamax) under ``--fused none`` and
  ``all``, with dropout; and ``--remat`` against ``lvae_tpu`` with
  ``remat=True`` in float64 over 2 steps at the tolerances above;
- ``--defer-metrics``' final line equal to the non-deferred EMA;
- an inf learning rate under ``--debug-nans`` raising
  ``FloatingPointError`` that names the step, with no checkpoint of it;
- ``--profile 1-3`` writing a Chrome trace.

Inputs and latent noise for the ``lvae_tpu`` comparisons come from numpy
(``forced_eps``), dropout 0, as in ``test_torch_train.py``."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.state import (
    GradAccum,
    LossConfig,
    MultiStep,
    TrainState,
    init_ema,
    loss_terms,
    make_optimizer,
    train_step,
)
from tests.test_torch_cli import CFG as CLI_CFG
from tests.test_torch_cli import _train
from tests.test_torch_train import (
    ANNEAL,
    B,
    FREE_BITS,
    HEAD_CFG,
    LR,
    _ForcedEps,
    _nest,
    _setup,
    _to64,
)

ACCUM_STEPS = 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parity(k: int, max_grad_norm=None, remat=False, steps=ACCUM_STEPS):
    """Per step: (loss, flat params, flat batch stats) of lvae_tpu's
    make_batch_train_step with ``grad_accum=k`` (and ``remat``), and
    (loss, state_dict) of the port's train_step with a ``GradAccum`` (and
    ``remat``), float64, the same batches and eps."""
    jm, params, stats, batches, eps = _setup()
    if remat:
        jm = jm.clone(remat=True)
    jcfg = JLossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
    tx = j_make_optimizer(LR, max_grad_norm, k)
    out_j = []
    with jax.enable_x64():
        p64 = _to64(params)
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=p64,
                            batch_stats=_to64(stats), opt_state=tx.init(p64),
                            ema=jax.tree_util.tree_map(jnp.zeros_like, {
                                "elbo": 0.0, "ll": 0.0, "kl": 0.0, "loss": 0.0,
                                "kl_layers": jnp.zeros(2)}),
                            rng=jax.random.key(0))

        @jax.jit
        def step(state, batch, e):
            return make_batch_train_step(_ForcedEps(jm, e), tx, jcfg)(state, batch)

        for batch, e in zip(batches[:steps], eps):
            state, m = step(state, jnp.asarray(batch), [jnp.asarray(a) for a in e])
            out_j.append((float(m["loss"]), flatten_dict(jax.device_get(state.params)),
                          flatten_dict(jax.device_get(state.batch_stats))))

    tm = LadderVAE(dropout_rate=0.0, remat=remat, **HEAD_CFG["bernoulli"][0])
    tm.load_state_dict(params_from_flax(params, stats), strict=True)
    tm = tm.double()
    ts = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, LR),
                    ema=init_ema(2, "cpu"), seed=0)
    if k > 1:
        ts.accum = GradAccum(tm.parameters(), k)
    tcfg = LossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none",
                      max_grad_norm=max_grad_norm)
    out_t = []
    for i, (batch, e) in enumerate(zip(batches[:steps], eps)):
        m = train_step(ts, torch.from_numpy(batch), torch.arange(B) + i * B, tcfg,
                       forced_eps=[torch.from_numpy(a) for a in e])
        out_t.append((float(m["loss"]), {k_: v.clone() for k_, v in tm.state_dict().items()}))
    return out_j, out_t, params


def _check_parity(out_j, out_t, steps):
    np.testing.assert_allclose([t[0] for t in out_t[:steps]], [j[0] for j in out_j[:steps]],
                               rtol=1e-7, atol=0)
    _, params_j, stats_j = out_j[steps - 1]
    sd = out_t[steps - 1][1]
    for tree in (params_j, stats_j):
        for path, a in tree.items():
            key = torch_key_for(path)
            want = params_from_flax({path[0]: _nest(path[1:], a)})[key]
            np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=0, atol=1e-6,
                                       err_msg=str(path))


def _param_keys():
    return [n for n, _ in LadderVAE(**HEAD_CFG["bernoulli"][0]).named_parameters()]


class TestGradAccumParity:
    """Tolerances of TestTrainStepParity: losses rtol 1e-7, parameters and
    running statistics atol 1e-6, float64."""

    @pytest.mark.parametrize("k,clip", [(2, None), (3, None), (2, 0.5)],
                             ids=["k2", "k3", "k2-clip"])
    def test_matches_lvae_tpu(self, k, clip):
        out_j, out_t, params0 = _parity(k, clip)
        _check_parity(out_j, out_t, ACCUM_STEPS)
        start = params_from_flax(params0)
        names = _param_keys()
        for i, (_, sd) in enumerate(out_t):
            prev = start if i == 0 else out_t[i - 1][1]
            unmoved = all(torch.equal(sd[n], prev[n].to(sd[n].dtype)) for n in names)
            # micro-steps 0..k-2 leave the parameters; the k-th moves them
            assert unmoved == ((i + 1) % k != 0), i
        # lvae_tpu's parameters stand still on the same micro-steps
        flat0 = flatten_dict(params0)
        for i, (_, pj, _) in enumerate(out_j):
            prev = flat0 if i == 0 else out_j[i - 1][1]
            moved = any(not np.array_equal(pj[p], prev[p]) for p in pj)
            assert moved == ((i + 1) % k == 0), i


class TestGradAccumSteps:
    def _state(self, k=2, dropout=0.2):
        torch.manual_seed(0)
        tm = LadderVAE(color_ch=1, dropout_rate=dropout, **CLI_CFG)
        st = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, 1e-3),
                        ema=init_ema(2, "cpu"), seed=3)
        st.accum = GradAccum(tm.parameters(), k)
        return st

    @pytest.mark.parametrize("start", [0, 1], ids=["aligned", "mid-accumulation"])
    def test_multistep_equals_single_steps(self, start):
        """``start`` single steps, then MultiStep(4) twice, against
        ``start + 8`` single steps (k = 2 accumulation, dropout): bit-equal
        parameters, Adamax state, accumulator, micro-step and EMA."""
        rng = np.random.default_rng(4)
        data = torch.from_numpy((rng.uniform(size=(64, 14, 14, 1)) < 0.4).astype(np.uint8))
        gather = lambda i: data[i]  # noqa: E731
        idx = torch.from_numpy(rng.integers(0, 64, size=(start + 8, 8)))
        cfg = LossConfig(free_bits=0.5, beta_anneal_steps=3)
        a, b = self._state(), self._state()
        for row in idx:
            train_step(a, gather(row), row, cfg)
        for row in idx[:start]:
            train_step(b, gather(row), row, cfg)
        multi = MultiStep(b, gather, cfg, 4)
        multi(idx[start:start + 4])
        multi(idx[start + 4:])
        assert a.step == b.step == start + 8
        _same_state(a, b)


def _same_state(a, b):
    for k, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][n], sb[i][n]) for i in sa for n in sa[i])
    assert all(torch.equal(x, y) for x, y in zip(a.accum.acc, b.accum.acc))
    assert torch.equal(a.accum.mini_step, b.accum.mini_step)
    for k in a.ema:
        assert torch.equal(a.ema[k], b.ema[k]), k


class TestGradAccumCLI:
    def test_auto_resume_mid_accumulation(self, tmp_path, capsys):
        """Six steps at --grad-accum 2 in one run equal three (a checkpoint
        after the first micro-step of an accumulation), then an
        --auto-resume to six; the checkpoint holds the accumulator."""
        flags = ["--run-name", "r", "--grad-accum", "2"]
        whole = _train(tmp_path / "a", *flags, "--max-steps", "6")
        _train(tmp_path / "b", *flags, "--max-steps", "3")
        ckpt = torch.load(os.path.join(tmp_path, "b", "r", "checkpoints", "ckpt_00000003.pt"),
                          weights_only=True)
        assert int(ckpt["accum"]["mini_step"]) == 1 and ckpt["accum"]["k"] == 2
        assert any(float(a.abs().max()) > 0 for a in ckpt["accum"]["acc"])
        resumed = _train(tmp_path / "b", *flags, "--max-steps", "6", "--auto-resume")
        assert "auto-resumed" in capsys.readouterr().out
        assert whole.state.step == resumed.state.step == 6
        _same_state(whole.state, resumed.state)

    def test_resume_needs_the_same_accumulation(self, tmp_path):
        _train(tmp_path, "--run-name", "r", "--grad-accum", "2", "--max-steps", "3")
        with pytest.raises(ValueError, match="--grad-accum"):
            _train(tmp_path, "--run-name", "r", "--max-steps", "6", "--auto-resume")

    def test_plain_checkpoint_layout(self, tmp_path):
        """A run without --grad-accum keeps the checkpoint's keys."""
        tr = _train(tmp_path, "--run-name", "r", "--max-steps", "3")
        ckpt = torch.load(os.path.join(tr.run_dir, "checkpoints", "ckpt_00000003.pt"),
                          weights_only=True)
        assert sorted(ckpt) == ["ema", "model", "optimizer", "seed", "step"]
        assert tr.state.accum is None


def _one_step(remat: bool, fused: bool, weights=None):
    """One train step (dropout 0.2) of the tiny model from ``weights``:
    (loss, gradients, state_dict after the step)."""
    tm = LadderVAE(color_ch=1, dropout_rate=0.2, remat=remat, fused_stochastic=fused,
                   fused_segments=fused, **CLI_CFG)
    if weights is not None:
        tm.load_state_dict(weights)
    st = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, 1e-3),
                    ema=init_ema(2, "cpu"), seed=9)
    rng = np.random.default_rng(8)
    batch = torch.from_numpy((rng.uniform(size=(8, 14, 14, 1)) < 0.4).astype(np.uint8))
    index = torch.arange(8)
    x = batch.float()
    loss, _ = loss_terms(tm, x, Noise(9, index, torch.tensor(5)), 1.0, 0.5)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    st.optimizer.step()
    return float(loss.detach()), grads, {k: v.clone() for k, v in tm.state_dict().items()}


class TestRemat:
    @pytest.mark.parametrize("fused", [False, True], ids=["none", "all"])
    def test_step_bit_equal_to_plain(self, fused):
        """--remat recomputes each resampling block in the backward: the
        loss, every gradient, every running buffer (moved once) and the
        parameters after Adamax equal the plain step's bit for bit, with
        dropout on (the recompute reads the forward's key)."""
        torch.manual_seed(0)
        w = LadderVAE(color_ch=1, **CLI_CFG).state_dict()
        lp, gp, sp = _one_step(False, fused, w)
        lr, gr, sr = _one_step(True, fused, w)
        assert lp == lr
        for n in gp:
            assert torch.equal(gp[n], gr[n]), n
        for k in sp:
            assert torch.equal(sp[k], sr[k]), k
        moved = [k for k in sp if "running" in k and not torch.equal(sp[k], w[k])]
        assert len(moved) > 10

    def test_remat_runs_the_blocks_under_checkpoint(self):
        tm = LadderVAE(color_ch=1, remat=True, **CLI_CFG)
        from lvae_tpu_torch.models.blocks import ResBlockWithResampling

        blocks = [m for m in tm.modules() if isinstance(m, ResBlockWithResampling)]
        assert blocks and all(m.remat for m in blocks)
        assert not any(m.remat for m in LadderVAE(color_ch=1, **CLI_CFG).modules()
                       if isinstance(m, ResBlockWithResampling))

    def test_matches_lvae_tpu_remat(self):
        """--remat against lvae_tpu's remat=True (nn.remat), float64, 2
        steps: losses rtol 1e-7, parameters and statistics atol 1e-6."""
        out_j, out_t, _ = _parity(1, remat=True, steps=2)
        _check_parity(out_j, out_t, 2)


class TestTrainerFlags:
    def test_defer_metrics_final_line(self, tmp_path, capsys):
        """--defer-metrics prints dispatch lines and one train line at the
        end, equal to the EMA the non-deferred run logs at that step."""
        plain = _train(tmp_path / "a", "--max-steps", "4", "--dry-run")
        deferred = _train(tmp_path / "b", "--max-steps", "4", "--dry-run", "--defer-metrics")
        out = capsys.readouterr().out
        assert "(metrics deferred)" in out
        lines = [(s, m) for kind, s, m in deferred.logger.history if kind == "train"]
        assert len(lines) == 1 and lines[0][0] == 4
        want = {s: m for kind, s, m in plain.logger.history if kind == "train"}[4]
        for k, v in lines[0][1].items():
            if k != "images_per_sec":
                np.testing.assert_array_equal(v, want[k], err_msg=k)

    def test_debug_nans_names_the_step(self, tmp_path):
        """An inf learning rate puts a NaN in the step: --debug-nans stops
        the run there with FloatingPointError naming the step, and saves
        no checkpoint of that state."""
        with pytest.raises(FloatingPointError, match=r"of step 0;"):
            _train(tmp_path, "--run-name", "r", "--max-steps", "6", "--lr", "inf",
                   "--debug-nans")
        assert not os.path.exists(os.path.join(tmp_path, "r", "checkpoints"))

    def test_debug_nans_quiet_on_a_healthy_run(self, tmp_path):
        tr = _train(tmp_path, "--max-steps", "3", "--dry-run", "--debug-nans")
        assert tr.state.step == 3 and int(tr.state.nan_step) == -1

    def test_profile_writes_a_trace(self, tmp_path, capsys):
        tr = _train(tmp_path, "--run-name", "r", "--max-steps", "4", "--profile", "1-3")
        assert "profiler trace for steps 1-3 written to" in capsys.readouterr().out
        files = os.listdir(os.path.join(tr.run_dir, "trace"))
        assert len(files) == 1
        with open(os.path.join(tr.run_dir, "trace", files[0])) as f:
            assert json.load(f)["traceEvents"]

    @pytest.mark.parametrize("value", ["3", "3-1", "a-b"])
    def test_profile_range_checked(self, tmp_path, value):
        with pytest.raises(ValueError, match="--profile"):
            _train(tmp_path, "--max-steps", "1", "--dry-run", "--profile", value)
