"""The port's ``--streaming`` path on the CPU, held against ``lvae_tpu``:

- the loaders (``lvae_tpu_torch/data/streaming.py``) yield
  ``lvae_tpu.data.streaming``'s batches byte for byte (seeds, k-stacks
  across an epoch's end, a fast-forwarded start, a shard), each with the
  rows of the split it gathered;
- the old-config rule for ``stream_impl`` and its adoption on a resume;
- the batches the port's trainer hands its step under ``--streaming`` are
  those ``lvae_tpu``'s ``Trainer._run_streaming`` hands its step (both
  steps replaced by recorders);
- a streaming run resumes bit-equal (``--steps-per-call``,
  ``--grad-accum``), equals the resident path fed the loader's rows, and
  in float64 with shared eps matches ``lvae_tpu``'s
  ``make_batch_train_step`` on the streamed batches.

Tolerances: the loaders and every run of the port against itself are
bit-equal; the float64 steps against ``lvae_tpu`` hold
``test_torch_train.py``'s losses 1e-7 relative, parameters and BatchNorm
statistics 1e-6 absolute.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from lvae_tpu.data import streaming as jstreaming
from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.config import TrainConfig, train_config_from_dict
from lvae_tpu_torch.data.device import DeviceDataset
from lvae_tpu_torch.data.streaming import ArrayLoader, GrainLoader, HostFeed, make_loader
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.train import trainer as ttrainer
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.state import (
    LossConfig,
    MultiStep,
    TrainState,
    init_ema,
    make_optimizer,
    train_step,
)
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

LOADERS = {"array": (ArrayLoader, jstreaming.ArrayLoader),
           "grain": (GrainLoader, jstreaming.GrainLoader)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n=50, seed=0):
    """``n`` distinct uint8 NHWC images (row i's first byte is i)."""
    a = np.random.default_rng(seed).integers(0, 256, size=(n, 4, 3, 2), dtype=np.uint8)
    a[:, 0, 0, 0] = np.arange(n)
    return a


def _take(gen, n):
    return [next(gen) for _ in range(n)]


class TestLoaders:
    """Both loaders against lvae_tpu's, bit for bit: 50 images at batch 8
    (6 batches an epoch, 2 rows dropped), 9 calls, so k = 3 stacks cross
    epoch ends."""

    @pytest.mark.parametrize("impl", ["array", "grain"])
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("k,start", [(1, 0), (3, 0), (1, 5), (3, 9)],
                             ids=["k1", "k3", "k1-from-5", "k3-from-9"])
    def test_batches_equal_lvae_tpu(self, impl, seed, k, start):
        ours, theirs = LOADERS[impl]
        a = _images()
        kw = dict(seed=seed, steps_per_call=k)
        got = _take(ours(a, 8, **kw).epochs(start), 9)
        want = _take(theirs(a, 8, **kw).epochs(start), 9)
        for (index, batch), w in zip(got, want):
            assert batch.dtype == np.uint8 and batch.shape == w.shape
            np.testing.assert_array_equal(batch, w)
            assert index.shape == batch.shape[:batch.ndim - 3]
            np.testing.assert_array_equal(a[index], batch)

    @pytest.mark.parametrize("impl", ["array", "grain"])
    def test_shard_1_of_3(self, impl):
        """The shard's batches are lvae_tpu's; its rows are 1 + 3 i."""
        ours, theirs = LOADERS[impl]
        a = _images()
        kw = dict(seed=2, steps_per_call=2, shard_index=1, shard_count=3)
        got = _take(ours(a, 4, **kw).epochs(4), 6)
        want = _take(theirs(a, 4, **kw).epochs(4), 6)
        for (index, batch), w in zip(got, want):
            np.testing.assert_array_equal(batch, w)
            np.testing.assert_array_equal(a[index], batch)
            assert ((index - 1) % 3 == 0).all()

    def test_epochs_drop_the_remainder_and_do_not_repeat(self):
        """The array loader: an epoch is 6 distinct batches of 8 of the
        50 rows; the next epoch draws another order."""
        rows = np.stack([i for i, _ in _take(ArrayLoader(_images(), 8, seed=3).epochs(), 12)])
        first, second = rows[:6].ravel(), rows[6:].ravel()
        assert len(set(first)) == 48 and len(set(second)) == 48
        assert not np.array_equal(first, second)

    @pytest.mark.parametrize("impl", ["array", "grain"])
    def test_misaligned_start_and_oversized_batch_raise(self, impl):
        ours, theirs = LOADERS[impl]
        a = _images()
        for cls in (ours, theirs):
            with pytest.raises(ValueError, match="not a multiple of steps_per_call"):
                next(cls(a, 8, steps_per_call=3).epochs(4))
            with pytest.raises(ValueError, match="exceeds the shard"):
                cls(a, 51)
            with pytest.raises(ValueError, match="exceeds the shard"):
                cls(a, 18, shard_index=1, shard_count=3)

    def test_missing_grain_names_the_package(self, monkeypatch):
        """Where grain is not installed (the card's machine), --stream-impl
        grain raises with the package named; nothing carries on with the
        array loader."""
        import sys

        monkeypatch.setitem(sys.modules, "grain", None)
        monkeypatch.setitem(sys.modules, "grain.python", None)
        with pytest.raises(ModuleNotFoundError, match="'grain' package"):
            make_loader("grain", _images(), 8, 0, 1)
        with pytest.raises(ValueError, match="--stream-impl"):
            make_loader("tfds", _images(), 8, 0, 1)

    @pytest.mark.parametrize("k", [1, 3])
    def test_host_feed_on_the_cpu(self, k):
        """The feed's tensors are the loader's arrays, and each stack is
        its own (a kept stack is not written over)."""
        loader = ArrayLoader(_images(), 8, seed=1, steps_per_call=k)
        got = _take(HostFeed(loader, torch.device("cpu")).stream(3 * k), 5)
        for (index, batch), (wi, wb) in zip(got, _take(loader.epochs(3 * k), 5)):
            assert index.dtype == torch.int64 and batch.dtype == torch.uint8
            np.testing.assert_array_equal(index.numpy(), wi)
            np.testing.assert_array_equal(batch.numpy(), wb)


class TestConfig:
    def test_old_streaming_configs_streamed_through_grain(self):
        """lvae_tpu/config.py:451-456: a stored streaming config without
        stream_impl predates the array loader."""
        assert train_config_from_dict({"streaming": True}).stream_impl == "grain"
        assert train_config_from_dict({"streaming": True,
                                       "stream_impl": "array"}).stream_impl == "array"
        assert train_config_from_dict({"streaming": False}).stream_impl == "array"
        with pytest.raises(ValueError, match="--stream-impl"):
            TrainConfig(stream_impl="tfds")


TINY = ["--dataset", "synthetic", "--zdims", "3", "3", "--blocks-per-layer", "1",
        "--n-filters", "8", "--skip", "--gated", "--learn-top-prior", "--freebits", "0.5",
        "--beta-anneal", "4", "--batch-size", "32", "--test-batch-size", "64", "--seed", "5",
        "--dropout", "0.2", "--device", "cpu", "--streaming"]


def _train(out, *extra):
    from lvae_tpu_torch.main import main

    return main(TINY + ["--output-dir", str(out), "--log-interval", "3", "--test-interval",
                        "6", "--checkpoint-interval", "3", *extra])


def _equal_states(a, b):
    for k, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[k]), k
    for k in a.ema:
        assert torch.equal(a.ema[k], b.ema[k]), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("step", "exp_avg", "exp_inf"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.step == b.step


class TestRuns:
    @pytest.mark.parametrize("extra", [[], ["--steps-per-call", "3"], ["--grad-accum", "2"],
                                       ["--stream-impl", "grain"]],
                             ids=["k1", "k3", "accum2", "grain"])
    def test_resume_is_exact(self, tmp_path, capsys, extra):
        """Six streamed steps in one run equal three, then an
        --auto-resume to six (the loader fast-forwards to step 3), bit for
        bit; the resume under --grad-accum 2 lands inside an
        accumulation."""
        whole = _train(tmp_path / "a", "--run-name", "r", "--max-steps", "6", *extra)
        _train(tmp_path / "b", "--run-name", "r", "--max-steps", "3", *extra)
        resumed = _train(tmp_path / "b", "--run-name", "r", "--max-steps", "6",
                         "--auto-resume", *extra)
        text = capsys.readouterr().out
        assert "auto-resumed" in text and "streaming pipeline (" in text
        assert resumed.exp.train_data is None
        _equal_states(whole.state, resumed.state)

    def test_resume_adopts_the_stored_stream_impl(self, tmp_path, capsys):
        """A run begun under grain continues under grain when resumed
        with the default impl (lvae_tpu/train/trainer.py:411-441), and
        equals the uninterrupted grain run; config.json records it."""
        whole = _train(tmp_path / "a", "--run-name", "r", "--max-steps", "6",
                       "--stream-impl", "grain")
        _train(tmp_path / "b", "--run-name", "r", "--max-steps", "3", "--stream-impl", "grain")
        resumed = _train(tmp_path / "b", "--run-name", "r", "--max-steps", "6", "--auto-resume")
        assert "adopting --stream-impl grain" in capsys.readouterr().out
        assert resumed.cfg.stream_impl == "grain"
        with open(os.path.join(resumed.run_dir, "config.json")) as f:
            assert json.load(f)["stream_impl"] == "grain"
        _equal_states(whole.state, resumed.state)

    def test_misaligned_resume_raises(self, tmp_path):
        """A resume at step 4 under --steps-per-call 3 cannot land
        mid-stack: the loader raises, as lvae_tpu's does."""
        _train(tmp_path, "--run-name", "r", "--max-steps", "4")
        with pytest.raises(ValueError, match="not a multiple of steps_per_call"):
            _train(tmp_path, "--run-name", "r", "--max-steps", "6", "--auto-resume",
                   "--steps-per-call", "3")

    @pytest.mark.parametrize("k", [1, 3])
    def test_equals_the_resident_path_on_the_loaders_rows(self, tmp_path, k):
        """Six streamed steps (with the data-dependent init, read from the
        host) equal the device-resident path's train_step / MultiStep fed
        the loader's own rows, bit for bit."""
        from lvae_tpu_torch.config import config_from_args

        streamed = _train(tmp_path, "--max-steps", "6", "--dry-run", "--data-dep-init",
                          "--steps-per-call", str(k))
        cfg, _ = config_from_args(TINY + ["--max-steps", "6", "--data-dep-init",
                                          "--steps-per-call", str(k)])
        cfg.streaming = False
        exp = ttrainer.Experiment(cfg, torch.device("cpu"))
        assert isinstance(exp.train_data, DeviceDataset)
        state = exp.init_state()
        rows = ArrayLoader(exp.data.train, 32, seed=5, steps_per_call=k).indices(0)
        multi = MultiStep(state, exp.train_data.gather, exp.loss_cfg, k) if k > 1 else None
        for _ in range(6 // k):
            index = torch.from_numpy(next(rows))
            if multi is None:
                train_step(state, exp.train_data.gather(index[0]), index[0], exp.loss_cfg)
            else:
                multi(index)
        _equal_states(streamed.state, state)


class TestTrainerFeedsLvaeTpusBatches:
    """The batches that each trainer hands its step under --streaming on
    synthetic:96 (6 batches of 16 an epoch), seed 4, from ``start``: both
    steps replaced by recorders, as test_torch_graph_step.py does for the
    resident index stream."""

    @staticmethod
    def _lvae_tpu(monkeypatch, impl, k, start, calls):
        from lvae_tpu.config import ExperimentConfig
        from lvae_tpu.train.trainer import Experiment as JExperiment
        from lvae_tpu.train.trainer import Trainer as JTrainer

        seen = []

        def record(model, tx, cfg, steps_per_call=1, constrain_x=None):
            def step(state, batch):
                jax.debug.callback(lambda b: seen.append(np.asarray(b)), batch)
                return state.replace(step=state.step + steps_per_call), {}
            return step

        monkeypatch.setattr(jstreaming, "make_streaming_train_step", record)
        cfg = ExperimentConfig(dataset="synthetic:96", zdims=(2, 2), downsample=(1, 1),
                               blocks_per_layer=1, n_filters=4, batch_size=16,
                               test_batch_size=32, dropout=0.0, seed=4, steps_per_call=k,
                               streaming=True, stream_impl=impl, max_steps=start + k * calls,
                               log_interval=10 ** 6, test_interval=10 ** 6,
                               checkpoint_interval=10 ** 6, dry_run=True)
        exp = JExperiment(cfg)
        init = exp.init_state
        monkeypatch.setattr(exp, "init_state", lambda **kw: init(**kw).replace(
            step=jnp.asarray(start, jnp.int32)))
        JTrainer(exp).run()
        jax.effects_barrier()
        return seen

    @staticmethod
    def _port(monkeypatch, impl, k, start, calls):
        seen = []

        def record_step(state, batch, index, cfg):
            seen.append((index.numpy().copy(), batch.numpy().copy()))
            state.advance(1)

        class RecordMulti:
            def __init__(self, state, gather, cfg, k):
                assert gather is None       # host-fed
                self.state, self.k = state, k

            def __call__(self, index, batch=None):
                seen.append((index.numpy().copy(), batch.numpy().copy()))
                self.state.advance(self.k)

        monkeypatch.setattr(ttrainer, "train_step", record_step)
        monkeypatch.setattr(ttrainer, "MultiStep", RecordMulti)
        cfg = TrainConfig(dataset="synthetic:96", zdims=(2, 2), downsample=(1, 1),
                          blocks_per_layer=1, n_filters=4, batch_size=16, test_batch_size=32,
                          dropout=0.0, seed=4, steps_per_call=k, streaming=True,
                          stream_impl=impl, max_steps=start + k * calls, log_interval=10 ** 6,
                          test_interval=10 ** 6, checkpoint_interval=10 ** 6, dry_run=True)
        exp = ttrainer.Experiment(cfg, torch.device("cpu"))
        init = exp.init_state

        def at_start(**kw):
            state = init(**kw)
            state.step = start
            return state

        monkeypatch.setattr(exp, "init_state", at_start)
        ttrainer.Trainer(exp).run()
        return seen, exp.data.train

    @pytest.mark.parametrize("impl", ["array", "grain"])
    @pytest.mark.parametrize("k,start", [(1, 0), (3, 6)], ids=["k1", "k3-from-6"])
    def test_equal(self, monkeypatch, impl, k, start):
        want = self._lvae_tpu(monkeypatch, impl, k, start, 4)
        got, train = self._port(monkeypatch, impl, k, start, 4)
        assert len(want) == len(got) == 4
        for (index, batch), w in zip(got, want):
            assert batch.shape == ((16, 28, 28, 1) if k == 1 else (k, 16, 28, 28, 1))
            np.testing.assert_array_equal(batch, w)
            np.testing.assert_array_equal(train[index], batch)


@pytest.mark.parametrize("k", [1, 2])
def test_float64_streamed_steps_match_lvae_tpu(k):
    """Four float64 steps on the array loader's batches of test_torch_train's
    data (64 rows, batch 8, seed 3) with shared eps, free bits and a beta
    anneal, dropout 0: the port's train_step (k = 1) or host-fed MultiStep
    (k = 2, eps through a forward pre-hook) against lvae_tpu's
    make_batch_train_step on lvae_tpu's loader's batches: each step's
    loss (rtol 1e-7), and the parameters and BatchNorm statistics after
    the 4 steps (atol 1e-6)."""
    n_steps = 4
    jm, params, stats, batches, eps = _setup("bernoulli")
    data = np.concatenate(batches)
    jbatches = _take(jstreaming.ArrayLoader(data, B, seed=3).epochs(), n_steps)
    jcfg = JLossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
    tx = j_make_optimizer(LR)
    losses_j = []
    with jax.enable_x64():
        p64 = _to64(params)
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=p64,
                            batch_stats=_to64(stats), opt_state=tx.init(p64),
                            ema=jax.tree_util.tree_map(jnp.zeros_like, {
                                "elbo": 0.0, "ll": 0.0, "kl": 0.0, "loss": 0.0,
                                "kl_layers": jnp.zeros(2)}),
                            rng=jax.random.key(0))

        @jax.jit
        def jstep(state, batch, e):
            return make_batch_train_step(_ForcedEps(jm, e), tx, jcfg)(state, batch)

        for batch, e in zip(jbatches, eps):
            state, m = jstep(state, jnp.asarray(batch), [jnp.asarray(a) for a in e])
            losses_j.append(float(m["loss"]))
        params_j = flatten_dict(jax.device_get(state.params))
        stats_j = flatten_dict(jax.device_get(state.batch_stats))

    tm = LadderVAE(dropout_rate=0.0, **HEAD_CFG["bernoulli"][0])
    tm.load_state_dict(params_from_flax(params, stats), strict=True)
    tm = tm.double()
    tstate = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, LR),
                        ema=init_ema(2, "cpu"), seed=0)
    tcfg = LossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
    feed = HostFeed(ArrayLoader(data, B, seed=3, steps_per_call=k), torch.device("cpu"))
    forced = [[torch.from_numpy(a) for a in e] for e in eps]
    losses_t = []
    if k == 1:
        for s, (index, batch) in zip(range(n_steps), feed.stream()):
            m = train_step(tstate, batch, index, tcfg, forced_eps=forced[s])
            losses_t.append(float(m["loss"]))
    else:
        def give_eps(module, args, kwargs):
            return args, {**kwargs, "forced_eps": forced[tstate.step_t_at]}

        hook = tm.register_forward_pre_hook(give_eps, with_kwargs=True)
        multi = MultiStep(tstate, None, tcfg, k)
        try:
            for _, (index, batch) in zip(range(n_steps // k), feed.stream()):
                losses_t.append(float(multi(index, batch)["loss"]))
        finally:
            hook.remove()
        losses_j = losses_j[k - 1::k]
    assert tstate.step == n_steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-7, atol=0)
    sd = tm.state_dict()
    for tree in (params_j, stats_j):
        for path, a in tree.items():
            key = torch_key_for(path)
            want = params_from_flax({path[0]: _nest(path[1:], a)})[key]
            np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=0, atol=1e-6,
                                       err_msg=str(path))
