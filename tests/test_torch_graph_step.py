"""The port's step with every per-step key read from device memory, and
what runs it ``k`` steps a call (``--steps-per-call``), on the CPU:

- the keys on tensors (``mix_seed``, ``seed_words``, ``dropout_bytes``,
  ``keyed_uniform``, ``linear_anneal``) equal their int versions, words
  with the high bit set included;
- the step body driven by a 0-d step tensor equals the same body driven by
  a host int, bit for bit, with dropout under both implementations,
  binarisation, a beta anneal and clipping, unfused and under ``--fused
  all`` (on the CPU, the kernels' plain versions);
- the unfused bits8 dropout and the fused segment (K5's plain version)
  drop the same elements;
- ``MultiStep`` at k = 4 equals 8 single steps, and its float64 run holds
  ``lvae_tpu``'s train steps to ``TestTrainStepParity``'s tolerances;
- the trainer's ``[k, B]`` index stream equals ``lvae_tpu``'s at k = 3,
  across an epoch boundary and from a resume at a step that is not a
  multiple of k;
- SIGTERM leaves a final checkpoint, and ``--auto-resume`` finishes
  bit-equal to an uninterrupted run.

On the card the same step is captured into one CUDA graph of k steps;
``chip_smoke.py`` phase 17 holds the graph to the eager steps."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lvae_tpu_torch.data.device import DeviceDataset, preprocess_batch
from lvae_tpu_torch.kernels.segment import Key, _plain_bytes, dropout_bits8
from lvae_tpu_torch.models.blocks import Dropout, ResidualBlock
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.ops.math import bits8_keep_threshold, linear_anneal
from lvae_tpu_torch.ops.philox import (
    dropout_bytes,
    keyed_uniform,
    mix_seed,
    philox4x32,
    seed_words,
)
from lvae_tpu_torch.train import state as tstate
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.state import (
    Adamax,
    LossConfig,
    MultiStep,
    TrainState,
    init_ema,
    make_optimizer,
    train_body,
    train_step,
)
from lvae_tpu_torch.train.trainer import crossed, index_stream
from tests.test_torch_train import (
    B,
    FREE_BITS,
    HEAD_CFG,
    LR,
    N_STEPS,
    _nest,
    _setup,
    _trajectories,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
    gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(16, 16),
    data_size=(14, 14),
)
HIGH = [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 63, 2 ** 64 - 1, 0xDEADBEEFCAFEF00D, -1, -(2 ** 40)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _word(v: int) -> torch.Tensor:
    """The int64 tensor that holds the 64-bit word of ``v``."""
    v %= 2 ** 64
    return torch.tensor(v - 2 ** 64 if v >> 63 else v, dtype=torch.int64)


class TestKeysOnTheDevice:
    @pytest.mark.parametrize("words", [(42, 7, 3), (0, 0, 0), (2 ** 64 - 1, 2 ** 63, 1),
                                       (0xDEADBEEFCAFEF00D, -1, 2 ** 32 + 5), (5,),
                                       (2 ** 63 + 12345, 999_999, 2 ** 62, 77)])
    def test_mix_seed_tensor_equals_int(self, words):
        """Any word (or all of them) as a tensor gives the int version's
        bits, the high words included."""
        want = mix_seed(*words)
        for i in range(len(words)):
            got = mix_seed(*(_word(w) if j == i else w for j, w in enumerate(words)))
            assert got.dtype == torch.int64 and got.dim() == 0
            assert int(got) == want
        assert int(mix_seed(*(_word(w) for w in words))) == want

    def test_mix_seed_over_many_words(self, rng):
        """2,000 random (seed, step, site) with every bit pattern."""
        for _ in range(2000):
            w = [int(v) for v in rng.integers(0, 2 ** 63, 3, dtype=np.uint64)]
            w[int(rng.integers(3))] |= int(rng.integers(2)) << 63
            assert int(mix_seed(w[0], _word(w[1]), w[2])) == mix_seed(*w)

    @pytest.mark.parametrize("seed", HIGH)
    def test_seed_words(self, seed):
        k0, k1 = seed_words(_word(seed))
        assert (int(k0), int(k1)) == seed_words(seed)

    @pytest.mark.parametrize("step", [0, 7, 2 ** 31 + 3])
    def test_dropout_bytes(self, step):
        key = mix_seed(11, step, 4)
        want = dropout_bytes((3, 5, 7, 2), key)
        assert torch.equal(dropout_bytes((3, 5, 7, 2), mix_seed(11, _word(step), 4)), want)
        assert torch.equal(dropout_bytes((3, 5, 7, 2), _word(key)), want)

    def test_philox_with_tensor_keys(self):
        c = torch.arange(50, dtype=torch.int64)
        for seed in HIGH:
            a = philox4x32(c, 1, 2, 3, *seed_words(seed))
            b = philox4x32(c, 1, 2, 3, *seed_words(_word(seed)))
            assert all(torch.equal(x, y) for x, y in zip(a, b))

    @pytest.mark.parametrize("step", [0, 3, 2 ** 32 + 9])
    def test_keyed_uniform(self, step):
        index = torch.arange(100, 106)
        want = keyed_uniform((6, 4, 4, 1), 5, index, step, 0x80000001)
        assert torch.equal(keyed_uniform((6, 4, 4, 1), 5, index, _word(step), 0x80000001), want)
        key = mix_seed(5, step, 1)
        assert torch.equal(keyed_uniform((6, 4, 4, 1), _word(key), index, 0, 9),
                           keyed_uniform((6, 4, 4, 1), key, index, 0, 9))

    @pytest.mark.parametrize("mode", ["binarize", "dequantize"])
    def test_preprocess_batch(self, rng, mode):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(8, 6, 6, 1), dtype=np.uint8))
        index = torch.arange(40, 48)
        for step in (0, 5):
            assert torch.equal(preprocess_batch(u8, mode, 3, index, _word(step)),
                               preprocess_batch(u8, mode, 3, index, step))

    @pytest.mark.parametrize("n", [0, 1, 4, 7, 300])
    def test_linear_anneal(self, n):
        """The tensor beta equals the float one (fp32 division, clipped)."""
        for step in range(0, 12):
            got = linear_anneal(_word(step), 0.0, 1.0, n)
            assert float(got) == linear_anneal(step, 0.0, 1.0, n)
            got = linear_anneal(_word(step), 0.25, 0.75, n)
            assert float(got) == linear_anneal(step, 0.25, 0.75, n)


class TestSharedMasks:
    @pytest.mark.parametrize("site", [0, 3])
    def test_unfused_bits8_mask_is_the_segments(self, site):
        """Dropout(bits8) keeps exactly the elements whose K5 bytes (its
        plain version's, under the same seed, step and site) are below t."""
        d = Dropout(0.2)
        d.site, d.key.seed, d.key.step = site, 9, _word(4)
        x = torch.ones(4, 8, 6, 6)
        t = bits8_keep_threshold(0.2)
        seg = _plain_bytes(x, t, Key(9, _word(4), site))
        assert torch.equal(d(x, train=True) != 0, seg < t)
        assert torch.equal(seg, dropout_bytes(x.shape, mix_seed(9, 4, site)))

    def test_dropout_bits8_gradient_is_the_same_mask(self):
        """The unfused dropout's gradient (plain version on the CPU) is the
        cotangent dropped by the same bytes: what the CUDA kernel's
        backward, the same kernel on the cotangent, computes."""
        x = torch.randn(2, 4, 5, 5, requires_grad=True)
        g = torch.randn(2, 4, 5, 5)
        dropout_bits8(x, 0.3, 5, _word(9), 2).backward(g)
        t = bits8_keep_threshold(0.3)
        kept = dropout_bytes(x.shape, mix_seed(5, 9, 2)) < t
        assert torch.equal(x.grad, torch.where(kept, g * np.float32(256 / t), 0.0))

    def test_fused_and_unfused_blocks_agree_with_dropout(self):
        """A train-mode residual block with dropout 0.2: the fused segments
        (plain versions) and the unfused ops drop the same elements, so
        the outputs agree to float32 roundoff (the statistics differ in
        summation order)."""
        torch.manual_seed(0)
        x = torch.randn(4, 8, 6, 6)
        out = []
        for fused in (False, True):
            blk = ResidualBlock(8, "bacdbacd", dropout_rate=0.2, fused_segments=fused)
            with torch.no_grad():
                for p in blk.parameters():
                    p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
            for m in blk.modules():
                if isinstance(m, Dropout):
                    m.key.seed, m.key.step = 3, _word(2)
            out.append(blk(x, train=True))
        np.testing.assert_allclose(out[0].detach().numpy(), out[1].detach().numpy(),
                                   rtol=1e-4, atol=1e-4)


def _state(fused, impl, seed=7):
    tm = LadderVAE(color_ch=1, dropout_rate=0.2, dropout_impl=impl, fused_stochastic=fused,
                   fused_segments=fused, generator=torch.Generator().manual_seed(seed), **CFG)
    with torch.no_grad():      # move the BatchNorm affines off their start
        for name, p in tm.named_parameters():
            if "BatchNorm" in name:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(5)) * 0.1)
    return TrainState(step=0, model=tm, optimizer=make_optimizer(tm, 3e-3), ema=init_ema(2, "cpu"),
                      seed=4)


def _batches(n, b=8):
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, 256, size=(n * b, 14, 14, 1), dtype=np.uint8))


def _equal_states(a, b):
    for k, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[k]), k
    for k in a.ema:
        assert torch.equal(a.ema[k], b.ema[k]), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k in ("step", "exp_avg", "exp_inf"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.step == b.step


LOSS = LossConfig(free_bits=FREE_BITS, beta_anneal_steps=5, preprocess="binarize",
                  ema_decay=0.9, max_grad_norm=6.0)


class TestStepBody:
    @pytest.mark.parametrize("fused,impl", [(False, "bits8"), (False, "float"),
                                            (True, "bits8")],
                             ids=["none-bits8", "none-float", "all-bits8"])
    def test_tensor_step_equals_int_step(self, monkeypatch, fused, impl):
        """8 steps of the body driven by a 0-d step tensor (train_step: the
        state's device step) against the same body driven by a host int:
        parameters, BatchNorm statistics, EMA and Adamax state bit-equal,
        with dropout 0.2, binarisation, a beta anneal over 5 steps and a
        global-norm clip that binds at some steps and not at others."""
        norms = []
        clip = tstate.clip_by_global_norm_
        monkeypatch.setattr(tstate, "clip_by_global_norm_",
                            lambda g, m: norms.append(float(clip(g, m))))
        data = _batches(N_STEPS)
        a, b = _state(fused, impl), _state(fused, impl)
        for i in range(N_STEPS):
            index = torch.arange(i * 8, (i + 1) * 8)
            train_step(a, data[index], index, LOSS)
            train_body(b, data[index], index, LOSS, i)
            b.step += 1
        assert a.step_t.dtype == torch.int64 and int(a.step_t) == N_STEPS
        _equal_states(a, b)
        assert max(norms) > LOSS.max_grad_norm > min(norms)

    @pytest.mark.parametrize("fused,impl", [(False, "bits8"), (False, "float"),
                                            (True, "bits8")],
                             ids=["none-bits8", "none-float", "all-bits8"])
    def test_body_makes_no_tensor_from_host_data_on_a_device(self, monkeypatch, fused, impl):
        """On the card ``torch.tensor(data, device=d)`` copies from pageable
        host memory, which a CUDA graph cannot capture: the body at a device
        step builds no tensor from host data on a named device. (The plain
        latent draw built 2 pi so, and ``--steps-per-call k`` with the
        sample+KL kernels off, ``--fused none|segments|mixture``, failed at
        the capture on the card.)"""
        made = []
        for name in ("tensor", "as_tensor"):
            def spy(*args, _make=getattr(torch, name), _name=name, **kw):
                if kw.get("device") is not None and not isinstance(args[0], torch.Tensor):
                    made.append(_name)
                return _make(*args, **kw)
            monkeypatch.setattr(torch, name, spy)
        s = _state(fused, impl)
        train_body(s, _batches(1), torch.arange(8), LOSS, s.device_step())
        assert made == []

    def test_masks_move_with_the_device_step(self):
        """The same body at two values of the device step draws other
        masks; at the same value the same."""
        data = _batches(1)
        index = torch.arange(8)
        outs = []
        for step in (3, 3, 4):
            s = _state(False, "bits8")
            s.step = step
            outs.append(train_body(s, data, index, LOSS, s.device_step())["loss"])
        assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])

    def test_ema_starts_at_step_zero(self):
        """The EMA takes the first step's metrics as they are, then moves
        with the decay, in place (its tensors keep their addresses)."""
        s = _state(False, "bits8")
        ptrs = {k: v.data_ptr() for k, v in s.ema.items()}
        data = _batches(2)
        m0 = train_step(s, data[:8], torch.arange(8), LOSS)
        assert all(torch.equal(s.ema[k], m0[k].float()) for k in m0)
        e0 = {k: v.clone() for k, v in s.ema.items()}
        m1 = train_step(s, data[8:], torch.arange(8, 16), LOSS)
        for k in m1:
            assert torch.equal(s.ema[k], 0.9 * e0[k] + (1.0 - 0.9) * m1[k].float())
        assert ptrs == {k: v.data_ptr() for k, v in s.ema.items()}

    def test_device_step_follows_a_restore(self):
        """A step count set on the host (as a restore sets it) is written to
        the same device tensor before the next step reads it."""
        s = _state(False, "bits8")
        t = s.device_step()
        train_step(s, _batches(1), torch.arange(8), LOSS)
        assert int(t) == 1 and s.step == 1
        s.step = 40
        assert s.device_step() is t and int(t) == 40


class TestMultiStep:
    @pytest.mark.parametrize("fused", [False, True], ids=["none", "all"])
    def test_k4_equals_8_single_steps(self, fused):
        data = DeviceDataset(_batches(N_STEPS).numpy(), torch.device("cpu"))
        index = torch.arange(N_STEPS * 8).view(N_STEPS, 8)
        a, b = _state(fused, "bits8"), _state(fused, "bits8")
        multi = MultiStep(a, data.gather, LOSS, 4)
        last = [multi(index[:4]), multi(index[4:])][-1]
        for row in index:
            m = train_step(b, data.gather(row), row, LOSS)
        _equal_states(a, b)
        assert all(torch.equal(last[k], m[k]) for k in m)

    def test_rejects_bad_shapes(self):
        s = _state(False, "bits8")
        with pytest.raises(ValueError, match="k >= 2"):
            MultiStep(s, lambda i: i, LOSS, 1)
        with pytest.raises(ValueError, match=r"\[3, B\]"):
            MultiStep(s, lambda i: i, LOSS, 3)(torch.zeros(2, 8, dtype=torch.int64))

    @pytest.mark.parametrize("k", [2, 4])
    def test_float64_runner_matches_lvae_tpu(self, k):
        """The k-step runner in float64 with the latent draw given (the
        same eps as lvae_tpu's, through a forward pre-hook), dropout 0,
        free bits and a beta anneal, against lvae_tpu's
        make_batch_train_step run step by step: each call's last loss
        (rtol 1e-7) and the parameters and BatchNorm statistics after
        every call (atol 1e-6), TestTrainStepParity's tolerances."""
        jm, params, stats, batches, eps = _setup("bernoulli")
        out_j, _ = _trajectories("bernoulli")
        tm = LadderVAE(dropout_rate=0.0, **HEAD_CFG["bernoulli"][0])
        tm.load_state_dict(params_from_flax(params, stats), strict=True)
        tm = tm.double()
        state = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, LR),
                           ema=init_ema(2, "cpu"), seed=0)
        feed = [[torch.from_numpy(a) for a in e] for e in eps]

        def give_eps(module, args, kwargs):
            return args, {**kwargs, "forced_eps": feed[state.step_t_at]}

        hook = tm.register_forward_pre_hook(give_eps, with_kwargs=True)
        data = torch.from_numpy(np.concatenate(batches))
        multi = MultiStep(state, lambda idx: data[idx], LossConfig(
            free_bits=FREE_BITS, beta_anneal_steps=4, preprocess="none"), k)
        try:
            for call in range(N_STEPS // k):
                index = torch.arange(call * k * B, (call + 1) * k * B).view(k, B)
                m = multi(index)
                loss_j, params_j, stats_j = out_j[(call + 1) * k - 1]
                np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-7, atol=0)
                sd = tm.state_dict()
                for tree in (params_j, stats_j):
                    for path, a in tree.items():
                        key = torch_key_for(path)
                        want = params_from_flax({path[0]: _nest(path[1:], a)})[key]
                        np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=0,
                                                   atol=1e-6, err_msg=str(path))
        finally:
            hook.remove()
        assert state.step == N_STEPS


class TestAdamax:
    def test_near_torch_adamax_and_loads_its_state(self):
        """The capturable Adamax follows torch.optim.Adamax (float64, 6
        steps) to 1e-6 of lr a step: its bias correction 1 - b1^t is taken
        in float32, as torch's capturable form takes it (~3e-7 of the
        update at t = 1), where torch's default form takes it in float64
        on the host. It loads a state dict that torch's wrote."""
        g = torch.Generator().manual_seed(0)
        w0 = torch.randn(5, 3, generator=g, dtype=torch.float64)
        grads = [torch.randn(5, 3, generator=g, dtype=torch.float64) for _ in range(6)]
        ours, ref = w0.clone().requires_grad_(), w0.clone().requires_grad_()
        o1 = Adamax([ours], lr=3e-3)
        o2 = torch.optim.Adamax([ref], lr=3e-3, betas=(0.9, 0.999), eps=1e-8)
        for gr in grads:
            for p, o in ((ours, o1), (ref, o2)):
                p.grad = gr.clone()
                o.step()
        np.testing.assert_allclose(ours.detach().numpy(), ref.detach().numpy(), rtol=0,
                                   atol=len(grads) * 3e-3 * 1e-6)
        o3 = Adamax([w0.clone().requires_grad_()], lr=3e-3)
        o3.load_state_dict(o2.state_dict())
        st = o3.state[o3.param_groups[0]["params"][0]]
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 6.0
        assert torch.equal(st["exp_inf"], o2.state[ref]["exp_inf"])


class TestIndexStream:
    @staticmethod
    def _lvae_tpu_stacks(monkeypatch, start, calls):
        """The [3, 16] index stacks that lvae_tpu's Trainer hands its
        3-step program on synthetic:96 (6 steps an epoch), seed 4, from
        ``start``: its program replaced by one that records them."""
        import lvae_tpu.train.state as jstate
        from lvae_tpu.config import ExperimentConfig
        from lvae_tpu.train.trainer import Experiment as JExperiment
        from lvae_tpu.train.trainer import Trainer as JTrainer

        seen = []

        def record(model, tx, cfg, k, constrain_x=None):
            def multi(state, data, idx):
                jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx)
                return state.replace(step=state.step + k), {}
            return multi

        monkeypatch.setattr(jstate, "make_multi_train_step", record)
        cfg = ExperimentConfig(dataset="synthetic:96", zdims=(2, 2), downsample=(1, 1),
                               blocks_per_layer=1, n_filters=4, batch_size=16,
                               test_batch_size=32, dropout=0.0, seed=4, steps_per_call=3,
                               max_steps=start + 3 * calls, log_interval=10 ** 6,
                               test_interval=10 ** 6, checkpoint_interval=10 ** 6,
                               dry_run=True)
        exp = JExperiment(cfg)
        init = exp.init_state
        monkeypatch.setattr(exp, "init_state", lambda **kw: init(**kw).replace(
            step=jnp.asarray(start, jnp.int32)))
        JTrainer(exp).run()
        jax.effects_barrier()
        return seen

    @pytest.mark.parametrize("start", [0, 4], ids=["from-0", "resumed-at-4"])
    def test_equals_lvae_tpu_at_k3(self, monkeypatch, start):
        """Four 3-step stacks from ``start``: across the epoch boundary at
        step 6 (and 12), and from a resume at step 4, not a multiple of 3;
        the port's stacks are lvae_tpu's."""
        from lvae_tpu_torch.data.registry import load_dataset

        want = self._lvae_tpu_stacks(monkeypatch, start, 4)
        data = DeviceDataset(load_dataset("synthetic:96", "").train, torch.device("cpu"))
        stream = index_stream(data, 16, 4, start, 3)
        got = [next(stream).numpy() for _ in range(4)]
        assert len(want) == 4
        for g, w in zip(got, want):
            assert g.shape == (3, 16)
            np.testing.assert_array_equal(g, w)

    def test_resume_continues_the_sequence(self):
        """At k = 3 from step 4 the rows are the k = 1 stream's from step 4
        on, whatever the grouping."""
        from lvae_tpu_torch.data.registry import load_dataset

        data = DeviceDataset(load_dataset("synthetic:96", "").train, torch.device("cpu"))
        ones = index_stream(data, 16, 4, 0)
        rows = [next(ones) for _ in range(16)]
        stacked = index_stream(data, 16, 4, 4, 3)
        got = torch.cat([next(stacked) for _ in range(4)])
        assert torch.equal(got, torch.stack(rows[4:16]))

    @pytest.mark.parametrize("k", [1, 3, 4])
    def test_crossed(self, k):
        """A hook fires at every call that passes a multiple of its
        interval, as lvae_tpu's crossed (trainer.py:596-597)."""
        fired = [s for s in range(k, 61, k) if crossed(s, 10, k)]
        assert fired == [s for s in range(k, 61, k) if (s // 10) > ((s - k) // 10)]
        assert len(fired) == 6


_CHILD = """
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from lvae_tpu_torch.main import main
main({args!r})
"""

TINY = ["--dataset", "synthetic", "--zdims", "3", "3", "--blocks-per-layer", "1",
        "--n-filters", "8", "--skip", "--gated", "--learn-top-prior", "--freebits", "0.5",
        "--beta-anneal", "4", "--batch-size", "32", "--test-batch-size", "64", "--seed", "5",
        "--dropout", "0.2", "--steps-per-call", "2", "--log-interval", "2",
        "--test-interval", "1000000", "--checkpoint-interval", "1000000",
        "--run-name", "term", "--device", "cpu"]


class TestSigterm:
    def test_final_checkpoint_and_exact_resume(self, tmp_path):
        """SIGTERM during a --steps-per-call 2 run: it stops at a 2-step
        boundary and saves a final checkpoint there; --auto-resume to S + 4
        equals an uninterrupted run to S + 4, bit for bit (parameters,
        BatchNorm statistics, EMA, Adamax state, step)."""
        from lvae_tpu_torch.main import main

        out = str(tmp_path / "a")
        child = subprocess.Popen(
            [sys.executable, "-u", "-c", _CHILD.format(
                repo=REPO, args=TINY + ["--max-steps", "1000000", "--output-dir", out])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        lines = []
        deadline = time.monotonic() + 240
        try:
            for line in child.stdout:
                lines.append(line)
                if line.startswith("[train] step       4"):
                    child.send_signal(signal.SIGTERM)
                    break
                assert time.monotonic() < deadline, "".join(lines)
            rest, _ = child.communicate(timeout=120)
        finally:
            if child.poll() is None:
                child.kill()
        text = "".join(lines) + rest
        assert child.returncode == 0, text
        assert "interrupted: saving a final checkpoint" in text
        ckpts = sorted(os.listdir(os.path.join(out, "term", "checkpoints")))
        assert len(ckpts) == 1, ckpts
        stop = int(ckpts[0][5:13])
        assert stop >= 4 and stop % 2 == 0
        n = stop + 4
        resumed = main(TINY + ["--max-steps", str(n), "--output-dir", out, "--auto-resume"])
        whole = main(TINY + ["--max-steps", str(n), "--output-dir", str(tmp_path / "b")])
        a, b = resumed.state, whole.state
        assert a.step == b.step == n
        _equal_states(a, b)

    def test_interrupt_inside_a_step_saves_nothing(self, tmp_path, monkeypatch, capsys):
        """A KeyboardInterrupt that lands inside a step (whose updates are
        in place) leaves no final checkpoint of a torn state: the last
        periodic one stands."""
        from lvae_tpu_torch.main import main
        from lvae_tpu_torch.train import trainer as ttrainer

        real = ttrainer.train_step

        def step(state, *a, **kw):
            if state.step == 5:
                raise KeyboardInterrupt
            return real(state, *a, **kw)

        monkeypatch.setattr(ttrainer, "train_step", step)
        args = list(TINY)
        args[args.index("--steps-per-call") + 1] = "1"
        args[args.index("--checkpoint-interval") + 1] = "2"
        tr = main(args + ["--max-steps", "10", "--output-dir", str(tmp_path)])
        assert "interrupted inside a step" in capsys.readouterr().out
        assert tr.state.step == 5
        ckpts = sorted(os.listdir(os.path.join(tr.run_dir, "checkpoints")))
        assert ckpts == ["ckpt_00000002.pt", "ckpt_00000004.pt"]
