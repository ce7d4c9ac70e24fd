"""The port's training slice on the CPU, held against ``lvae_tpu``: the
train step in float64 (1 and 8 Adamax steps, free bits and a beta
anneal, BatchNorm running statistics), optax's global-norm clip and
data-dependent init. The CLI, dropout and training preprocessing are in
``test_torch_cli.py``.

Inputs and latent noise come from numpy (``forced_eps``) and go to both
packages; dropout is 0 where the two are compared, since the port keys its
masks with its own generator."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from lvae_tpu.models.lvae import LadderVAE as JaxLVAE
from lvae_tpu.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu.train.init import data_dependent_init as j_data_dependent_init
from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.models.blocks import ResidualBlock
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.ops.math import linear_anneal
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.init import data_dependent_init
from lvae_tpu_torch.train.state import (
    LossConfig,
    TrainState,
    clip_by_global_norm_,
    init_ema,
    make_optimizer,
    train_step,
)

CFG = dict(
    z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
    gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(16, 16),
    data_size=(14, 14),
)
MIX = "discretized_logistic_mix"
# per head: (model kwargs of both packages, the batch's NHWC shape)
HEAD_CFG = {
    "bernoulli": (dict(color_ch=1, **CFG), (14, 14, 1)),
    MIX: (dict(color_ch=3, likelihood=MIX, **dict(CFG, data_size=(16, 16))), (16, 16, 3)),
}
B = 8
N_STEPS = 8
MIX_STEPS = 3         # the mixture head's run
LR = 3e-3             # tests/test_parity.py::TestTrajectoryParity's
FREE_BITS, ANNEAL = 0.5, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny eager ops: one intra-op thread keeps them fast when the tier
    runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_forward(m, x, eps, train):
    """LadderVAE.__call__'s loss terms with the latent draw replaced by
    ``eps``."""
    td, info = m.topdown_pass(m.bottomup_pass(pad_img_tensor(x, m.img_size), train=train),
                              train=train, forced_eps=eps)
    ll, _ = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
    return {"ll": ll.sum(axis=(1, 2, 3)),
            "kl_sep": jnp.stack([k.sum(axis=(1, 2, 3)) for k in info["kl_elementwise"]])}


@dataclasses.dataclass
class _ForcedEps:
    """``lvae_tpu``'s model with the latent noise given: what
    ``make_batch_train_step`` and ``data_dependent_init`` call is
    ``apply``."""

    model: JaxLVAE
    eps: list

    def apply(self, variables, x, train=False, **kw):
        # the input in the parameters' dtype (float64 in the parity runs;
        # lvae_tpu's own train step hands the model float32)
        x = x.astype(jax.tree_util.tree_leaves(variables["params"])[0].dtype)
        return self.model.apply(variables, x, self.eps, train, method=_jax_forward, **kw)


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


_HEADS = ("conv_in_p", "conv_in_q", "param_conv")


@functools.lru_cache(maxsize=None)
def _setup(head="bernoulli", fused_segments=False):
    """The JAX model, float32 variables drawn with numpy at flax's init
    scales (lecun-normal convs, normal(1e-2) Gaussian and likelihood
    heads) and moved off them, the batches and the per-step eps. The
    Bernoulli batches are binary uint8; the mixture head's are pixels on
    the 256-level grid in [0, 1] (both packages' 'none' preprocessing
    casts them to float32)."""
    rng = np.random.default_rng(21)
    kw, xshape = HEAD_CFG[head]
    n_steps = N_STEPS if head == "bernoulli" else MIX_STEPS
    jm = JaxLVAE(dropout_rate=0.0, fused_segments=fused_segments, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(3), "sample": jax.random.key(4)},
        jnp.zeros((B, *xshape)), train=True))

    def draw(path, shape):
        name = path[-1]
        if name == "kernel":
            std = 1e-2 if any(h in path for h in _HEADS) else 1 / np.sqrt(np.prod(shape[:-1]))
            a = rng.normal(size=shape) * std
        else:
            a = np.ones(shape) if name == "scale" else np.zeros(shape)
        # the top layer's posterior head and prior keep their start, so its
        # KL stays below the free bits (clamped) while the bottom layer's
        # is above
        if not ("top_prior" in path or ("top_down_layers_1" in path and "conv_in_q" in path)):
            a = a + rng.normal(size=shape) * 0.1
        return a.astype(np.float32)

    params = unflatten_dict({k: draw(k, v.shape)
                             for k, v in flatten_dict(shapes["params"]).items()})
    stats = unflatten_dict({k: (np.zeros if k[-1] == "mean" else np.ones)(v.shape, np.float32)
                            for k, v in flatten_dict(shapes["batch_stats"]).items()})
    if head == "bernoulli":
        batches = [(rng.uniform(size=(B, *xshape)) < 0.4).astype(np.uint8)
                   for _ in range(n_steps)]
    else:
        batches = [(rng.integers(0, 256, size=(B, *xshape)) / 255.0).astype(np.float32)
                   for _ in range(n_steps)]
    shapes = [(B, 4, 4, 3), (B, 2, 2, 3)]
    eps = [[rng.normal(size=s) for s in shapes] for _ in range(n_steps)]
    return jm, params, stats, batches, eps


@functools.lru_cache(maxsize=None)
def _trajectories(head="bernoulli", fused_all=False):
    """Per step: (loss, params, batch_stats) of lvae_tpu's
    make_batch_train_step and of the port's train_step, float64, with
    free bits and a beta anneal and the same eps. The port's mixture head
    runs K3's switch (on the CPU: the plain forward and the hand-written
    backward); lvae_tpu's takes jax.grad of its oracle. ``fused_all``:
    the port's --fused all switches (the sample+KL kernels and the
    segments K5) against lvae_tpu's fused_segments=True."""
    jm, params, stats, batches, eps = _setup(head, fused_all)
    jcfg = JLossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
    tx = j_make_optimizer(LR)
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

        for batch, e in zip(batches, eps):
            state, m = step(state, jnp.asarray(batch), [jnp.asarray(a) for a in e])
            out_j.append((float(m["loss"]), flatten_dict(jax.device_get(state.params)),
                          flatten_dict(jax.device_get(state.batch_stats))))

    tm = LadderVAE(dropout_rate=0.0, fused_mixture=head == MIX, fused_stochastic=fused_all,
                   fused_segments=fused_all, **HEAD_CFG[head][0])
    tm.load_state_dict(params_from_flax(params, stats), strict=True)
    tm = tm.double()
    tstate = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, LR),
                        ema=init_ema(2, "cpu"), seed=0)
    tcfg = LossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
    out_t = []
    for i, (batch, e) in enumerate(zip(batches, eps)):
        m = train_step(tstate, torch.from_numpy(batch), torch.arange(B) + i * B, tcfg,
                       forced_eps=[torch.from_numpy(a) for a in e])
        out_t.append((float(m["loss"]), {k: v.clone() for k, v in tm.state_dict().items()}))
    return out_j, out_t


def _bn_fed(model):
    """The state_dict keys of each conv bias whose output only a BatchNorm
    reads (in a residual block, a conv whose next letter of the block type
    other than dropout's is a BatchNorm), and of that BatchNorm's running
    mean, which follows the bias."""
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


class TestTrainStepParity:
    """Tolerances of TestTrajectoryParity (losses rtol 1e-7, parameters
    atol 1e-6); running_var at atol 1e-6: biased on both sides."""

    @pytest.mark.parametrize("steps", [1, N_STEPS])
    def test_matches_lvae_tpu(self, steps):
        self.check(steps)

    @pytest.mark.parametrize("steps", [1, MIX_STEPS])
    def test_mixture_head_matches_lvae_tpu(self, steps):
        """The same parity with the discretized-logistic-mixture head
        (16x16 RGB) and its hand-written backward."""
        self.check(steps, MIX)

    @pytest.mark.parametrize("steps", [1, N_STEPS])
    def test_fused_all_matches_lvae_tpu(self, steps):
        """--fused all (the sample+KL kernels and the fused segments, whose
        plain versions compute in fp32 inside the float64 step, as
        lvae_tpu's segments do) against lvae_tpu's fused_segments=True.
        Losses and every other parameter and statistic hold the tolerances
        above (measured over the 8 steps: losses 2.3e-8 relative,
        parameters 4.3e-7). The conv biases that only a BatchNorm reads
        have a true gradient of 0; the fp32 segments leave them a roundoff
        gradient of ~1e-7, above Adamax's eps of 1e-8, so each package
        moves them by up to lr per step in a direction the roundoff picks
        (measured 5.8e-3 after 1 step, 2.0e-2 after 8), and the running
        mean of the BatchNorm that reads them follows (7.4e-3 after 8).
        Those are held to Adamax's bound instead, 2 lr per step."""
        self.check(steps, fused_all=True)

    @staticmethod
    def check(steps, head="bernoulli", fused_all=False):
        out_j, out_t = _trajectories(head, fused_all)
        np.testing.assert_allclose([t[0] for t in out_t[:steps]],
                                   [j[0] for j in out_j[:steps]], rtol=1e-7, atol=0)
        _, params_j, stats_j = out_j[steps - 1]
        sd = out_t[steps - 1][1]
        roundoff_led = _bn_fed(LadderVAE(**HEAD_CFG[head][0])) if fused_all else set()
        for tree in (params_j, stats_j):
            for path, a in tree.items():
                key = torch_key_for(path)
                want = params_from_flax({path[0]: _nest(path[1:], a)})[key]
                atol = 2 * LR * steps if key in roundoff_led else 1e-6
                np.testing.assert_allclose(sd[key].numpy(), want.numpy(),
                                           rtol=0, atol=atol, err_msg=str(path))
        _, params0, _, _, _ = _setup(head, fused_all)
        moved = max(np.abs(np.asarray(a) - np.asarray(flatten_dict(params0)[k])).max()
                    for k, a in params_j.items())
        assert moved > 1e-3

    def test_free_bits_and_anneal_bind(self):
        """The run exercises both sides of the free-bits clamp and a beta
        below 1 (else the parity above would not see them)."""
        jm, params, stats, batches, eps = _setup()
        tm = LadderVAE(color_ch=1, dropout_rate=0.0, **CFG)
        tm.load_state_dict(params_from_flax(params, stats), strict=True)
        x = torch.from_numpy(batches[0]).float()
        out = tm(x, forced_eps=[torch.from_numpy(a).float() for a in eps[0]], train=True)
        kl = out["kl_sep"].mean(dim=1)
        assert kl.min() < FREE_BITS < kl.max(), kl
        assert linear_anneal(1, 0.0, 1.0, ANNEAL) == np.float32(0.25)


def _nest(path, leaf):
    return leaf if not path else {path[0]: _nest(path[1:], leaf)}


class TestClip:
    @pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
    def test_equals_optax(self, rng, max_norm):
        tree = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
        tx = optax.clip_by_global_norm(max_norm)
        ref, _ = tx.update([jnp.asarray(a) for a in tree], tx.init(tree))
        got = [torch.from_numpy(a.copy()) for a in tree]
        clip_by_global_norm_(got, max_norm)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


class TestDataDependentInit:
    def test_matches_lvae_tpu(self):
        """Every parameter after the init equals lvae_tpu's on the same
        batch and eps, dropout 0 (float64, within 1e-5)."""
        jm, params, stats, batches, eps = _setup()
        x = batches[0].astype(np.float64)
        with jax.enable_x64():
            v = {"params": _to64(params), "batch_stats": _to64(stats)}
            out = j_data_dependent_init(_ForcedEps(jm, [jnp.asarray(a) for a in eps[0]]),
                                        v, jnp.asarray(x), {"sample": jax.random.key(0)})
            want = params_from_flax(jax.device_get(out["params"]), stats)
        tm = LadderVAE(color_ch=1, dropout_rate=0.0, **CFG)
        tm.load_state_dict(params_from_flax(params, stats), strict=True)
        tm = tm.double()
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        data_dependent_init(tm, torch.from_numpy(x), None,
                            forced_eps=[torch.from_numpy(a) for a in eps[0]])
        changed = 0
        for k, t in tm.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[k].double().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            changed += not torch.equal(t, before[k])
        # the convs moved; the excluded heads and the BN statistics did not
        assert changed > 10
        for k in before:
            if any(s in k for s in ("conv_in_p", "conv_in_q", "param_conv", "running_")):
                assert torch.equal(tm.state_dict()[k], before[k]), k
