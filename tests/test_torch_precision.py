"""``--precision bf16`` in the port, on the CPU, held against ``lvae_tpu``
at ``dtype=bfloat16``: bf16 convolutions from fp32 parameters, with
BatchNorm, the segments, the latents, the likelihood, the loss and the
optimiser in fp32.

Both packages get the same fp32 weights (``params_from_flax``), the same
batches and the same latent noise (``forced_eps``), all drawn with numpy;
dropout is 0 where the two are compared, and ``lvae_tpu``'s forward and
train step are compiled without XLA's excess precision (``_exact``). The models are small (16x16, z
(4, 4), 8 filters, one block a layer), the Bernoulli head on 14x14 binary
images and the mixture head on 16x16 RGB. The kernels' plain bf16
versions are held to ``lvae_tpu``'s Pallas kernels in interpret mode, as
``tests/test_torch_segment.py`` and ``tests/test_torch_likelihoods.py``
hold the fp32 ones."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from lvae_tpu.kernels.mixture_pallas import fused_mix_log_prob as j_mix
from lvae_tpu.kernels.segment_pallas import fused_dropout_bn_act as j_segment
from lvae_tpu.models.lvae import LadderVAE as JaxLVAE
from lvae_tpu.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.kernels import mixture as km
from lvae_tpu_torch.kernels.segment import dropout_bits8, dropout_bn_act, dropout_bn_act_backward
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.ops.math import bits8_keep_threshold, segment_backward, segment_forward
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.state import LossConfig, TrainState, init_ema, make_optimizer, train_step
from tests.test_torch_segment import SHAPE, _inputs, _jax_bits

BF16 = torch.bfloat16
CFG = dict(z_dims=(4, 4), blocks_per_layer=1, n_filters=8, stochastic_skip=True, gated=True,
           downsample=(1, 1), learn_top_prior=True, img_size=(16, 16))
MIX = "discretized_logistic_mix"
HEADS = {  # model kwargs of both packages, the batch's NHWC shape
    "bernoulli": (dict(color_ch=1, data_size=(14, 14), **CFG), (14, 14, 1)),
    MIX: (dict(color_ch=3, likelihood=MIX, data_size=(16, 16), **CFG), (16, 16, 3)),
}
B = 8
STEPS = 3
LR = 3e-3
FREE_BITS = 0.5
HEAD_INIT = ("conv_in_p", "conv_in_q", "param_conv")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_forward(m, x, eps, train):
    """``LadderVAE.__call__``'s outputs with the latent draw given."""
    td, info = m.topdown_pass(m.bottomup_pass(pad_img_tensor(x, m.img_size), train=train),
                              train=train, forced_eps=eps)
    ll, _ = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
    return {"ll": ll.sum(axis=(1, 2, 3)),
            "kl_sep": jnp.stack([k.sum(axis=(1, 2, 3)) for k in info["kl_elementwise"]])}


@functools.lru_cache(maxsize=None)
def _setup(head):
    """fp32 weights at flax's init scales moved off them (so every conv
    and BatchNorm does work), BatchNorm statistics, batches and eps."""
    rng = np.random.default_rng(31)
    kw, xshape = HEADS[head]
    jm = JaxLVAE(dropout_rate=0.0, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(3), "sample": jax.random.key(4)},
        jnp.zeros((B, *xshape)), train=True))

    def draw(path, shape):
        if path[-1] == "kernel":
            std = 1e-2 if any(h in path for h in HEAD_INIT) else 1 / np.sqrt(np.prod(shape[:-1]))
            a = rng.normal(size=shape) * std
        else:
            a = np.ones(shape) if path[-1] == "scale" else np.zeros(shape)
        return (a + rng.normal(size=shape) * 0.1).astype(np.float32)

    params = unflatten_dict({k: draw(k, v.shape)
                             for k, v in flatten_dict(shapes["params"]).items()})
    stats = unflatten_dict({
        k: (rng.normal(size=v.shape) * 0.1 if k[-1] == "mean"
            else rng.uniform(0.5, 1.5, size=v.shape)).astype(np.float32)
        for k, v in flatten_dict(shapes["batch_stats"]).items()})
    if head == "bernoulli":
        xs = [(rng.uniform(size=(B, *xshape)) < 0.4).astype(np.float32) for _ in range(STEPS)]
    else:
        xs = [(rng.integers(0, 256, size=(B, *xshape)) / 255.0).astype(np.float32)
              for _ in range(STEPS)]
    eps = [[rng.normal(size=(B, 4, 4, 4)).astype(np.float32),
            rng.normal(size=(B, 2, 2, 4)).astype(np.float32)] for _ in range(STEPS)]
    return params, stats, xs, eps


def _exact(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision, which may
    otherwise skip the roundings to bf16 that the program asks for (the
    gradients of ``lvae_tpu``'s bf16 casts are then not bf16 values on the
    CPU); one compile, as fast as op-by-op dispatch is slow."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_model(head, dtype):
    kw, _ = HEADS[head]
    return JaxLVAE(dropout_rate=0.0, dtype=dtype, **kw)


def _port(head, dtype, **switches):
    kw, _ = HEADS[head]
    params, stats, _, _ = _setup(head)
    tm = LadderVAE(dropout_rate=0.0, dtype=dtype, **kw, **switches)
    tm.load_state_dict(params_from_flax(params, stats), strict=True)
    return tm


def _nhwc(a):
    return [torch.from_numpy(np.asarray(e)) for e in a]


def _jax_out(head, dtype, train=False, i=0):
    params, stats, xs, eps = _setup(head)
    out, _ = _exact(functools.partial(_jax_model(head, dtype).apply, method=_jax_forward,
                                      mutable=["batch_stats"], train=train),
                    {"params": params, "batch_stats": stats}, jnp.asarray(xs[i]),
                    [jnp.asarray(e) for e in eps[i]])
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _port_out(head, dtype, train=False, i=0, **switches):
    _, _, xs, eps = _setup(head)
    tm = _port(head, dtype, **switches)
    with torch.no_grad():
        out = tm(torch.from_numpy(xs[i]), forced_eps=_nhwc(eps[i]), train=train)
    return {k: out[k].double().numpy() for k in ("ll", "kl_sep")}


def _dt(d) -> str:
    return str(d).replace("torch.", "")


def _leaves(out, prefix=()):
    """(key path, dtype) of every array in a module's output."""
    if isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, (*prefix, k))
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _leaves(v, (*prefix, i))
    elif out is not None and hasattr(out, "dtype"):
        yield prefix, _dt(out.dtype)


class TestDtypeMap:
    @pytest.mark.parametrize("head", ["bernoulli", MIX])
    def test_every_module_boundary_in_lvae_tpus_dtype(self, head):
        """Every module that both packages call by the same name (each
        conv, residual block, resampling block, merge, stochastic layer
        with its p/q params, z and out, the rung, the likelihood head's
        params and ll) returns its outputs in ``lvae_tpu``'s dtype at
        bf16, in training (K3's switch on for the mixture head) and in
        evaluation; and the model's ll and kl are fp32."""
        params, stats, xs, eps = _setup(head)
        jm = _jax_model(head, jnp.bfloat16)
        tm = _port(head, BF16, fused_mixture=head == MIX)
        seen = {}

        def record(name):
            def hook(mod, inp, out):
                seen.setdefault(name, list(_leaves(out)))
            return hook

        hooks = [m.register_forward_hook(record(name)) for name, m in tm.named_modules() if name]
        compared = set()
        for train in (True, False):
            # lvae_tpu's dtypes by abstract evaluation: the same trace, no compute
            (jout, mut) = jax.eval_shape(functools.partial(
                jm.apply, {"params": params, "batch_stats": stats}, jnp.asarray(xs[0]),
                [jnp.asarray(e) for e in eps[0]], train, method=_jax_forward,
                mutable=["batch_stats", "intermediates"], capture_intermediates=True))
            seen.clear()
            out = tm(torch.from_numpy(xs[0]), forced_eps=_nhwc(eps[0]), train=train)
            for path, v in flatten_dict(mut["intermediates"]).items():
                name = ".".join(path[:-1])
                if name in seen:
                    want = dict(_leaves(v[0]))
                    assert dict(seen[name]) == want, (name, train)
                    compared.add(name)
            for k in ("ll", "kl_sep"):
                assert _dt(out[k].dtype) == _dt(jout[k].dtype) == "float32", k
        kinds = {n.rsplit(".", 1)[-1].rstrip("0123456789_") for n in compared}
        assert {"Conv", "ConvTranspose", "ResidualBlock", "GateLayer", "merge", "skip_merge",
                "stochastic", "conv_in_q", "conv_in_p", "conv_out", "likelihood_head",
                "param_conv", "first_conv"} <= kinds, kinds
        assert len(compared) >= 40, len(compared)
        for h in hooks:
            h.remove()
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(b.dtype == torch.float32 for n, b in tm.named_buffers()
                   if "running" in n)


class TestForwardParity:
    """The forward's per-image ll, kl_sep and ELBO of the port at bf16
    against ``lvae_tpu`` at bf16 (compiled without XLA's excess precision,
    K3's switch on for the mixture head), with BatchNorm on running
    statistics (evaluation) and on the batch's (training): the port's
    largest gap to ``lvae_tpu`` must be at most a quarter of
    ``lvae_tpu``'s own largest bf16-vs-fp32 gap on the same inputs, and
    the fp32 models agree to 1e-4. Measured (largest over the batch, port
    gap / ``lvae_tpu``'s own): evaluation, Bernoulli ll 6.1e-5 / 0.197
    (3.1e-4 of it), kl 4.6e-5 / 4.09, ELBO 9.2e-5 / 4.15; mixture ll
    0.0029 / 0.815 (0.0036 of it), kl 9.2e-5 / 21.4, ELBO 0.0029 / 22.1.
    Training, as fractions of the gap: Bernoulli ll 0.053, kl 1.9e-5,
    ELBO 0.0077; mixture ll 0.024, kl 1.4e-5, ELBO 0.0018."""

    @pytest.mark.parametrize("head", ["bernoulli", MIX])
    def test_gap_to_lvae_tpu_below_a_quarter_of_bf16s(self, head):
        for train in (False, True):
            j16 = _jax_out(head, jnp.bfloat16, train)
            j32 = _jax_out(head, None, train)
            t16 = _port_out(head, BF16, train, fused_mixture=head == MIX)
            t32 = _port_out(head, None, train, fused_mixture=head == MIX)
            for o in (j16, j32, t16, t32):
                o["elbo"] = o["ll"] - o["kl_sep"].sum(axis=0)
            for k in ("ll", "kl_sep", "elbo"):
                own = np.abs(j16[k] - j32[k]).max()
                gap = np.abs(t16[k] - j16[k]).max()
                assert own > 0 and gap <= 0.25 * own, (k, train, gap, own)
                np.testing.assert_allclose(t32[k], j32[k], rtol=1e-4, atol=1e-3,
                                           err_msg=f"{k} train={train}")


def _recorded(tx):
    """``tx`` behind a transformation that keeps each step's gradient in its
    state (``opt_state[0]``) and passes it on unchanged."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def _jax_steps(head, dtype, n):
    """(loss, params, gradient) after each of ``n`` steps of ``lvae_tpu``'s
    ``make_batch_train_step`` at ``dtype``, eps given; params and gradients
    by the port's state_dict keys."""
    params, stats, xs, eps = _setup(head)
    jm = _jax_model(head, dtype)

    @dataclasses.dataclass
    class Given:             # what make_batch_train_step calls is apply
        eps: list

        def apply(self, variables, x, train=False, **kw):
            return jm.apply(variables, x, self.eps, train, method=_jax_forward, **kw)

    tx = _recorded(j_make_optimizer(LR))
    cfg = JLossConfig(free_bits=FREE_BITS, preprocess="none")
    p = jax.tree_util.tree_map(jnp.asarray, params)
    zero = jnp.zeros((), jnp.float32)    # not a Python float: one signature for every step
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=p,
                        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                        opt_state=tx.init(p),
                        ema={"elbo": zero, "ll": zero, "kl": zero, "loss": zero,
                             "kl_layers": jnp.zeros(2)},
                        rng=jax.random.key(0))
    # compiled as _exact compiles
    step = jax.jit(lambda st, x, e: make_batch_train_step(Given(e), tx, cfg)(st, x)).lower(
        state, jnp.asarray(xs[0]), [jnp.asarray(e) for e in eps[0]]).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out = []
    for i in range(n):
        state, m = step(state, jnp.asarray(xs[i]), [jnp.asarray(e) for e in eps[i]])
        params_now, grads = jax.device_get((state.params, state.opt_state[0]))
        out.append((float(m["loss"]), _by_torch_key(params_now), _by_torch_key(grads)))
    return out


def _by_torch_key(tree):
    """A flax params tree as fp32 numpy arrays under the port's keys, in
    its layout."""
    out = {}
    for path, a in flatten_dict(tree).items():
        key = torch_key_for(path)
        out[key] = params_from_flax({path[0]: _nest(path[1:], np.asarray(a))})[key].numpy()
    return out


@functools.lru_cache(maxsize=None)
def _steps(head, dtype=BF16, n=STEPS):
    """The port's (loss, state_dict, gradient) after each of ``n`` steps at
    ``dtype``, beside ``lvae_tpu``'s."""
    tm = _port(head, dtype, fused_mixture=head == MIX)
    state = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, LR),
                       ema=init_ema(2, "cpu"), seed=0)
    cfg = LossConfig(free_bits=FREE_BITS, preprocess="none")
    _, _, xs, eps = _setup(head)
    out = []
    for i in range(n):
        m = train_step(state, torch.from_numpy(xs[i]), torch.arange(B), cfg,
                       forced_eps=_nhwc(eps[i]))
        out.append((float(m["loss"]), {k: v.clone() for k, v in tm.state_dict().items()},
                    {k: p.grad.numpy().copy() for k, p in tm.named_parameters()}))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(v.dtype == torch.float32 for st in state.optimizer.state.values()
               for v in st.values())
    return _jax_steps(head, None if dtype is None else jnp.bfloat16, n), out


def _norm(grads, keys):
    return float(np.sqrt(sum(np.sum(np.square(grads[k], dtype=np.float64)) for k in keys)))


def _bf16_valued(a) -> np.ndarray:
    """Elements of an fp32 array that a bf16 holds exactly."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return (t.to(BF16).float() == t).numpy()


class TestTrainStepParity:
    """1 and 3 train steps at bf16 (Adamax lr 3e-3, free bits 0.5) against
    ``lvae_tpu``'s ``make_batch_train_step`` at bf16, the same eps. The
    gradients differ at bf16's level (``test_first_gradients_match_lvae_tpu``)
    and Adamax's first steps move each parameter by about lr whatever the
    gradient's size, so a gradient near 0 that takes the other sign parts
    the packages by up to 2 lr. Held: losses within 2e-3 relative (measured
    1.5e-5, 1.9e-4 and 9.1e-4 Bernoulli, 9.8e-8, 7.9e-6 and 8.7e-6 mixture,
    after 1, 2 and 3 steps), and at least 95% of the parameter elements
    within lr / 10 (measured 99.6% and 98.6% Bernoulli, 99.6% and 98.5%
    mixture, after 1 and 3 steps)."""

    @pytest.mark.parametrize("steps", [1, STEPS])
    @pytest.mark.parametrize("head", ["bernoulli", MIX])
    def test_matches_lvae_tpu(self, head, steps):
        out_j, out_t = _steps(head)
        np.testing.assert_allclose([t[0] for t in out_t[:steps]],
                                   [j[0] for j in out_j[:steps]], rtol=2e-3)
        params_j, sd = out_j[steps - 1][1], out_t[steps - 1][1]
        close = total = 0
        for key, want in params_j.items():
            diff = np.abs(sd[key].numpy() - want)
            close += int((diff <= LR / 10).sum())
            total += diff.size
        assert close >= 0.95 * total, close / total

    @pytest.mark.parametrize("head", ["bernoulli", MIX])
    def test_first_gradients_match_lvae_tpu(self, head):
        """The first step's gradients, before the optimiser, at bf16 and
        fp32 in both packages (``lvae_tpu`` compiled without XLA's excess
        precision). Each conv's weight and bias gradient is the transpose
        of flax's cast, a reduction rounded once to bf16, so the two
        packages part by up to a bf16 ulp at every element from the order
        of the reduction alone: a quarter of ``lvae_tpu``'s bf16-vs-fp32 gap
        (``TestForwardParity``'s rule) cannot hold for gradients. On the CPU
        ``lvae_tpu`` also sums a bf16 conv bias's gradient in bf16 (2.1% of
        the biases' gradient norm off fp32 for Bernoulli, 31% for the
        mixture head, ``ROADMAP.md`` Queue 3), so the biases are held to
        the port's own fp32 gradient. Held, in the L2 norm:
        (a) every conv gradient is bf16-valued at bf16 in both packages,
        and fewer than 1% of the port's are at fp32 (the step ran in bf16);
        (b) the fp32 gradients agree to 1e-5 of their norm (measured 6.3e-7
        Bernoulli, 2.9e-6 mixture);
        (c) over every parameter but the conv biases, the port's bf16
        gradient is within 0.75 x ``lvae_tpu``'s bf16-vs-fp32 gap of
        ``lvae_tpu``'s bf16 gradient (measured 0.44 and 0.52 of a gap of
        4.5 and 11.6, gradient norms 299 and 966), and the port's own
        bf16-vs-fp32 gap is 0.5-2 x ``lvae_tpu``'s (0.93 and 1.01);
        (d) the port's bf16 conv-bias gradients are within 1.5% of its
        fp32 ones (0.61% and 0.48%).
        A gradient off by 1% or more of its norm, or a step run in fp32,
        fails."""
        out_j16, out_t16 = _steps(head)
        out_j32, out_t32 = _steps(head, None, 1)
        j16, t16, j32, t32 = out_j16[0][2], out_t16[0][2], out_j32[0][2], out_t32[0][2]
        assert sorted(t16) == sorted(j16)
        tm = _port(head, BF16)
        convs = [f"{n}.{w}" for n, m in tm.named_modules() if hasattr(m, "compute_dtype")
                 for w, _ in m.named_parameters(recurse=False)]
        assert len(convs) >= 40, len(convs)
        for k in convs:
            assert _bf16_valued(t16[k]).all() and _bf16_valued(j16[k]).all(), k
        assert np.mean(np.concatenate([_bf16_valued(t32[k]).ravel() for k in convs])) < 0.01
        biases = [k for k in convs if k.endswith(".bias")]
        rest = [k for k in t16 if k not in biases]

        def gap(a, b, keys):
            return _norm({k: a[k] - b[k] for k in keys}, keys)

        assert gap(t32, j32, t16) <= 1e-5 * _norm(j32, t16)
        own = gap(j16, j32, rest)
        assert gap(t16, j16, rest) <= 0.75 * own, (gap(t16, j16, rest), own)
        assert 0.5 * own <= gap(t16, t32, rest) <= 2 * own, (gap(t16, t32, rest), own)
        assert gap(t16, t32, biases) <= 0.015 * _norm(t32, biases)


def _nest(path, leaf):
    return leaf if not path else {path[0]: _nest(path[1:], leaf)}


def _bits16(a) -> np.ndarray:
    """The int16 bit patterns of a bf16 array (ulps apart where the sign
    agrees)."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    return np.abs(_bits16(got) - _bits16(want))


def _nchw(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))
    return t if dtype is None else t.to(dtype)


def _tohwc(t):
    return t.detach().permute(0, 2, 3, 1)


class TestPlainBf16VsPallas:
    """The plain bf16 versions against ``lvae_tpu``'s Pallas kernels at
    bf16 in interpret mode. bf16 outputs: at most 1% of the elements apart,
    by 1 bf16 ulp (fp32 values computed in another order round the other
    way); fp32 outputs at ``tests/test_pallas.py``'s tolerances."""

    @pytest.mark.parametrize("rate", [0.0, 0.2])
    def test_segment_forward_and_backward(self, rate):
        x, gamma, beta, g = _inputs(3)
        xb = jnp.asarray(x, jnp.bfloat16)
        gb = jnp.asarray(g, jnp.bfloat16)
        key = jax.random.key(7)
        t = bits8_keep_threshold(rate)

        def run(x_, gm, bt):
            return j_segment(x_, gm, bt, key if rate else None, rate=rate, act="elu")

        (yj, mj, vj), vjp = jax.vjp(run, xb, jnp.asarray(gamma), jnp.asarray(beta))
        dxj, dgj, dbj = vjp((gb, jnp.zeros_like(mj), jnp.zeros_like(vj)))
        assert yj.dtype == dxj.dtype == jnp.bfloat16

        bits = _jax_bits(key, SHAPE) if rate else None
        xt = _nchw(xb.astype(jnp.float32), BF16)
        gt = _nchw(gb.astype(jnp.float32), BF16)
        y, mean, var, r = segment_forward(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                                          t, "elu", mask_bytes=bits)
        dx, dgamma, dbeta = segment_backward(xt, gt, torch.from_numpy(gamma),
                                             torch.from_numpy(beta), mean, r, t, "elu", bits)
        assert y.dtype == dx.dtype == BF16 and mean.dtype == dgamma.dtype == torch.float32
        for got, want in ((y, yj), (dx, dxj)):
            u = _ulps(_tohwc(got), want)
            assert u.max() <= 1 and (u > 0).mean() <= 0.01, (u.max(), (u > 0).mean())
        np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dgamma.numpy(), np.asarray(dgj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dbeta.numpy(), np.asarray(dbj), rtol=1e-4, atol=1e-4)

    def test_mixture_forward_and_backward(self):
        rng = np.random.default_rng(5)
        b, h, w, c, k = 8, 8, 8, 3, 10
        x = (rng.integers(0, 256, size=(b, h, w, c)) / 255.0).astype(np.float32)
        p = jnp.asarray(rng.normal(size=(b, h, w, k * (1 + 3 * c))), jnp.bfloat16)
        g = rng.standard_normal((b, h, w)).astype(np.float32)
        llj, vjp = jax.vjp(lambda xx, pp: j_mix(xx, pp, n_components=k), jnp.asarray(x), p)
        dxj, dpj = vjp(jnp.asarray(g))
        assert dpj.dtype == jnp.bfloat16 and llj.dtype == dxj.dtype == jnp.float32
        pt = _nchw(np.asarray(p.astype(jnp.float32)), BF16).requires_grad_()
        xt = _nchw(x).requires_grad_()
        ll = km.mix_log_prob(xt, pt, k)
        ll.backward(torch.from_numpy(g))
        assert ll.dtype == torch.float32 and pt.grad.dtype == BF16
        assert xt.grad.dtype == torch.float32
        np.testing.assert_allclose(ll.detach().numpy(), np.asarray(llj), rtol=1e-5, atol=1e-5)
        # dparams: the fp32 values agree to 2e-4 relative (the fp32 tests'
        # tolerance), so their bf16 roundings are at most an ulp apart away
        # from 0 (measured: 0.06% of the elements, 2 ulps at values near 0)
        u = _ulps(_tohwc(pt.grad), dpj)
        assert (u > 0).mean() <= 0.01, (u > 0).mean()
        np.testing.assert_allclose(_tohwc(pt.grad).float().numpy(),
                                   np.asarray(dpj.astype(jnp.float32)), rtol=2 ** -7, atol=2e-5)
        np.testing.assert_allclose(_tohwc(xt.grad).numpy(), np.asarray(dxj), rtol=2e-4,
                                   atol=2e-5)


class TestBf16WrappersRefuse:
    """What the kernels' wrappers do not take raises a TypeError naming
    the dtype; bf16 is taken and returns bf16."""

    def test_segment(self):
        x = torch.randn(2, 4, 4, 4, dtype=BF16)
        gamma, beta = torch.ones(4), torch.zeros(4)
        y, mean, var = dropout_bn_act(x, gamma, beta, rate=0.2, act="elu", seed=1, step=0, site=0)
        assert y.dtype == BF16 and mean.dtype == var.dtype == torch.float32
        for bad, what in (((x.half(), gamma, beta), "float16"),
                          ((x, gamma.to(BF16), beta), "gamma must be torch.float32"),
                          ((x, gamma, beta.double()), "beta must be torch.float32")):
            with pytest.raises(TypeError, match=what):
                dropout_bn_act(*bad)
        stats = torch.zeros(5, 4)
        with pytest.raises(TypeError, match="g must be torch.bfloat16"):
            dropout_bn_act_backward(x, x.float(), gamma, beta, stats, 256, "elu")

    def test_dropout(self):
        x = torch.randn(3, 5, 7, 2, dtype=BF16)
        y = dropout_bits8(x, 0.2, 1, 0, 3)
        assert y.dtype == BF16
        kept = y != 0
        torch.testing.assert_close(y[kept].float(),
                                   (x.float() * np.float32(256 / 205)).to(BF16)[kept].float(),
                                   rtol=0, atol=0)

    def test_mixture(self):
        x = torch.rand(2, 3, 4, 4)
        p = torch.randn(2, 100, 4, 4, dtype=BF16)
        assert km.mix_log_prob(x, p, 10).dtype == torch.float32
        with pytest.raises(TypeError, match="x must be torch.float32 for torch.bfloat16"):
            km.mix_log_prob(x.to(BF16), p, 10)
        with pytest.raises(TypeError, match="params must be float32 or bfloat16, got "
                                            "torch.float16"):
            km.mix_log_prob(x, p.half(), 10)


class TestBf16Serving:
    @pytest.mark.parametrize("head", ["bernoulli", MIX])
    def test_outputs_fp32_and_near_the_fp32_models(self, head):
        """``serving``'s reconstruct, encode and generate on a bf16 model:
        every output fp32 and finite (``lvae_tpu``'s serving casts each to
        fp32), each image's ELBO within 2% of the same weights' at fp32 and
        the generated means within 0.05 (measured: Bernoulli 1.06% and
        0.0028, mixture 0.0057% and 0.0019)."""
        from lvae_tpu_torch import serving

        kw, xshape = HEADS[head]
        rng = np.random.default_rng(8)
        x_u8 = torch.from_numpy((rng.uniform(size=(4, *xshape)) < 0.4).astype(np.uint8)
                                if head == "bernoulli" else
                                rng.integers(0, 256, size=(4, *xshape), dtype=np.uint8))
        pre = "none" if head == "bernoulli" else "dequantize"
        index = torch.tensor([3, 0, 7, 2])
        out = {}
        for dtype in (BF16, None):
            tm = _port(head, dtype, fused_mixture=head == MIX).eval()
            r = serving.reconstruct(tm, x_u8, 5, index, preprocess=pre)
            e = serving.encode(tm, x_u8, 5, index, preprocess=pre)
            g = serving.generate(tm, 3, seed=1, temperature=0.8)
            out[dtype] = r, g
            for t in (*r.values(), *e["mu"], *e["z"], g):
                assert t.dtype == torch.float32 and bool(torch.isfinite(t).all()), dtype
        (r16, g16), (r32, g32) = out[BF16], out[None]
        assert g16.shape == (3, *xshape)
        gap = (r16["elbo"] - r32["elbo"]).abs() / r32["elbo"].abs()
        assert float(gap.max()) <= 0.02, gap
        assert float((g16 - g32).abs().max()) <= 0.05


class TestBf16Checkpoint:
    def test_converts_through_lvae_tpus_reader_and_scores_in_bf16(self, tmp_path):
        """Two ``--precision bf16`` steps through the training CLI: the
        run records ``"precision": "bf16"``, its checkpoint holds fp32
        weights (the layout of an fp32 run's) that ``lvae_tpu``'s
        ``torch_state_dict_to_flax`` converts strictly, and the converted
        weights give ``lvae_tpu`` at bf16 the port's bf16 evaluation ELBO
        (the test split's first 64 images, eps given) to a quarter of
        ``lvae_tpu``'s own bf16-vs-fp32 gap."""
        import json
        import os

        from lvae_tpu.train.convert import torch_state_dict_to_flax
        from lvae_tpu_torch.main import main
        from tests.test_torch_cli import TINY

        tr = main(TINY + ["--precision", "bf16", "--max-steps", "2", "--output-dir",
                          str(tmp_path), "--run-name", "r", "--checkpoint-interval", "2"])
        with open(os.path.join(tr.run_dir, "config.json")) as f:
            assert json.load(f)["precision"] == "bf16"
        ckpt = torch.load(os.path.join(tr.run_dir, "checkpoints", "ckpt_00000002.pt"),
                          weights_only=True)
        assert all(t.dtype == torch.float32 for t in ckpt["model"].values()
                   if t.is_floating_point())
        kw = dict(color_ch=1, z_dims=(3, 3), blocks_per_layer=1, n_filters=8,
                  stochastic_skip=True, gated=True, downsample=(1, 1), learn_top_prior=True,
                  img_size=(32, 32), data_size=(28, 28), dropout_rate=0.0)
        shapes = jax.eval_shape(lambda: JaxLVAE(**kw).init(
            {"params": jax.random.key(0), "sample": jax.random.key(1)},
            jnp.zeros((2, 28, 28, 1)), train=True))
        params, stats = torch_state_dict_to_flax(shapes["params"], shapes["batch_stats"],
                                                 ckpt["model"], strict=True)
        x = tr.exp.test_data[:64].float().numpy()
        rng = np.random.default_rng(2)
        eps = [rng.normal(size=(64, 8, 8, 3)).astype(np.float32),
               rng.normal(size=(64, 4, 4, 3)).astype(np.float32)]

        def jax_elbo(dtype):
            out, _ = _exact(functools.partial(JaxLVAE(dtype=dtype, **kw).apply,
                                              method=_jax_forward, mutable=["batch_stats"],
                                              train=False),
                            {"params": params, "batch_stats": stats}, jnp.asarray(x),
                            [jnp.asarray(e) for e in eps])
            return np.asarray(out["ll"] - out["kl_sep"].sum(axis=0), np.float64)

        tm = LadderVAE(dtype=BF16, dropout_rate=0.0, **{k: v for k, v in kw.items()
                                                         if k != "dropout_rate"})
        tm.load_state_dict(ckpt["model"], strict=True)
        with torch.no_grad():
            out = tm(torch.from_numpy(x), forced_eps=_nhwc(eps))
        port = (out["ll"] - out["kl_sep"].sum(dim=0)).double().numpy()
        j16, j32 = jax_elbo(jnp.bfloat16), jax_elbo(None)
        assert np.abs(port - j16).max() <= 0.25 * np.abs(j16 - j32).max()
