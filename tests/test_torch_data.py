"""The port's multi-object datasets, ``multi_dsprites_binary_rgb`` and
``multi_mnist_binary``, on the CPU against ``lvae_tpu``:

- both rows load ``tools/make_fixtures.py``'s ``write_multiobject``
  files as ``lvae_tpu.data.registry.load_dataset`` does: the same train
  and test arrays (the last 10% of the images is the test split) and the
  same metadata (shapes from the file, padded to the next power of two,
  so 48 -> 64; channels from the file; preprocess ``none``; Bernoulli);
- the npz reader takes {0, 255} pixels, an ``images`` key and [N, H, W]
  arrays as ``lvae_tpu``'s ``load_multiobject_npz`` does;
- one float64 train step of ``multi_mnist_binary``'s model (48 -> 64
  padding and the crop back) against ``lvae_tpu``'s, with
  ``tests/test_torch_train.py``'s tolerances."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from lvae_tpu.data import registry as jregistry
from lvae_tpu.data.sources import load_multiobject_npz as j_load_npz
from lvae_tpu.models.lvae import LadderVAE as JaxLVAE
from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.data.registry import load_dataset, load_test_set
from lvae_tpu_torch.data.sources import load_multiobject_npz
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.state import LossConfig, TrainState, init_ema, make_optimizer, train_step
from tests.test_torch_train import (
    _HEADS,
    ANNEAL,
    FREE_BITS,
    LR,
    _bn_fed,
    _ForcedEps,
    _nest,
    _to64,
)
from tools.make_fixtures import write_multiobject

NAMES = {"multi_dsprites_binary_rgb": ((64, 64), (64, 64), 3),
         "multi_mnist_binary": ((48, 48), (64, 64), 1)}
N_IMAGES = 40


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    list(write_multiobject(str(root / "multiobject"), N_IMAGES))
    return str(root)


class TestMultiObjectRows:
    @pytest.mark.parametrize("name", sorted(NAMES))
    def test_loads_as_lvae_tpu(self, data_dir, name):
        ref = jregistry.load_dataset(name, data_dir)
        got = load_dataset(name, data_dir)
        np.testing.assert_array_equal(got.train, ref.train)
        np.testing.assert_array_equal(got.test, ref.test)
        np.testing.assert_array_equal(load_test_set(name, data_dir).test, ref.test)
        img, padded, ch = NAMES[name]
        assert got.img_size == ref.img_size == img
        assert got.padded_size == ref.padded_size == padded
        assert got.color_ch == ref.color_ch == ch
        assert got.preprocess == ref.preprocess == "none"
        assert got.default_likelihood == ref.default_likelihood == "bernoulli"
        assert got.test.shape[0] == N_IMAGES // 10 and got.train.shape[0] == N_IMAGES * 9 // 10
        assert got.train.dtype == np.uint8 and set(np.unique(got.train)) <= {0, 1}

    def test_rejects_a_size_suffix(self, data_dir):
        with pytest.raises(ValueError, match="size"):
            load_test_set("multi_mnist_binary:10", data_dir)

    @pytest.mark.parametrize("key,shape,scale", [("x", (30, 12, 12, 3), 255),
                                                 ("images", (30, 12, 12), 1),
                                                 ("images", (7, 5, 5, 1), 255)])
    def test_npz_layouts(self, tmp_path, rng, key, shape, scale):
        x = ((rng.uniform(size=shape) < 0.3) * scale).astype(np.uint8)
        path = str(tmp_path / "set.npz")
        np.savez(path, **{key: x, "n_obj": np.arange(shape[0])})
        got, want = load_multiobject_npz(path), j_load_npz(path)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.ndim == 4 and set(np.unique(g)) <= {0, 1}
        assert got[1].shape[0] == max(1, shape[0] // 10)


class TestMultiMnistStep:
    """One float64 train step at 48x48 (padded to 64x64): losses rtol
    1e-7, parameters and statistics atol 1e-6, except, as in
    ``tests/test_torch_train.py``, the conv biases that only a BatchNorm
    reads (and that BatchNorm's running mean): their true gradient is 0,
    each package's roundoff gradient over the 64x64 maps is within reach
    of Adamax's eps, so each moves them in a direction the roundoff
    picks, by at most 2 lr a step (measured here: 1.1e-6)."""

    KW = dict(color_ch=1, z_dims=(3, 3), blocks_per_layer=1, n_filters=8,
              stochastic_skip=True, gated=True, downsample=(1, 1), learn_top_prior=True,
              img_size=(64, 64), data_size=(48, 48))
    B = 4

    def test_matches_lvae_tpu(self, data_dir):
        rng = np.random.default_rng(5)
        data = load_dataset("multi_mnist_binary", data_dir)
        assert (data.img_size, data.padded_size) == (self.KW["data_size"],
                                                     self.KW["img_size"])
        batch = data.train[:self.B]
        eps = [rng.normal(size=(self.B, 16, 16, 3)), rng.normal(size=(self.B, 8, 8, 3))]
        jm = JaxLVAE(dropout_rate=0.0, **self.KW)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(3), "sample": jax.random.key(4)},
            jnp.zeros((self.B, 48, 48, 1)), train=True))

        def draw(path, shape):
            if path[-1] == "kernel":
                std = 1e-2 if any(h in path for h in _HEADS) else 1 / np.sqrt(np.prod(shape[:-1]))
                a = rng.normal(size=shape) * std
            else:
                a = np.ones(shape) if path[-1] == "scale" else np.zeros(shape)
            return (a + rng.normal(size=shape) * 0.1).astype(np.float32)

        params = unflatten_dict({k: draw(k, v.shape)
                                 for k, v in flatten_dict(shapes["params"]).items()})
        stats = unflatten_dict({k: (np.zeros if k[-1] == "mean" else np.ones)(v.shape, np.float32)
                                for k, v in flatten_dict(shapes["batch_stats"]).items()})

        jcfg = JLossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
        tx = j_make_optimizer(LR)
        with jax.enable_x64():
            p64 = _to64(params)
            state = JTrainState(step=jnp.zeros((), jnp.int32), params=p64,
                                batch_stats=_to64(stats), opt_state=tx.init(p64),
                                ema=jax.tree_util.tree_map(jnp.zeros_like, {
                                    "elbo": 0.0, "ll": 0.0, "kl": 0.0, "loss": 0.0,
                                    "kl_layers": jnp.zeros(2)}),
                                rng=jax.random.key(0))
            step = jax.jit(lambda s, x, e: make_batch_train_step(_ForcedEps(jm, e), tx, jcfg)(s, x))
            state, m = step(state, jnp.asarray(batch), [jnp.asarray(a) for a in eps])
            loss_j = float(m["loss"])
            params_j = flatten_dict(jax.device_get(state.params))
            stats_j = flatten_dict(jax.device_get(state.batch_stats))

        tm = LadderVAE(dropout_rate=0.0, **self.KW)
        tm.load_state_dict(params_from_flax(params, stats), strict=True)
        tm = tm.double()
        tstate = TrainState(step=0, model=tm, optimizer=make_optimizer(tm, LR),
                            ema=init_ema(2, "cpu"), seed=0)
        m = train_step(tstate, torch.from_numpy(batch), torch.arange(self.B),
                       LossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL,
                                  preprocess="none"),
                       forced_eps=[torch.from_numpy(a) for a in eps])
        np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-7, atol=0)
        sd = tm.state_dict()
        roundoff_led = _bn_fed(tm)
        for tree in (params_j, stats_j):
            for path, a in tree.items():
                key = torch_key_for(path)
                want = params_from_flax({path[0]: _nest(path[1:], a)})[key]
                atol = 2 * LR if key in roundoff_led else 1e-6
                np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=0, atol=atol,
                                           err_msg=str(path))
        moved = max(np.abs(np.asarray(a) - np.asarray(flatten_dict(params)[k])).max()
                    for k, a in params_j.items())
        assert moved > 1e-3
