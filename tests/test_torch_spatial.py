"""The port's height-sharded slice (``--spatial-shards``, the ``space``
axis of ``lvae_tpu``'s ``(data, space)`` mesh) on the CPU: the band rule,
the banded noise and dropout draws, the halo exchange and each banded
module on gloo ranks against the unbanded one, the port's train steps at
2 x 2 and 1 x 4 against ``lvae_tpu``'s ``make_mesh(n, spatial=S)`` step on
the conftest's virtual CPU devices, and against the port on one rank at 1
x 2, 2 x 2 and 1 x 4 (dropout 0.1, keyed, so every layout draws what one
rank draws; the ``torch-post``, ``interpolate`` and ``bn-subsample``
variants of ``lvae_tpu``'s ``TestSpatialSharding``, ``--remat`` and
``--fused all`` at 2 x 2; a three-layer ladder, whose 2-row top leaves
two ranks an empty band, at 1 x 4).

The ranks run in their own processes (``tests/torch_parallel_ranks.py``,
one launch a layout, each with a timeout of at most 120 s, beside the JAX
side's compiles). Inputs, weights and the latent noise come from numpy
and go to both packages (``forced_eps``); dropout is 0 where the two are
compared. Tolerances are ``tests/test_torch_parallel.py``'s, in float64:
losses 1e-7 relative, parameters and statistics 1e-6 absolute (the conv
biases that only a BatchNorm reads, 2 lr a step); the banded modules
1e-12."""

import functools
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from lvae_tpu.models.lvae import LadderVAE as JaxLVAE
from lvae_tpu.parallel import activation_constraint, make_dp_train_step, make_mesh
from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.kernels import stochastic as sk
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.ops.philox import Band, ElementMap, band_map, dropout_bytes, keyed_normal
from lvae_tpu_torch.parallel import Layout, mesh
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from test_torch_parallel import _ForcedEps, _keep_updates, _nest, _to64
from torch_parallel_ranks import bn_fed_keys, launch_cases, train_case

SPAWN_TIMEOUT_S = 120

# tests/test_parallel.py's tiny config (lvae_tpu's TestSpatialSharding),
# with the learned top prior and the gated, skip-connected ladder
CFG = dict(color_ch=1, z_dims=(4, 4), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
           gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(32, 32),
           data_size=(28, 28))
B = 16
STEPS = 3
LR = 3e-3
FREE_BITS, ANNEAL = 0.5, 4
EPS_SHAPES = [(B, 8, 8, 4), (B, 4, 4, 4)]
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4)}
# the flagship's heights (32 padded, 28 data; 16, 8, 4, 2 inside) and the
# tiny configs' (14 data, 16, 8, 4, 2; 28, 32 ...)
HEIGHTS = (1, 2, 3, 4, 7, 8, 14, 16, 28, 32, 64)
PADS = ("same", "torch")
MODULE_SPECS = tuple(
    [("conv", pad, 3, 1, h) for pad in PADS for h in (8, 4, 2, 1)]
    + [("conv", pad, 5, 2, h) for pad in PADS for h in (16, 4)]
    + [("conv", pad, 3, 2, h) for pad in PADS for h in (8, 4, 2)]
    + [("convT", pad, 3, 2, h) for pad in PADS for h in (4, 2, 1)]
    + [("down", "-", 0, 0, h) for h in (8, 4, 2)]
    + [("up", "-", 0, 0, h) for h in (4, 2, 1)])
HALO_SPECS = ((8, 1, 1), (8, 2, 1), (4, 1, 2), (3, 0, 2), (2, 1, 1), (1, 1, 1))
# against one rank: layout -> case -> the model's switches over ONE_RANK_BASE
ONE_RANK_BASE = dict(color_ch=1, z_dims=(4, 4), blocks_per_layer=1, n_filters=8,
                     downsample=(1, 1), learn_top_prior=True, img_size=(32, 32),
                     data_size=(28, 28), dropout_rate=0.1)
ONE_RANK = {
    (1, 2): {"base": {}},
    (2, 2): {
        "base": {},
        "torch_post": dict(conv_pad="torch", skip_merge_mode="post", stochastic_skip=True),
        "interpolate": dict(resample_mode="interpolate"),
        "bn_subsample": dict(bn_stat_samples=8),
        "remat": dict(remat=True, stochastic_skip=True, gated=True),
        "fused_all": dict(fused_segments=True, fused_stochastic=True),
    },
    (1, 4): {
        "base": {},
        "three_layers": dict(z_dims=(4, 4, 4), downsample=(1, 1, 1), stochastic_skip=True,
                             gated=True),
    },
}
ONE_RANK_CASES = [(d, s, name) for (d, s), cases in ONE_RANK.items() for name in cases]


class TestBands:
    @pytest.mark.parametrize("count", [1, 2, 4])
    @pytest.mark.parametrize("h", HEIGHTS)
    def test_band_rule(self, h, count):
        """Bands of ``ceil(H / S)`` rows, in order, covering ``[0, H)``
        once; short and empty ones at the end (XLA's uneven sharding)."""
        c = -(-h // count)
        bands = [mesh.band(h, count, s) for s in range(count)]
        assert bands[0][0] == 0 and bands[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        assert [b - a for a, b in bands] == [max(0, min(c, h - s * c)) for s in range(count)]

    def test_short_and_empty_bands(self):
        """The flagship's 2-row top over 4 ranks: 1, 1, 0 and 0 rows; its
        28-row crop of the 32-row map keeps 14 / 14 and 6 / 8 / 8 / 6."""
        assert [mesh.band(2, 4, s) for s in range(4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]
        model = LadderVAE(**CFG)
        x = torch.zeros(1, 28, 28, 1)
        for count, want in ((2, [14, 14]), (4, [6, 8, 8, 6])):
            rows = []
            for s in range(count):
                bands = mesh.Bands(s, count, None, (32, 32))
                h0, h1 = bands.rows(32)
                td, target = model._crop_band(torch.zeros(1, 8, h1 - h0, 32), x, bands)
                assert td.shape[-2] == target.shape[1] and td.shape[-1] == 28
                rows.append(td.shape[-2])
            assert rows == want

    def test_row_plan(self):
        """The exchange of a 2-row-band map's conv at 4 ranks: a rank takes
        its band, one row of each neighbour (one band away or two, where
        the band between is short) and zeros beyond the map; one row at
        each end of every band travels."""
        want = ((-1, 2), (0, 3), (2, 2), (2, 2))
        plan = mesh.row_plan(2, 4, 1, want)
        assert plan.depth == 1 and plan.rows == 1
        # rank 1: row 0 from band 0's slot, its own row, a zero row
        assert plan.source == (1 + 0 * 2, 0, 1 + 4 * 2)
        assert mesh.row_plan(8, 2, 0, ((0, 4), (4, 8))).depth == 0    # no exchange


class TestBandedDraws:
    @pytest.mark.parametrize("count", [2, 4])
    def test_keyed_normal_bands_concatenate(self, count):
        """The banded draws of every rank, concatenated along the height,
        are the one-rank draws bit for bit (at 2-row maps over 4 ranks,
        with empty bands)."""
        index = torch.tensor([3, 17, 5])
        for shape in ((3, 4, 8, 8), (3, 4, 2, 2), (3, 2, 7, 5)):
            whole = keyed_normal(shape, 11, index, 4, 1)
            parts = []
            for s in range(count):
                h0, h1 = mesh.band(shape[2], count, s)
                parts.append(keyed_normal((*shape[:2], h1 - h0, shape[3]), 11, index, 4, 1,
                                          Band(shape[2], h0)))
            assert torch.equal(torch.cat(parts, dim=2), whole)

    @pytest.mark.parametrize("count", [2, 4])
    def test_dropout_bytes_bands_concatenate(self, count):
        """A rank's dropout bytes under its element map (its data index's
        rows, its band of them) are the global tensor's there, bit for bit,
        at maps whose band is no multiple of 16 elements too."""
        for shape in ((6, 5, 8, 8), (6, 5, 2, 2), (6, 3, 7, 5)):
            whole = dropout_bytes(shape, 1234)
            b, c, h, w = shape
            for d in range(2):
                rows = []
                for s in range(count):
                    h0, h1 = mesh.band(h, count, s)
                    emap = band_map((b // 2, c, h1 - h0, w), Band(h, h0), d * (b // 2) * c * h * w)
                    rows.append(dropout_bytes((b // 2, c, h1 - h0, w), 1234, emap=emap))
                assert torch.equal(torch.cat(rows, dim=2), whole[d * b // 2:(d + 1) * b // 2])

    def test_element_map(self):
        """``ElementMap.at``: a run's offset, or a band's jump from one
        channel's rows to the next."""
        e = torch.arange(8)
        assert ElementMap(0, 0, 5).at(e).tolist() == list(range(5, 13))
        assert ElementMap(4, 10, 3).at(e).tolist() == [3, 4, 5, 6, 13, 14, 15, 16]

    def test_k1_on_a_band(self):
        """K1's plain path on a 1-row band draws the band's rows of the
        whole map's eps (its per-sample KL the band's part); its launch
        plan takes a 1-row band; an empty band gives an empty z and zero
        sums."""
        g = torch.Generator().manual_seed(2)
        q, p = torch.randn(3, 8, 4, 4, generator=g), torch.randn(3, 8, 4, 4, generator=g)
        index = torch.tensor([1, 9, 4])
        z, kl = sk.sample_kl_per_sample(q, p, index, 7, 2, 1)
        parts, kls = [], []
        for s in range(4):
            zs, kls_ = sk.sample_kl_per_sample(q[:, :, s:s + 1].contiguous(),
                                               p[:, :, s:s + 1].contiguous(), index, 7, 2, 1,
                                               Band(4, s))
            parts.append(zs)
            kls.append(kls_)
        torch.testing.assert_close(torch.cat(parts, dim=2), z, rtol=0, atol=0)
        torch.testing.assert_close(sum(kls), kl, rtol=1e-6, atol=1e-6)
        plan = sk.k1_plan(64, 32, 1 * 4)
        assert plan.per_row == 128 and plan.threads * plan.per_thread * plan.vec >= 128
        assert sk.k1_bwd_plan(64, 32, 1 * 2, True).prior_sum == 1
        ze, ke = sk.sample_kl_per_sample(q[:, :, :0].contiguous(), p[:, :, :0].contiguous(),
                                         index, 7, 2, 1, Band(4, 4))
        assert ze.shape == (3, 4, 0, 4) and torch.equal(ke, torch.zeros(3))


def _draw_params(rng, shapes):
    def draw(path, shape):
        if path[-1] == "kernel":
            heads = ("conv_in_p", "conv_in_q", "param_conv")
            std = 1e-2 if any(h in path for h in heads) else 1 / np.sqrt(np.prod(shape[:-1]))
            a = rng.normal(size=shape) * std
        else:
            a = np.ones(shape) if path[-1] == "scale" else np.zeros(shape)
        return (a + rng.normal(size=shape) * 0.1).astype(np.float32)

    return unflatten_dict({k: draw(k, v.shape) for k, v in flatten_dict(shapes).items()})


@functools.lru_cache(maxsize=None)
def _setup():
    """float32 weights drawn with numpy at flax's shapes (moved off their
    starts), the binary batches of 28 rows and the per-step eps."""
    rng = np.random.default_rng(31)
    jm = JaxLVAE(dropout_rate=0.0, **CFG)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(3), "sample": jax.random.key(4)},
        jnp.zeros((B, 28, 28, 1)), train=True))
    params = _draw_params(rng, shapes["params"])
    stats = unflatten_dict({k: (np.zeros if k[-1] == "mean" else np.ones)(v.shape, np.float32)
                            for k, v in flatten_dict(shapes["batch_stats"]).items()})
    batches = [(rng.uniform(size=(B, 28, 28, 1)) < 0.4).astype(np.uint8) for _ in range(STEPS)]
    eps = [[rng.normal(size=s) for s in EPS_SHAPES] for _ in range(STEPS)]
    return params, stats, batches, eps


@functools.lru_cache(maxsize=None)
def _jax_trajectory(layout: str):
    """Per step (loss, params, batch_stats, gradients) of ``lvae_tpu``'s
    ``make_dp_train_step`` on a ``(data, space)`` mesh with the height
    constraint (``activation_constraint``), float64."""
    n_data, spatial = LAYOUTS[layout]
    params, stats, batches, eps = _setup()
    jm = JaxLVAE(dropout_rate=0.0, **CFG)
    jcfg = JLossConfig(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none")
    tx = optax.chain(_keep_updates(), j_make_optimizer(LR))
    mesh_j = make_mesh(n_data, spatial=spatial)

    def body(state, data, idx):
        forced = _ForcedEps(jm, [e[idx] for e in data["eps"]])
        return make_batch_train_step(forced, tx, jcfg, activation_constraint(mesh_j))(
            state, data["x"][idx])

    out = []
    with jax.enable_x64():
        step = make_dp_train_step(body, mesh_j)
        p64 = _to64(params)
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=p64,
                            batch_stats=_to64(stats), opt_state=tx.init(p64),
                            ema=jax.tree_util.tree_map(jnp.zeros_like, {
                                "elbo": 0.0, "ll": 0.0, "kl": 0.0, "loss": 0.0,
                                "kl_layers": jnp.zeros(2)}),
                            rng=jax.random.key(0))
        for batch, e in zip(batches, eps):
            state, m = step(state, {"x": jnp.asarray(batch),
                                    "eps": [jnp.asarray(a) for a in e]}, jnp.arange(B))
            out.append((float(m["loss"]), flatten_dict(jax.device_get(state.params)),
                        flatten_dict(jax.device_get(state.batch_stats)),
                        flatten_dict(jax.device_get(state.opt_state[0]))))
    return out


def _train_case() -> dict:
    params, stats, batches, eps = _setup()
    return {"kind": "train", "model": dict(dropout_rate=0.0, **CFG),
            "state_dict": params_from_flax(params, stats), "lr": LR,
            "loss": dict(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL, preprocess="none"),
            "batches": [torch.from_numpy(b) for b in batches],
            "eps": [[torch.from_numpy(a) for a in e] for e in eps]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _one_rank_case(switches: dict) -> dict:
    """A keyed-noise case (dropout 0.1, weights drawn from seed 3) of the
    tiny config with ``switches``."""
    rng = np.random.default_rng(41)
    return {"kind": "train", "model": {**ONE_RANK_BASE, **switches}, "state_dict": None,
            "lr": LR, "loss": dict(free_bits=FREE_BITS, beta_anneal_steps=ANNEAL,
                                   preprocess="none"),
            "batches": [torch.from_numpy((rng.uniform(size=(B, 28, 28, 1)) < 0.4)
                                         .astype(np.uint8)) for _ in range(STEPS)],
            "eps": [None] * STEPS}


@pytest.fixture(scope="module")
def banded_ranks():
    """One launch of gloo ranks a layout, beside the JAX side's compiles:
    at 2 x 2 and 1 x 4 the train steps against ``lvae_tpu``'s mesh and the
    halo and the banded modules over the space group (2 ranks, then 4);
    at every layout the one-rank cases (``ONE_RANK``), each also run on
    one rank in this process (under ``"one_rank"``)."""
    box = {}

    def run():
        for (n_data, spatial), names in ONE_RANK.items():
            cases = {name: _one_rank_case(sw) for name, sw in names.items()}
            name = f"{n_data}x{spatial}"
            if name in LAYOUTS:
                cases.update(train=_train_case(),
                             halo={"kind": "halo", "specs": HALO_SPECS},
                             modules={"kind": "modules", "specs": MODULE_SPECS})
            box[name] = launch_cases(cases, n_data * spatial, SPAWN_TIMEOUT_S, spatial)
            box[name]["one_rank"] = {k: train_case(cases[k], Layout()) for k in names}

    thread = threading.Thread(target=run)
    thread.start()
    for name in LAYOUTS:
        _jax_trajectory(name)
    thread.join()
    assert set(box) == {f"{d}x{s}" for d, s in ONE_RANK}, "the ranks failed (output above)"
    return box


class TestBandedModules:
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_halo(self, banded_ranks, layout):
        """``mesh.halo`` on 2 and 4 ranks (short and empty bands among
        them): each rank's rows, and each band's gradient, those of the
        zero-padded whole map to 1e-12 (they are copies and sums of
        copies)."""
        worst = banded_ranks[layout]["halo"]["worst"]
        assert set(worst) == set(HALO_SPECS)
        bad = {k: v for k, v in worst.items() if not v <= 1e-12}
        assert not bad, bad

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_modules(self, banded_ranks, layout):
        """Each banded conv (3x3/1, 5x5/2, 3x3/2, the transposed conv) under
        ``same`` and ``torch``, and the nearest resize both ways, on 2 and
        4 ranks at heights with 1-row and empty bands: the output band, the
        input's gradient band and the weight's and bias's gradients summed
        over the space group, within 1e-12 of the unbanded module's."""
        worst = banded_ranks[layout]["modules"]["worst"]
        assert set(worst) == set(MODULE_SPECS)
        bad = {k: v for k, v in worst.items() if not v <= 1e-12}
        assert not bad, bad


class TestTrainStepMatchesLvaeTpuMesh:
    """The port's steps at 2 x 2 and 1 x 4 against ``lvae_tpu``'s
    ``(data, space)`` mesh, latents given, dropout 0."""

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_steps(self, banded_ranks, layout):
        out_j, out_t = _jax_trajectory(layout), banded_ranks[layout]["train"]["steps"]
        np.testing.assert_allclose([s["loss"] for s in out_t], [j[0] for j in out_j],
                                   rtol=1e-7, atol=0)
        roundoff_led = bn_fed_keys(LadderVAE(**CFG))
        for i in range(STEPS):
            sd = out_t[i]["state_dict"]
            _, params_j, stats_j, _ = out_j[i]
            for tree in (params_j, stats_j):
                for path, a in tree.items():
                    key = torch_key_for(path)
                    want = params_from_flax({path[0]: _nest(path[1:], a)})[key]
                    atol = 2 * LR * (i + 1) if key in roundoff_led else 1e-6
                    np.testing.assert_allclose(sd[key].numpy(), want.numpy(), rtol=0,
                                               atol=atol, err_msg=f"step {i + 1} {path}")

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_gradients(self, banded_ranks, layout):
        """Rank 0's gradients, summed over all four ranks, against the
        global loss's that ``lvae_tpu``'s mesh step hands Adamax: a loss
        counted once per space group (not S times) and once per data
        index. Each tensor within 1e-5 of its largest element (the
        roundoff-led biases and zero gradients, of the model's largest)."""
        out_j, out_t = _jax_trajectory(layout), banded_ranks[layout]["train"]["steps"]
        roundoff_led = bn_fed_keys(LadderVAE(**CFG))
        for i in range(STEPS):
            got, grads_j = out_t[i]["grads"], out_j[i][3]
            assert len(got) == len(grads_j)
            top = max(float(np.abs(a).max()) for a in grads_j.values())
            for path, a in grads_j.items():
                key = torch_key_for(path)
                want = params_from_flax({path[0]: _nest(path[1:], a)})[key].numpy()
                scale = (key not in roundoff_led and float(np.abs(want).max())) or top
                np.testing.assert_allclose(got[key].numpy(), want, rtol=0, atol=1e-5 * scale,
                                           err_msg=f"step {i + 1} {path}")

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_no_rank_holds_a_whole_activation(self, banded_ranks, layout):
        """The hooks of ``torch_parallel_ranks.band_hooks``: every conv's
        input on every rank was its band (at most ``ceil(H / S)`` rows) and
        every exchange took at most the band and a halo."""
        r = banded_ranks[layout]["train"]
        assert r["conv_inputs_seen"] > 0
        assert r["band_faults"] == 0, r["faults"]


class TestAgainstOneRank:
    @pytest.mark.parametrize("key", ONE_RANK_CASES,
                             ids=[f"{d}x{s}-{n}" for d, s, n in ONE_RANK_CASES])
    def test_steps(self, banded_ranks, key):
        """Three float64 steps at ``D x S`` ranks against one rank: the
        losses (1e-7), the metrics (1e-6: the KL terms are fp32 on both,
        as in ``lvae_tpu``, and a band sums its part first), and every
        parameter and statistic after each step (rank 0's; the gradients
        are summed over every rank, so each rank holds the same) within
        1e-6; within Adamax's 2 lr a step where roundoff leads: the conv
        biases that only a BatchNorm reads, and each element whose
        gradient on one rank was, at some step so far, below 1e-5 of its
        tensor's largest (Adamax's first steps move such an element by an
        amount its rounding decides)."""
        d, s_, name = key
        got = banded_ranks[f"{d}x{s_}"][name]
        one = banded_ranks[f"{d}x{s_}"]["one_rank"][name]
        np.testing.assert_allclose([s["loss"] for s in got["steps"]],
                                   [s["loss"] for s in one["steps"]], rtol=1e-7, atol=0)
        led_keys = bn_fed_keys(LadderVAE(**{**ONE_RANK_BASE, **ONE_RANK[(d, s_)][name]}))
        led = {}
        for i, (a, b) in enumerate(zip(got["steps"], one["steps"])):
            for k, v in a["metrics"].items():
                np.testing.assert_allclose(v.numpy(), b["metrics"][k].numpy(), rtol=1e-6,
                                           atol=1e-9, err_msg=f"step {i + 1} {k}")
            for k, g in b["grads"].items():
                small = g.abs() < 1e-5 * g.abs().max()
                led[k] = small if k not in led else led[k] | small
            for k, v in b["state_dict"].items():
                if not v.is_floating_point():
                    continue
                diff = (a["state_dict"][k] - v).abs()
                bound = torch.full_like(v, 1e-6)
                if k in led_keys:
                    bound.fill_(2 * LR * (i + 1))
                elif k in led:
                    bound[led[k]] = 2 * LR * (i + 1)
                assert bool((diff <= bound).all()), (
                    f"step {i + 1} {k}: {float(diff.max()):.3e} beyond its bound")

    @pytest.mark.parametrize("key", ONE_RANK_CASES,
                             ids=[f"{d}x{s}-{n}" for d, s, n in ONE_RANK_CASES])
    def test_no_rank_holds_a_whole_activation(self, banded_ranks, key):
        """Every conv input on every rank was a band, and every exchange
        took at most the band and a halo (``band_hooks``)."""
        d, s_, name = key
        got = banded_ranks[f"{d}x{s_}"][name]
        assert got["conv_inputs_seen"] > 0 and got["band_faults"] == 0, got["faults"]
