"""The port's data-parallel slice (``--num-data-shards``,
``lvae_tpu_torch/parallel/``) on the CPU, two gloo ranks held against
``lvae_tpu``'s 2-device ``data`` mesh (``make_dp_train_step`` on the
conftest's virtual CPU devices: the losses, the parameters and
statistics after each step, and the gradients Adamax is handed) and
against the port on one rank.

The ranks run in their own processes (``tests/torch_parallel_ranks.py``,
each launch with its own timeout of at most 120 s, so a hang fails rather
than eating the tier's time). Inputs, weights and the latent noise come
from numpy and go to both packages (``forced_eps``); dropout is 0 where
the two are compared, since the port keys its masks with its own
generator. Tolerances are ``tests/test_torch_train.py``'s step parity's, in
float64: losses 1e-7 relative, parameters and statistics 1e-6 absolute;
under ``--fused all`` the segments, and under ``--bn-stat-samples`` the
statistics, compute in fp32 on both sides, and the conv biases that only a
BatchNorm reads (true gradient 0, a roundoff one in fp32) are held to
Adamax's bound, 2 lr a step, as there."""

import dataclasses
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
from lvae_tpu.ops.math import crop_img_tensor, pad_img_tensor
from lvae_tpu.parallel import make_dp_train_step, make_mesh
from lvae_tpu.train.state import LossConfig as JLossConfig
from lvae_tpu.train.state import TrainState as JTrainState
from lvae_tpu.train.state import make_batch_train_step, make_optimizer as j_make_optimizer
from lvae_tpu_torch.config import TrainConfig
from lvae_tpu_torch.models.lvae import LadderVAE
from lvae_tpu_torch.ops.philox import ElementMap
from lvae_tpu_torch.parallel import Layout, mesh
from lvae_tpu_torch.train.convert import params_from_flax, torch_key_for
from lvae_tpu_torch.train.state import evaluate_elbo
from torch_parallel_ranks import bn_fed_keys, launch_cases

SPAWN_TIMEOUT_S = 120

CFG = dict(color_ch=1, z_dims=(3, 3), blocks_per_layer=1, n_filters=8, stochastic_skip=True,
           gated=True, downsample=(1, 1), learn_top_prior=True, img_size=(16, 16),
           data_size=(14, 14))
B = 8                 # the global batch: 4 rows a rank
STEPS = 3
LR = 3e-3
FREE_BITS, ANNEAL = 0.5, 4
# gradient parity, of each tensor's largest element: float64 (measured up to
# 4.5e-7, from the parameters' 1e-7 differences after a step) / the
# statistics in fp32 (measured up to 2.2e-6)
GRAD_TOL = {False: 1e-5, True: 1e-4}
EPS_SHAPES = [(B, 4, 4, 3), (B, 2, 2, 3)]
# case -> (the port's switches, lvae_tpu's, free bits (None: straddling))
CASES = {
    "fused_auto": (dict(), dict(), FREE_BITS),
    "fused_all": (dict(fused_stochastic=True, fused_segments=True),
                  dict(fused_segments=True), FREE_BITS),
    "bn_stat_samples_below_local": (dict(bn_stat_samples=2), dict(bn_stat_samples=2),
                                    FREE_BITS),
    "bn_stat_samples_above_local": (dict(bn_stat_samples=6), dict(bn_stat_samples=6),
                                    FREE_BITS),
    "free_bits_straddle": (dict(), dict(), None),
}


def _jax_forward(m, x, eps, train):
    """LadderVAE.__call__'s loss terms with the latent draw replaced by
    ``eps`` (as tests/test_torch_train.py)."""
    td, info = m.topdown_pass(m.bottomup_pass(pad_img_tensor(x, m.img_size), train=train),
                              train=train, forced_eps=eps)
    ll, _ = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
    return {"ll": ll.sum(axis=(1, 2, 3)),
            "kl_sep": jnp.stack([k.sum(axis=(1, 2, 3)) for k in info["kl_elementwise"]])}


@dataclasses.dataclass
class _ForcedEps:
    model: JaxLVAE
    eps: list

    def apply(self, variables, x, train=False, **kw):
        x = x.astype(jax.tree_util.tree_leaves(variables["params"])[0].dtype)
        return self.model.apply(variables, x, self.eps, train, method=_jax_forward, **kw)


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


@functools.lru_cache(maxsize=None)
def _setup():
    """float32 weights drawn with numpy at flax's shapes and scales (moved
    off them), the binary batches and the per-step eps."""
    rng = np.random.default_rng(21)
    jm = JaxLVAE(dropout_rate=0.0, **CFG)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(3), "sample": jax.random.key(4)},
        jnp.zeros((B, 14, 14, 1)), train=True))

    def draw(path, shape):
        if path[-1] == "kernel":
            heads = ("conv_in_p", "conv_in_q", "param_conv")
            std = 1e-2 if any(h in path for h in heads) else 1 / np.sqrt(np.prod(shape[:-1]))
            a = rng.normal(size=shape) * std
        else:
            a = np.ones(shape) if path[-1] == "scale" else np.zeros(shape)
        return (a + rng.normal(size=shape) * 0.1).astype(np.float32)

    params = unflatten_dict({k: draw(k, v.shape)
                             for k, v in flatten_dict(shapes["params"]).items()})
    stats = unflatten_dict({k: (np.zeros if k[-1] == "mean" else np.ones)(v.shape, np.float32)
                            for k, v in flatten_dict(shapes["batch_stats"]).items()})
    batches = [(rng.uniform(size=(B, 14, 14, 1)) < 0.4).astype(np.uint8) for _ in range(STEPS)]
    eps = [[rng.normal(size=s) for s in EPS_SHAPES] for _ in range(STEPS)]
    return params, stats, batches, eps


@functools.lru_cache(maxsize=None)
def _straddling_free_bits() -> tuple:
    """A free-bits value between rank 0's batch mean of a layer's KL and
    the global batch's at step 0, where they lie furthest apart: a clamp of
    each rank's mean would then differ from the clamp of the global one.
    Returns ``(free_bits, rank 0's mean, the global mean)``."""
    params, stats, batches, eps = _setup()
    tm = LadderVAE(dropout_rate=0.0, **CFG)
    tm.load_state_dict(params_from_flax(params, stats), strict=True)
    tm = tm.double()
    with torch.no_grad():
        out = tm(torch.from_numpy(batches[0]).double(),
                 forced_eps=[torch.from_numpy(a) for a in eps[0]], train=True)
    kl = out["kl_sep"].numpy()
    local, glob = kl[:, :B // 2].mean(axis=1), kl.mean(axis=1)
    layer = int(np.argmax(np.abs(local - glob)))
    return float((local[layer] + glob[layer]) / 2), float(local[layer]), float(glob[layer])


def _free_bits(case: str) -> float:
    fb = CASES[case][2]
    return _straddling_free_bits()[0] if fb is None else fb


def _keep_updates() -> optax.GradientTransformation:
    """Passes the updates on unchanged and keeps them as its state: put
    first in the chain, the gradient the optimiser is handed."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@functools.lru_cache(maxsize=None)
def _jax_trajectory(case: str):
    """Per step (loss, params, batch_stats, gradients) of lvae_tpu's
    ``make_dp_train_step`` on a 2-device ``data`` mesh, float64; the
    gradients are those of the global loss that Adamax is handed."""
    params, stats, batches, eps = _setup()
    jm = JaxLVAE(dropout_rate=0.0, **CFG, **CASES[case][1])
    jcfg = JLossConfig(free_bits=_free_bits(case), beta_anneal_steps=ANNEAL,
                       preprocess="none")
    tx = optax.chain(_keep_updates(), j_make_optimizer(LR))

    def body(state, data, idx):
        forced = _ForcedEps(jm, [e[idx] for e in data["eps"]])
        return make_batch_train_step(forced, tx, jcfg)(state, data["x"][idx])

    out = []
    with jax.enable_x64():
        step = make_dp_train_step(body, make_mesh(2))
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


def _train_case(case: str) -> dict:
    params, stats, batches, eps = _setup()
    return {"kind": "train", "model": dict(dropout_rate=0.0, **CFG, **CASES[case][0]),
            "state_dict": params_from_flax(params, stats), "lr": LR,
            "loss": dict(free_bits=_free_bits(case), beta_anneal_steps=ANNEAL,
                         preprocess="none"),
            "batches": [torch.from_numpy(b) for b in batches],
            "eps": [[torch.from_numpy(a) for a in e] for e in eps]}



@pytest.fixture(scope="module", autouse=True)
def _one_thread_ranks():
    """The ranks this file starts run on one thread each: the tier runs
    several test processes on the same cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def two_ranks():
    """Every train case on two gloo ranks in one launch (run beside the
    JAX side's compiles), and the sharded evaluation case."""
    rng = np.random.default_rng(5)
    test = torch.from_numpy((rng.uniform(size=(37, 14, 14, 1)) < 0.4).astype(np.uint8))
    cases = {name: _train_case(name) for name in CASES}
    cases["eval"] = {"kind": "eval", "model": dict(dropout_rate=0.0, **CFG), "test": test,
                     "batch_size": 9, "data_dims": 14 * 14}
    box = {}
    thread = threading.Thread(
        target=lambda: box.update(out=launch_cases(cases, 2, SPAWN_TIMEOUT_S)))
    thread.start()
    for name in CASES:
        _jax_trajectory(name)
    thread.join()
    assert "out" in box, "the two ranks failed (their output is above)"
    return box["out"]


class TestTrainStepMatchesLvaeTpuMesh:
    """Two ranks' steps against ``lvae_tpu``'s 2-device data mesh."""

    @pytest.mark.parametrize("case", list(CASES))
    def test_steps(self, two_ranks, case):
        out_j, out_t = _jax_trajectory(case), two_ranks[case]["steps"]
        np.testing.assert_allclose([s["loss"] for s in out_t], [j[0] for j in out_j],
                                   rtol=1e-7, atol=0)
        # the segments and the subsampled statistics compute in fp32
        fp32_stats = case == "fused_all" or "bn_stat_samples" in case
        roundoff_led = bn_fed_keys(LadderVAE(**CFG)) if fp32_stats else set()
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

    @pytest.mark.parametrize("case", list(CASES))
    def test_gradients(self, two_ranks, case):
        """Rank 0's gradients at each step, after the sum over the ranks,
        against the global loss's gradients that ``lvae_tpu``'s mesh step
        hands Adamax. Adamax moves a parameter by the same amount whatever
        one factor scales every gradient (to its eps), so the steps above
        cannot tell a mean over the ranks, or a loss not divided by the
        rank count, from the sum; this is off by the rank count then. Each
        tensor within GRAD_TOL of its largest element; the conv biases that
        only a BatchNorm reads (true gradient 0, a roundoff one on both
        sides), and a tensor whose gradient is 0 (the priors' at step 1,
        where beta is 0), within GRAD_TOL of the largest gradient of the
        model."""
        out_j, out_t = _jax_trajectory(case), two_ranks[case]["steps"]
        fp32_stats = case == "fused_all" or "bn_stat_samples" in case
        roundoff_led = bn_fed_keys(LadderVAE(**CFG))
        tol = GRAD_TOL[fp32_stats]
        for i in range(STEPS):
            got, grads_j = out_t[i]["grads"], out_j[i][3]
            assert len(got) == len(grads_j)
            top = max(float(np.abs(a).max()) for a in grads_j.values())
            for path, a in grads_j.items():
                key = torch_key_for(path)
                want = params_from_flax({path[0]: _nest(path[1:], a)})[key].numpy()
                scale = (key not in roundoff_led and float(np.abs(want).max())) or top
                np.testing.assert_allclose(got[key].numpy(), want, rtol=0, atol=tol * scale,
                                           err_msg=f"step {i + 1} {path}")

    def test_free_bits_case_straddles(self):
        """The free-bits case's value lies between rank 0's mean of a
        layer's KL and the global mean, so a per-rank clamp would take a
        different gradient from the global one (and the case above would
        fail)."""
        fb, local, glob = _straddling_free_bits()
        assert (local - fb) * (glob - fb) < 0, (fb, local, glob)

    def test_metrics_are_global(self, two_ranks):
        """Rank 0's metrics are the global batch's: its ELBO equals the
        global mean of the JAX side's step, through the loss parity above,
        and its per-layer KL averages the two ranks' rows."""
        m = two_ranks["fused_auto"]["steps"][0]["metrics"]
        assert m["kl_layers"].shape == (2,)
        np.testing.assert_allclose(float(m["elbo"]), float(m["ll"] - m["kl"]), rtol=1e-12)


def _nest(path, leaf):
    return leaf if not path else {path[0]: _nest(path[1:], leaf)}


class TestShardedEvaluation:
    def test_elbo_and_iwll_match_one_rank(self, two_ranks):
        """Test ELBO and IW-LL over 37 images at a global batch of 9 (10
        over two ranks: the last batch padded with its final index and
        masked) equal one rank's up to the order of the sums."""
        from lvae_tpu_torch.eval.iwll import evaluate_iwll

        rng = np.random.default_rng(5)
        test = torch.from_numpy((rng.uniform(size=(37, 14, 14, 1)) < 0.4).astype(np.uint8))
        model = LadderVAE(generator=torch.Generator().manual_seed(3), dropout_rate=0.0,
                          **CFG).eval()
        one = evaluate_elbo(model, test, "none", 9, 14 * 14)
        iw = evaluate_iwll(model, test, "none", 14 * 14, n_samples=4, batch_size=9,
                           logsumexp_impl="streaming", chunk=2)
        got = two_ranks["eval"]
        assert got["elbo"]["n_images"] == got["iw"]["n_images"] == 37
        for k in ("elbo", "ll", "kl", "bpd"):
            np.testing.assert_allclose(got["elbo"][k], one[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["elbo"]["kl_layers"], one["kl_layers"], rtol=1e-6)
        np.testing.assert_allclose(got["iw"]["iw_ll"], iw["iw_ll"], rtol=1e-6)

    def test_eval_stream_pads_and_masks(self):
        """``eval_batch_stream``: each rank's contiguous rows of the batch
        rounded up to the rank count, the short last one padded with its
        final index, the padding masked; one rank pads nothing."""
        test = torch.arange(7).view(7, 1, 1, 1).to(torch.uint8)
        seen = []
        for r in range(2):
            for index, batch, valid in mesh.eval_batch_stream(test, 3, Layout(rank=r, size=2)):
                assert torch.equal(batch.view(-1).long(), index)
                seen.append((r, index.tolist(), valid.tolist()))
        assert seen == [(0, [0, 1], [True, True]), (0, [4, 5], [True, True]),
                        (1, [2, 3], [True, True]), (1, [6, 6], [True, False])]
        one = [index.tolist() for index, _, _ in mesh.eval_batch_stream(test, 3, Layout())]
        assert one == [[0, 1, 2], [3, 4, 5], [6]]


class TestLayout:
    def test_rows_and_offsets(self):
        lay = Layout(rank=1, size=2)
        assert lay.rows(8) == slice(4, 8)
        x = torch.zeros(4, 3, 2, 2)
        assert mesh.element_map(x, lay) == ElementMap(base=48)
        assert mesh.element_map(x, Layout()) == ElementMap()
        stack = torch.arange(12).view(2, 6)
        assert mesh.make_global_batch_indices(stack, Layout(rank=2, size=3)).tolist() == [
            [4, 5], [10, 11]]
        with pytest.raises(ValueError, match="--num-data-shards"):
            lay.rows(7)

    def test_dropout_bytes_at_an_offset(self):
        """A rank's dropout bytes are the global tensor's rows: the bytes
        of elements ``offset ..`` (a run's ``ElementMap``) equal the global
        bytes there, at an offset that is not a multiple of 16 too."""
        from lvae_tpu_torch.ops.philox import dropout_bytes

        whole = dropout_bytes((6, 5, 3, 3), 1234)
        for rank in range(3):
            part = dropout_bytes((2, 5, 3, 3), 1234, emap=ElementMap(base=rank * 90))
            assert torch.equal(part, whole[2 * rank:2 * rank + 2])


class TestConfigRefusals:
    def test_batch_not_divisible(self):
        with pytest.raises(ValueError, match="--num-data-shards"):
            TrainConfig(batch_size=7, num_data_shards=2)

    def test_spatial_shards_refused(self):
        """--spatial-shards runs (tests/test_torch_spatial.py); a value below
        1, and one that does not divide the data height (28 rows over 5),
        are refused with the flag named."""
        from lvae_tpu_torch.train.trainer import Experiment

        with pytest.raises(ValueError, match="--spatial-shards must be >= 1"):
            TrainConfig(spatial_shards=0)
        with pytest.raises(ValueError, match="height 28 not divisible by --spatial-shards 5"):
            Experiment(TrainConfig(dataset="synthetic", spatial_shards=5), "cpu")

    def test_launched_world_must_match(self, monkeypatch, tmp_path):
        """Under a launcher whose group has another size than
        --num-data-shards, the rank stops before it joins (a wrong count
        would wait for ranks that never come)."""
        from lvae_tpu_torch.main import main

        monkeypatch.setenv("WORLD_SIZE", "3")
        with pytest.raises(SystemExit, match="--num-data-shards 2"):
            main(["--dataset", "synthetic", "--num-data-shards", "2", "--batch-size", "8",
                  "--device", "cpu", "--output-dir", str(tmp_path), "--dry-run"])


class TestGraftEntry:
    def test_entry_matches_lvae_tpu(self):
        """``graft_entry_torch.entry()``'s forward against
        ``__graft_entry__.entry()``'s on the JAX entry's own weights
        (converted) and the same latent noise, on the flagship at full
        width (float32, 2e-4 relative: ~50 convolutions summed in
        different orders)."""
        import __graft_entry__ as jg
        import graft_entry_torch as tg

        fn_j, (variables, x_j, _) = jg.entry()
        fn_t, (model, x_t, seed) = tg.entry("cpu")
        assert x_t.shape == x_j.shape
        out_t = fn_t(model, x_t, seed)
        assert out_t.shape == (8,) and torch.isfinite(out_t).all()
        jm = jg._flagship()
        rng = np.random.default_rng(4)
        eps = [rng.normal(size=(8, h, h, 32)).astype(np.float32) for h in (8, 4, 2)]
        x = (rng.uniform(size=(8, 28, 28, 1)) < 0.3).astype(np.float32)

        def fwd(m, x, eps):
            td, info = m.topdown_pass(
                m.bottomup_pass(pad_img_tensor(x, m.img_size), train=False), train=False,
                forced_eps=eps)
            ll, _ = m.likelihood_head(crop_img_tensor(td, m.data_size), x)
            return ll.sum(axis=(1, 2, 3)) - sum(k.sum(axis=(1, 2, 3))
                                                for k in info["kl_elementwise"])

        want = np.asarray(jm.apply(variables, jnp.asarray(x), [jnp.asarray(e) for e in eps],
                                   method=fwd))
        model.load_state_dict(params_from_flax(variables["params"],
                                               variables["batch_stats"]), strict=True)
        got = fn_t(model, torch.from_numpy(x), seed,
                   forced_eps=[torch.from_numpy(e) for e in eps]).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4)

    def test_dryrun_multichip_two_ranks(self):
        """``dryrun_multichip(2)`` on the CPU: two gloo ranks on a space
        axis of 2 (1 x 2, as ``__graft_entry__`` lays out an even count),
        3 steps with dropout and the split segments (``--fused all``), the
        sharded evaluate, the checkpoint round trip, the sharded mixture
        log-prob, and rank 0's losses and parameters against one rank's."""
        import graft_entry_torch as tg

        r = tg.dryrun_multichip(2, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        assert r["size"] == 2 and r["backend"] == "gloo" and r["spatial"] == 2
        assert r["eval_images"] == 4 and np.isfinite(r["elbo_after_restore"])
        assert r["param_max_diff"] < 1e-4
        assert r["mix_max_abs_err"] < 1e-3

    def test_dryrun_multichip_three_ranks(self):
        """``dryrun_multichip(3)``: an odd count runs on the data axis
        alone (3 x 1), three gloo ranks each on two rows of the batch of
        6, against one rank as above."""
        import graft_entry_torch as tg

        r = tg.dryrun_multichip(3, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        assert r["size"] == 3 and r["backend"] == "gloo" and r["spatial"] == 1
        assert r["eval_images"] == 6 and np.isfinite(r["elbo_after_restore"])
        assert r["param_max_diff"] < 1e-4
        assert r["mix_max_abs_err"] < 1e-3
