"""The plain reference against the port's plain path (on the CPU every
kernel wrapper runs its plain version) at a tiny size, on the same
weights and keys."""

import numpy as np
import pytest
import torch

from portbench import drive, weights
from portbench.reference import train as rt

SEED = 2**31 + 77


@pytest.fixture
def sides(tiny_cell):
    cell = tiny_cell("train")
    w = weights.make(drive.reference_shapes(cell.config), SEED, "cpu")
    return cell, w, rt.build(cell.config, w, "cpu")


def test_weights_cover_the_port_and_are_seeded(sides):
    cell, w, _ = sides
    from lvae_tpu_torch.train.trainer import make_model

    u8 = drive.images(cell.config, 2, SEED)
    model = make_model(drive.program_config(cell, SEED), drive.dataset(cell, u8, u8), "cpu")
    drive.load(model, w)                       # every name and shape, or KeyError
    again = weights.make(drive.reference_shapes(cell.config), SEED, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    other = weights.make(drive.reference_shapes(cell.config), SEED + 1, "cpu")
    assert not torch.equal(w["first_conv.weight"], other["first_conv.weight"])
    assert float(w["first_block.BatchNorm_0.running_var"].min()) > 0


def test_head_scales_draw_the_heads_at_a_multiple_of_lecun(tiny_cell):
    shapes = drive.reference_shapes(tiny_cell("iwll").config)
    init = weights.make(shapes, SEED, "cpu")
    scaled = weights.make(shapes, SEED, "cpu", head_scales={"likelihood": 1.0,
                                                            "gaussian": 0.5})
    head = "likelihood_head.param_conv.weight"
    q = "top_down_layers_0.stochastic.conv_in_q.weight"
    fan_in = {k: shapes[k][1] * shapes[k][2] * shapes[k][3] for k in (head, q)}
    # the program's initial heads: std 1e-2; scaled: a multiple of 1 / sqrt(fan_in)
    torch.testing.assert_close(scaled[head], init[head] / 0.01 / fan_in[head] ** 0.5)
    torch.testing.assert_close(scaled[q], init[q] * 0.5 / 0.01 / fan_in[q] ** 0.5)
    assert all(torch.equal(init[k], scaled[k]) for k in init if k not in (head, q)
               and "conv_in_" not in k)


def test_eval_forward_and_iwll_match_the_port(sides):
    cell, w, ref = sides
    from lvae_tpu_torch.data.device import eval_preprocess_batch
    from lvae_tpu_torch.eval.iwll import iwll_batch
    from lvae_tpu_torch.train.state import per_image_forward
    from lvae_tpu_torch.train.trainer import make_model

    u8 = torch.from_numpy(drive.images(cell.config, 4, SEED))
    model = make_model(drive.program_config(cell, SEED),
                       drive.dataset(cell, u8.numpy(), u8.numpy()), "cpu")
    drive.load(model, w)
    model.eval()
    index = torch.tensor([3, 9, 1, 30])
    x = eval_preprocess_batch(u8, "dequantize", index)
    sample = torch.full((4,), 5)
    with torch.no_grad():
        ll, kl = per_image_forward(model, x, index, SEED, sample)
        rll, rkl = ref.eval()(x, (SEED, index, sample))
    torch.testing.assert_close(ll, rll, rtol=1e-6, atol=0)
    torch.testing.assert_close(kl, rkl, rtol=1e-5, atol=1e-5)
    prog = iwll_batch(model, x, index, SEED, 6, "streaming", 2)
    torch.testing.assert_close(prog, rt.iwll(ref, u8, index, SEED, 6, 3), rtol=1e-6, atol=0)


def test_three_train_steps_match_the_port(tiny_cell):
    cell = tiny_cell("train")
    kind = drive.Train(cell, SEED, "cpu")
    kind.setup()
    kind.free()
    numbers = kind.numbers(kind.reference())
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_norm_gap"] < 1e-5
    assert numbers["change_norm_gap"] < 1e-3
    # the second call's steps, its loss, the EMA and the running statistics
    assert numbers["replay_loss_gap"] < 1e-6
    assert numbers["replay_change_gap"] < 1e-3
    assert numbers["bn_stats_gap"] < 1e-5
    assert numbers["ema_gap"] < 1e-5
    # the observed first gradient is Adamax's first moment over 1 - b1
    prog = kind.prog
    assert set(prog["grads"]) == {k for k, _ in kind.w0.items()
                                  if "running" not in k}
    assert len(prog["losses"]) == drive.OBSERVED_STEPS
    assert len(kind.observed_rows) == 2 * kind.k
    assert set(prog["end"]["bn"]) == {k for k in kind.w0 if "running" in k}


def test_train_numbers_by_hand():
    w0 = {"a": torch.zeros(4), "b": torch.zeros(2), "c": torch.zeros(3),
          "bn.running_mean": torch.zeros(2)}
    params = {"a": torch.full((4,), 0.5), "b": torch.full((2,), 1.0), "c": torch.ones(3)}
    ref = {"losses": [2.0, 1.0, 0.5, 0.25], "grads": {"a": torch.full((4,), 1.0),
                                                      "b": torch.full((2,), 2.0),
                                                      "c": torch.full((3,), 1e-9)},
           "params": params,
           "end": {"params": params, "bn": {"bn.running_mean": torch.full((2,), 1.0)},
                   "ema": {"loss": torch.tensor(4.0, dtype=torch.float64),
                           "kl_layers": torch.tensor([1.0, 2.0], dtype=torch.float64)}}}
    moved = {"a": torch.full((4,), 0.5), "b": torch.full((2,), 0.5), "c": torch.zeros(3)}
    prog = {"losses": [2.002, 1.0], "replay_loss": 0.2475,
            "grads": {"a": torch.full((4,), 1.1), "b": torch.full((2,), 2.0),
                      "c": torch.zeros(3)},
            "params": moved,
            "end": {"params": params, "bn": {"bn.running_mean": torch.full((2,), 0.9)},
                    "ema": {"loss": torch.tensor(4.0), "kl_layers": torch.tensor([1.2, 2.0])}}}
    n = drive.train_numbers(prog, ref, w0)
    assert n["loss_gap"] == pytest.approx(1e-3)
    assert n["replay_loss_gap"] == pytest.approx(1e-2)
    # |a|: 2 vs 2.2 over max(2, median(2, 2.83, 1.7e-9) = 2); c has no gradient
    assert n["grad_norm_gap"] == pytest.approx(0.1)
    # c moves by round-off alone and is left out; the leaves' gaps a: 0,
    # b: |0.707 - 1.414| / 1.414 = 0.5; their 90th percentile 0.45
    assert n["change_norm_gap"] == pytest.approx(0.45)
    assert n["replay_change_gap"] == 0.0
    assert n["bn_stats_gap"] == pytest.approx(0.1)
    # kl_layers[0]: 0.2 over max(1, the median entry 2)
    assert n["ema_gap"] == pytest.approx(0.1)


def test_reference_refuses_what_it_does_not_implement(tiny_cell):
    cell = tiny_cell("train")
    cell.config["model"]["gated"] = False
    with pytest.raises(ValueError):
        rt.build(cell.config, {}, "cpu")


def test_images_are_drawn_from_the_seed(tiny_cell):
    cfg = tiny_cell("train").config
    a, b = drive.images(cfg, 3, SEED), drive.images(cfg, 3, SEED)
    assert a.dtype == np.uint8 and a.shape == (3, 16, 16, 3) and np.array_equal(a, b)
    assert not np.array_equal(a, drive.images(cfg, 3, SEED + 1))
