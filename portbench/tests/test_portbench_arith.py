"""The roofline, FLOP and trace arithmetic against hand-worked values."""

import json
import types

import pytest
import torch

from portbench import roofline, trace
from portbench.reference import train as rt
from portbench.tests.conftest import ROOT


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_peaks_and_bound():
    assert roofline.PEAK_FLOPS["fp32"] == 67e12 and roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.bound_s(3.35e9) == pytest.approx(1e-3)                # bytes bound it
    assert roofline.bound_s(3.35e9, 134e9) == pytest.approx(2e-3)         # operations do


def test_latent_shapes():
    assert roofline.latent_shapes(config("celeba64")) == [(32, 16, 16), (32, 8, 8),
                                                           (32, 4, 4), (32, 2, 2)]
    shapes = roofline.latent_shapes(config("cifar10_deep"))
    assert [h for _, h, _ in shapes] == [16, 16, 8, 8, 8, 4, 4, 4, 2, 2]


def test_kernel_bounds_by_hand():
    cfg = config("celeba64")
    # K3 at [128, 100, 64, 64]: 4 (100 + 3 + 1) bytes a pixel, 10 x 3 x 40 ops
    npix = 128 * 64 * 64
    assert roofline.mixture(128, cfg) == pytest.approx(
        max(npix * 416 / 3.35e12, npix * 1200 / 67e12))
    assert roofline.mixture(128, cfg, backward=True) == pytest.approx(
        max(npix * 816 / 3.35e12, npix * 2400 / 67e12))
    # K1 at the bottom layer [128, 32, 16, 16]: q 8 + z 4 a element, p 8 a
    # element of each row, index 8 + KL 4 a row; 110 ops an element
    n = 128 * 32 * 16 * 16
    k1 = roofline.sample_kl(128, cfg, train=True)
    assert k1[0] == pytest.approx(max((n * 20 + 128 * 12) / 3.35e12, n * 110 / 67e12))
    # the top layer's prior is one row
    top = 32 * 2 * 2
    assert k1[3] == pytest.approx(max((128 * top * 12 + top * 8 + 128 * 12) / 3.35e12,
                                      128 * top * 110 / 67e12))
    bwd = roofline.sample_kl(128, cfg, train=True, backward=True)
    assert bwd[0] == pytest.approx(max((n * 36 + 128 * 12) / 3.35e12, n * 140 / 67e12))
    k2 = roofline.sample_kl(250, cfg, train=False)
    n2 = 250 * 32 * 16 * 16
    assert k2[0] == pytest.approx(max((n2 * 24 + 250 * 16) / 3.35e12, n2 * 110 / 67e12))


def _ctx(spans, launches):
    return types.SimpleNamespace(spans=spans, launches=launches)


def test_share_takes_the_mean_of_the_events_present():
    spans = [("void mix_fwd_kernel<3, float, 4>(Args)", 0, 1000),
             ("void mix_fwd_kernel<3, float, 4>(Args)", 2000, 3000),
             ("void other_kernel()", 0, 9000)]
    # three launches, one event dropped: 1 us a call, the bound 0.5 us
    assert roofline.share(_ctx(spans, {"mix_log_prob": 3}), "t",
                          [(("mix_fwd_kernel",), "mix_log_prob", 0.5e-6)]) == pytest.approx(50)
    # two kernels a call: their time over the calls
    assert roofline.share(_ctx(spans, {"mix_log_prob": 1}), "t",
                          [(("mix_fwd_kernel",), "mix_log_prob", 1e-6)]) == pytest.approx(50)
    assert roofline.share(_ctx(spans, {}), "t",
                          [(("mix_fwd_kernel",), "mix_log_prob", 1e-6)]) is None
    assert roofline.share(_ctx(spans, {"sample_kl": 4}), "t",
                          [(("sample_kl_kernel",), "sample_kl", 1e-6)]) is None


def test_kernel_names_match_whole_words():
    spans = [("void (anonymous namespace)::sample_kl_rows_kernel<4>(K1Args)", 0, 5),
             ("void sample_kl_kernel(float const*)", 0, 7),
             ("void sample_kl_bwd_kernel<true, 1>(BwdArgs)", 0, 11)]
    assert trace.kernel(spans, ["sample_kl_kernel"]) == (1, 7)
    assert trace.kernel(spans, ["sample_kl_rows_kernel"]) == (1, 5)
    assert trace.kernel(spans, ["sample_kl_bwd_kernel"]) == (1, 11)


def test_union_and_breakdown():
    spans = [("void a()", 0, 10), ("void b()", 5, 20), ("void a()", 30, 40),
             ("void c()", 45, 50)]
    assert trace.union_ns(spans) == 20 + 10 + 5
    b = trace.breakdown(spans)
    assert b["device_ops"][0] == ["a", 20e-9]
    assert b["idle_gaps"] == [["before a", 10e-9], ["before c", 5e-9]]


def test_flop_count_of_the_reference_is_its_convolutions(tiny_cell):
    """``FlopCounterMode`` over an evaluation forward counts 2 Cin Cout k^2
    a output pixel of every convolution (hooked here for their shapes),
    the transposed ones' by their input pixels."""
    cell = tiny_cell("iwll")
    from portbench import drive, weights

    w = weights.make(drive.reference_shapes(cell.config), 5, "cpu")
    model = rt.build(cell.config, w, "cpu")
    want = []

    def hook(m, args, out):
        k2 = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, torch.nn.ConvTranspose2d):
            want.append(2 * m.in_channels * m.out_channels * k2 * args[0][0, 0].numel())
        else:
            want.append(2 * m.in_channels * m.out_channels * k2 * out[0, 0].numel())

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    u8 = torch.from_numpy(drive.images(cell.config, 2, 5))
    got = rt.flops(model, u8, train=False)
    assert got == pytest.approx(sum(want))
    assert rt.flops(model, u8, train=True) > 2 * got     # the backward's two products
