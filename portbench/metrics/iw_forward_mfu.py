"""% of the card's fp32 peak (67 TFLOP/s) that an IW-LL window reaches:
the FLOPs of one reference evaluation forward an image (``FlopCounterMode``)
times the samples an image times the traced window's images/s."""

from portbench.roofline import PEAK_FLOPS


def read(ctx):
    n = ctx.traffic["n_samples"]
    return 100.0 * ctx.flops_per_image * n * ctx.rate / PEAK_FLOPS[ctx.config["train"]["precision"]]
