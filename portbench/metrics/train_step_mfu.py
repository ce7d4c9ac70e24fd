"""% of the card's fp32 peak (67 TFLOP/s) that a training window reaches:
the FLOPs of one reference train step an image (``FlopCounterMode``:
convolutions forward and backward) times the traced window's images/s."""

from portbench.roofline import PEAK_FLOPS


def read(ctx):
    return 100.0 * ctx.flops_per_image * ctx.rate / PEAK_FLOPS[ctx.config["train"]["precision"]]
