"""% of the roofline of the mixture head (``kernels/mixture.py`` ->
``csrc/mixture.cu``): K3's bound at the forward's rows, with K3-bwd's in a
training step, over their mean device times a call."""

from portbench.roofline import mixture, share


def read(ctx):
    parts = [(("mix_fwd_kernel",), "mix_log_prob", mixture(ctx.rows, ctx.config))]
    if ctx.traffic["kind"] == "train":
        parts.append((("mix_bwd_one_pass_kernel", "mix_bwd_kernel"), "mix_log_prob_bwd",
                      mixture(ctx.rows, ctx.config, backward=True)))
    return share(ctx, "mixture_roofline", parts)
