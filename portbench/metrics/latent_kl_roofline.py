"""% of the roofline of the latent sample + KL (``kernels/stochastic.py``
-> ``csrc/stochastic_kl.cu``): in a training step K1 and K1-bwd's bounds,
in an evaluation forward K2's, each the mean over the latent layers'
shapes at the forward's rows, over their mean device times a call."""

from statistics import mean

from portbench.roofline import sample_kl, share


def read(ctx):
    if ctx.traffic["kind"] != "train":
        return share(ctx, "latent_kl_roofline", [
            (("sample_kl_kernel",), "sample_kl",
             mean(sample_kl(ctx.rows, ctx.config, train=False)))])
    return share(ctx, "latent_kl_roofline", [
        (("sample_kl_rows_kernel",), "sample_kl_per_sample",
         mean(sample_kl(ctx.rows, ctx.config, train=True))),
        (("sample_kl_bwd_kernel",), "sample_kl_per_sample_bwd",
         mean(sample_kl(ctx.rows, ctx.config, train=True, backward=True)))])
