"""A training step's AdamW kernels against the roofline of one pass
over every parameter, gradient and moment (22 bytes a parameter), %."""
from perfbench.readers import roofline
from perfbench.work import counts

KERNELS = ("sumsq_kernel", "norm_kernel", "update_kernel")


def read(ctx):
    return roofline(ctx, "train", KERNELS, lambda cfg, s: counts.adamw(cfg))
