"""Device activities (kernels, copies, sets) a decode replay runs."""
from perfbench.readers import kernels_per_step


def read(ctx):
    return kernels_per_step(ctx, "decode")
