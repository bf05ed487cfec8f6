"""A decode step's expert products (``moe_gmm`` streaming every
expert) against the roofline of the batch's tokens at their top-k
experts, every expert's weights read once, all layers, %."""
from perfbench.readers import roofline
from perfbench.work import counts

KERNELS = ("moe_gmm_stream_kernel",)


def read(ctx):
    return roofline(ctx, "decode", KERNELS, lambda cfg, s: _work(cfg, s))


def _work(cfg, s):
    one = counts.experts(cfg, s["batch"])
    L = counts.dims(cfg)["L"]
    return {"flops": L * one["flops"], "bytes": L * one["bytes"]}
