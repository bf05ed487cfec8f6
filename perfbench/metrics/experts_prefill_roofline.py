"""The prefill's expert products (``moe_gmm`` on wgmma) against the
roofline of every token at its top-k experts, all layers, %."""
from perfbench.readers import roofline
from perfbench.work import counts

KERNELS = ("moe_gmm_wgmma_kernel",)


def read(ctx):
    return roofline(ctx, "prefill", KERNELS, lambda cfg, s: _work(cfg, s))


def _work(cfg, s):
    one = counts.experts(cfg, s["batch"] * s["seq"])
    L = counts.dims(cfg)["L"]
    return {"flops": L * one["flops"], "bytes": L * one["bytes"]}
