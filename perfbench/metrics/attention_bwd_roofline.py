"""A training step's flash backward (the wgmma dq and dkv kernels)
against the roofline of its five products over the causal pairs, all
layers, %."""
from perfbench.readers import roofline
from perfbench.work import counts

KERNELS = ("wgb::dq_kernel", "wgb::dkv_kernel", "wgb::dq_live_kernel")


def read(ctx):
    return roofline(ctx, "train", KERNELS, lambda cfg, s: _work(cfg, s))


def _work(cfg, s):
    one = counts.attention_bwd(cfg, s["batch"], s["seq"])
    L = counts.dims(cfg)["L"]
    return {"flops": L * one["flops"], "bytes": L * one["bytes"]}
