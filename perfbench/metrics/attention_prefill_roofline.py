"""The prefill's flash attention (wgmma) against the roofline of
the causal pairs it attends, all layers, %."""
from perfbench.readers import roofline
from perfbench.work import counts

KERNELS = ("flash_wgmma_kernel",)


def read(ctx):
    return roofline(ctx, "prefill", KERNELS, lambda cfg, s: _work(cfg, s))


def _work(cfg, s):
    one = counts.attention_fwd(cfg, s["batch"], 0, s["seq"])
    L = counts.dims(cfg)["L"]
    return {"flops": L * one["flops"], "bytes": L * one["bytes"]}
