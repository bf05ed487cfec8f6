"""A decode step's attention (the split decode kernel) against the
roofline of reading each row's valid cache once, all layers, %."""
from perfbench.readers import roofline
from perfbench.work import counts

KERNELS = ("decode_split_kernel", "decode_attention_kernel")


def read(ctx):
    return roofline(ctx, "decode", KERNELS, lambda cfg, s: _work(cfg, s))


def _work(cfg, s):
    one = counts.attention_fwd(cfg, s["batch"], s["pos"], 1)
    L = counts.dims(cfg)["L"]
    return {"flops": L * one["flops"], "bytes": L * one["bytes"]}
