"""p95 over the window's invocations of the prefill's time
(``step_times_s[0]`` of each: a graph replay up to a synchronize), ms."""
from perfbench.readers import p95


def read(ctx):
    return p95([1e3 * t[0] for _, _, t in ctx["runs"] if t])
