"""p95 over the window's decode steps (``step_times_s[1:]`` of each
invocation: a graph replay up to a synchronize), ms."""
from perfbench.readers import p95


def read(ctx):
    return p95([1e3 * x for _, _, t in ctx["runs"] for x in t[1:]])
