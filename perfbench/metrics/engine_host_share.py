"""Share of the invocations' wall time outside their steps, %."""
from perfbench.readers import host_share


def read(ctx):
    return host_share(ctx)
